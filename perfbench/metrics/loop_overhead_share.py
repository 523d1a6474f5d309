"""``loop_overhead_share`` (%, training loop): the share of the card's
time in the window's last epoch spent outside graph replays, 1 -
``replay_s`` / (``span_s`` + ``lead_s``) of that epoch's row of the
program's counters (``SuperbatchGraphs.stats["epochs"]``; the row
``replay_ms_per_batch`` reads, chosen as it says): the input copies,
the gaps between replays, the epoch's draws and state copies, and the
epoch boundary before it (the loss fetch).  Moves
``train_cells_per_s``."""


def read(r):
    rows = (r.extra.get("graph_stats") or {}).get("epochs") or []
    if len(rows) < 2:
        return None
    row = rows[-2]
    if (not row.get("replay_s") or not row.get("span_s")
            or row.get("lead_s") is None):
        return None
    return 100.0 * (1.0 - row["replay_s"] / (row["span_s"] + row["lead_s"]))
