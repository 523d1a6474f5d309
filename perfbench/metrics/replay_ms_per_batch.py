"""``replay_ms_per_batch`` (ms, superbatch graphs): device milliseconds
a batch step as a graph replay, untraced and unprofiled: the program's
own counters, the replays' CUDA-event times summed over an epoch
(``SuperbatchGraphs.stats["epochs"]``), over that epoch's batches.  The
row read is the last but one: the window's last epoch, since the last
row is the traced epoch that follows the window.  That holds because
``drivers/train.py`` reads the metrics from a shallow copy of
``runner.graph_stats`` taken before ``runner.close()``, which appends
the traced epoch's row to the list the copy shares; a driver that read
the rows otherwise would have to choose the row here anew.  Moves
``train_cells_per_s``."""


def read(r):
    rows = (r.extra.get("graph_stats") or {}).get("epochs") or []
    if len(rows) < 2:
        return None
    row = rows[-2]
    if not row.get("replay_s") or not row.get("batches"):
        return None
    return 1e3 * row["replay_s"] / row["batches"]
