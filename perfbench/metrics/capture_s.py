"""``capture_s`` (s, superbatch graphs): the program's own counter
``SuperbatchGraphs.stats["capture_s"]``, the seconds its captures took,
each capture's warm-up superbatch included.  Moves ``setup_s``."""


def read(r):
    st = r.extra.get("graph_stats") or {}
    if not st.get("captures"):
        return None
    return float(st["capture_s"])
