"""``device_idle_share`` (%, device layer): the share of the traced
sub-window in which no kernel or copy ran on the card, 1 - (the union of
the device's kernel and copy intervals) / (the sub-window's length),
both from the one trace.  The host enqueues the sub-window's replays
while a spin kernel holds the card (``trace.py``), so its gaps are the
card's own, between graph nodes and replays, as in the untraced window.
Moves ``train_cells_per_s``: a gap is time the card does no work."""


def read(r):
    if r.window_s <= 0 or r.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
