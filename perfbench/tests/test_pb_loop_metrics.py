"""The two readers of the program's epoch rows
(``SuperbatchGraphs.stats["epochs"]``), ``replay_ms_per_batch`` and
``loop_overhead_share``, on hand-made rows: the values, the window's
last epoch read (the row before the traced epoch's), and nothing read
where the rows or their fields are missing, as on a program that keeps
no rows."""

import pytest

from perfbench import spec
from perfbench.trace import Reading

READERS = ("replay_ms_per_batch", "loop_overhead_share")


def _reading(stats):
    r = Reading(window_s=0.1, batches=64, replays=8)
    if stats is not None:
        r.extra["graph_stats"] = stats
    return r


def _row(epoch, replay_s, span_s, lead_s, batches=1000):
    return {"epoch": epoch, "replays": -(-batches // 8), "batches": batches,
            "replay_s": replay_s, "span_s": span_s, "lead_s": lead_s}


ROWS = [_row(0, 1.9, 2.3, None), _row(1, 1.6, 1.61, 0.0025),
        _row(2, 1.5875, 1.5905, 0.0065),  # the window's last epoch
        _row(3, 1.7, 2.5, 0.002)]          # the traced epoch


def _read(name, stats):
    return spec.Cell.metric_reader(name).read(_reading(stats))


def test_replay_ms_per_batch_reads_the_window_last_epoch():
    assert _read("replay_ms_per_batch", {"epochs": ROWS}) == pytest.approx(
        1.5875)


def test_loop_overhead_share_reads_the_window_last_epoch():
    assert _read("loop_overhead_share", {"epochs": ROWS}) == pytest.approx(
        100 * (1 - 1.5875 / (1.5905 + 0.0065)))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("stats", [
    None, {}, {"captures": 1, "capture_s": 1.5}, {"epochs": []},
    {"epochs": ROWS[-1:]},
    {"epochs": [{"epoch": 2}, ROWS[-1]]},
    {"epochs": [_row(0, 0.0, 0.0, None), ROWS[-1]]}],
    ids=["no_stats", "empty", "parent_keys", "no_rows", "one_row",
         "no_fields", "zero_row"])
def test_nothing_to_read(name, stats):
    assert _read(name, stats) is None


def test_share_needs_the_epoch_boundary():
    """The first epoch has no boundary before it: no share, but its
    replay time is read."""
    stats = {"epochs": [_row(0, 1.6, 1.7, None), ROWS[-1]]}
    assert _read("loop_overhead_share", stats) is None
    assert _read("replay_ms_per_batch", stats) == pytest.approx(1.6)
