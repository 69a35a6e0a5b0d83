"""The end-to-end arithmetic on synthetic turns."""
from __future__ import annotations

import math

import numpy as np

from livebench import stats
from livebench.traffic import TurnLog


def turn(due, first=None, gaps=(), n=20, done=None, barge=None, more=0):
    """A turn whose ``n`` chunks came 80 ms apart from ``first``, each
    late by ``gaps[i]``; ``more`` chunks still to come."""
    t = TurnLog(0, "s", 0, due, np.zeros(3, np.int32), n + 1 + more, 0.08)
    if first is not None:
        t.first = first
        at = first
        t.recv = [at]
        for i in range(1, n):
            at += 0.08 + (gaps[i] if i < len(gaps) else 0.0)
            t.recv.append(at)
    t.done, t.barge_at = done, barge
    return t


def test_failed_turns_rank_above_every_percentile():
    turns = [turn(1.0, 1.5), turn(2.0, 2.2), turn(3.0)]
    e = stats.end_to_end(turns, 0.0, 10.0, end=12.0)
    assert e["attempted"] == 3 and e["failed"] == 1
    # counted as its wait to the end of the drain: finite, and the top
    assert math.isclose(e["ttfp_p90_ms"], 9000.0)
    assert math.isclose(e["ttfp_p50_ms"], 500.0)
    # never below a first audio that did come
    late = [turn(1.0, 9.0), turn(9.5)]
    assert math.isclose(stats.end_to_end(late, 0.0, 10.0, end=10.5)
                        ["ttfp_p90_ms"], 8000.0)


def test_rates_run_over_the_whole_window():
    turns = [turn(float(i), i + 0.3) for i in range(4)] + [turn(20.0, 20.1)]
    e = stats.end_to_end(turns, 0.0, 8.0)
    assert e["attempted"] == 4
    assert math.isclose(e["good_turns_per_s"], 4 / 8.0)


def test_percentile_is_nearest_rank_not_a_median_of_chunks():
    vals = [0.1, 0.2, 0.3, 0.4, 10.0]
    assert stats.percentile(vals, 50) == 0.3
    assert stats.percentile(vals, 90) == 10.0
    # one turn's many chunks do not count as many samples
    turns = [turn(0.0, 0.1, n=200), turn(1.0, 4.0, n=2)]
    assert math.isclose(stats.end_to_end(turns, 0, 5)["ttfp_p90_ms"],
                        3000.0)


def test_gaps_and_limits():
    smooth = turn(0.0, 0.5)
    stall = turn(0.0, 0.5, gaps=[0, 0, 0, 0.15])
    assert stats.max_gap_s(smooth, 100.0) < 1e-9
    assert math.isclose(stats.max_gap_s(stall, 100.0), 0.15, rel_tol=1e-6)
    assert stats.good(smooth, 100.0) and not stats.good(stall, 100.0)
    late = turn(0.0, 2.5)
    assert not stats.good(late, 100.0)
    # a buffer still dry at the window's end on a turn with more to say
    dry = turn(0.0, 0.5, n=3, more=5)
    assert math.isclose(stats.max_gap_s(dry, 1.0), 1.0 - (0.5 + 0.24))
    # a stall after the barge-in does not count
    cut = turn(0.0, 0.5, gaps=[0, 0, 0, 0.5], barge=0.7)
    assert stats.max_gap_s(cut, 100.0) == 0.0


def test_heard_tokens_stop_at_the_barge_in():
    t = turn(0.0, 1.0, n=10, barge=1.0 + 3 * 0.08 + 0.01)
    assert stats.heard_tokens(t) == 4
    assert stats.heard_tokens(turn(0.0, 1.0, n=10)) == 10
