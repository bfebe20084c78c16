"""Rates and tails are taken over the whole window: a stall anywhere in
it moves them, and a request that never answers misses."""

from __future__ import annotations

import numpy as np

from harness.stats import (RequestRecord, Window, longest_silence, quantile,
                           serving_summary, timeline)


def _steady(stall_at=None, stall_s=0.0, n=200):
    """Requests sent every 0.1 s, first token after 0.2 s, then 40 tokens
    0.05 s apart; a stall delays everything from `stall_at` by stall_s."""
    recs = []
    for i in range(n):
        sent = 0.1 * i
        times = [sent + 0.2 + 0.05 * k for k in range(40)]
        if stall_at is not None:
            times = [t + stall_s if t >= stall_at else t for t in times]
        r = RequestRecord(i, 100, 40, False, sent)
        r.chunks = [(t, 1) for t in times]
        r.tokens = list(range(40))
        r.finish_reason = "length"
        recs.append(r)
    return recs


def test_quantile_matches_numpy_linear():
    xs = list(np.random.default_rng(0).random(101))
    for q in (0.1, 0.5, 0.9):
        assert abs(quantile(xs, q) - np.quantile(xs, q)) < 1e-12


def test_a_stall_inside_the_window_moves_rate_and_tails():
    win = Window(5.0, 15.0)
    base = serving_summary(_steady(), win)
    stalled = serving_summary(_steady(stall_at=9.0, stall_s=2.0), win)
    assert stalled["output_tokens_per_s"] < 0.85 * base["output_tokens_per_s"]
    assert stalled["ttft_p90_ms"] > base["ttft_p90_ms"] + 1000
    assert stalled["tpot_p90_ms"] > base["tpot_p90_ms"]


def test_a_request_that_never_answers_misses():
    win = Window(5.0, 15.0)
    recs = _steady()
    for r in recs[60:80]:
        r.chunks, r.tokens, r.finish_reason = [], [], None
        r.given_up = r.sent + 60.0
    s = serving_summary(recs, win)
    assert s["failed"] == 20
    assert s["ttft_p90_ms"] >= 60_000 - 1e-6


def test_a_stall_shows_in_the_timeline_and_the_longest_silence():
    win = Window(5.0, 15.0)
    base = _steady()
    stalled = _steady(stall_at=9.0, stall_s=2.0)
    assert len(timeline(base, win)) == 10
    assert sum(timeline(base, win)) == serving_summary(base, win)["tokens"]
    assert min(timeline(stalled, win)) == 0
    assert longest_silence(base, win) < 0.5
    assert longest_silence(stalled, win) >= 1.9
