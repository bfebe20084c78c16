"""The traffic repeats from the seed, and every seed asks for the same
work in another order."""

from __future__ import annotations

import json
import os

import numpy as np

from kinds import closed_loop, train_batches

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "traffic", "chat_azure_conv.json")) as f:
    MIX = json.load(f)
P_LO, P_HI = MIX["prompt_tokens"]["low"], MIX["prompt_tokens"]["high"]
O_LO, O_HI = MIX["output_tokens"]["low"], MIX["output_tokens"]["high"]


def test_requests_repeat_from_the_seed():
    a = closed_loop.Schedule(MIX, 32064, 2**31 + 77)
    b = closed_loop.Schedule(MIX, 32064, 2**31 + 77)
    c = closed_loop.Schedule(MIX, 32064, 2**31 + 78)
    for i in (0, 5, 40, 333):
        assert a(i) == b(i)
        assert a(i).prompt != c(i).prompt
    assert all(P_LO <= len(a(i).prompt) <= P_HI for i in range(200))
    assert all(O_LO <= a(i).max_tokens <= O_HI for i in range(32, 200))


def test_lengths_keep_the_mix_medians():
    """The log-uniform ranges' medians are the conversation trace's (1020
    prompt tokens, 129 output tokens), and the draw keeps them."""
    s = closed_loop.Schedule(MIX, 32064, 2**31 + 3)
    reqs = [s(i) for i in range(32, 32 + 512)]
    assert abs(np.median([len(r.prompt) for r in reqs]) - 1020) < 20
    assert abs(np.median([r.max_tokens for r in reqs]) - 129) < 3


def test_every_seed_asks_for_the_same_work():
    """Over any 128 requests past the ramp, two seeds' prompt and output
    lengths agree in sum within 2% (the stratified draw), and a quarter of
    them is greedy."""
    def lengths(seed):
        s = closed_loop.Schedule(MIX, 32064, seed)
        reqs = [s(i) for i in range(32, 160)]
        return (sum(len(r.prompt) for r in reqs),
                sum(r.max_tokens for r in reqs),
                sum(r.greedy for r in reqs))

    p1, o1, g1 = lengths(11)
    p2, o2, g2 = lengths(2**31 + 5)
    assert abs(p1 - p2) / p1 < 0.02 and abs(o1 - o2) / o1 < 0.02
    assert g1 == g2 == 32


def test_first_requests_spread_their_ends():
    s = closed_loop.Schedule(MIX, 32064, 3)
    firsts = [s(i).max_tokens for i in range(32)]
    assert min(firsts) < 30 and max(firsts) > 90


def test_training_batches_repeat_and_rows_differ():
    mix = {"batch": 4, "seq_len": 64}
    a = train_batches.batches(mix, 32064, 2**31 + 9, 8)
    b = train_batches.batches(mix, 32064, 2**31 + 9, 8)
    assert a.shape == (8, 4, 65) and np.array_equal(a, b)
    rows = a.reshape(-1, 65)
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert a.min() >= 0 and a.max() < 32064
