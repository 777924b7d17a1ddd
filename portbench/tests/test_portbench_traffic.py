"""The traffic generator: the same seed gives the same requests, every
seed the same open-loop schedule with its own token ids, closed-loop
blocks of the same sizes, lengths in their clips."""

import json
from pathlib import Path

import numpy as np

from portbench import traffic

HERE = Path(__file__).resolve().parent.parent


def _load(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def test_open_loop_is_a_function_of_the_seed():
    tr = _load("mistral7b.chat")
    a = traffic.open_loop(tr, 2**31 + 17, 51, 32768)
    b = traffic.open_loop(tr, 2**31 + 17, 51, 32768)
    assert [r.at_s for r in a] == [r.at_s for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_tokens for r in a] == [r.max_tokens for r in b]


def test_open_loop_seeds_share_the_schedule():
    tr = _load("mistral7b.chat")
    a = traffic.open_loop(tr, 1, 51, 32768)
    b = traffic.open_loop(tr, 2, 51, 32768)
    assert len(a) == len(b) == round(tr["rate_per_s"] * 51)
    assert [r.at_s for r in a] == [r.at_s for r in b]
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_tokens for r in a] == [r.max_tokens for r in b]
    assert not any(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert all(0 < r.at_s < 51 for r in a)
    other = traffic.open_loop(dict(tr, shape_seed=tr["shape_seed"] + 1), 1,
                              51, 32768)
    assert [r.at_s for r in other] != [r.at_s for r in a]


def test_lengths_stay_in_their_clips():
    tr = _load("mistral7b.chat")
    reqs = traffic.open_loop(tr, 2**32 + 5, 51, 32768)
    p, o = tr["prompt_tokens"], tr["output_tokens"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
    assert all(o["min"] <= r.max_tokens <= o["max"] for r in reqs)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 32768 for r in reqs)
    rng = np.random.default_rng(0)
    x = traffic.lengths({"dist": "lognormal", "median": 512, "sigma": 0.9,
                         "min": 64, "max": 2048}, 20000, rng)
    assert 480 <= np.median(x) <= 545 and x.min() >= 64 and x.max() <= 2048


def test_closed_loop_blocks_hold_the_same_sizes():
    tr = _load("mistral7b.docs")
    for seed in (3, 4):
        stream = traffic.ClosedLoop(tr, seed, 32768)
        reqs = [stream.next() for _ in range(3 * tr["block"])]
        blocks = [sorted(len(r.prompt) for r in reqs[i:i + tr["block"]])
                  for i in range(0, len(reqs), tr["block"])]
        assert blocks[0] == blocks[1] == blocks[2]
        lo, hi = tr["prompt_tokens"]["min"], tr["prompt_tokens"]["max"]
        assert all(lo <= len(r.prompt) <= hi and r.max_tokens == 1
                   for r in reqs)
    a = traffic.ClosedLoop(tr, 9, 32768)
    b = traffic.ClosedLoop(tr, 9, 32768)
    assert all(np.array_equal(a.next().prompt, b.next().prompt)
               for _ in range(40))
