"""The control: the reference computed in fp8 (the precision below the
configuration's bf16), put in the program's place.  It has to come out
as not correct, where the program comes out correct."""

import json
import time

import pytest
import torch

from portbench.drivers import serve
from portbench.record import Run
from portbench.tests import tiny

SMALL = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
             num_key_value_heads=2, head_dim=64, num_hidden_layers=4,
             vocab_size=4096)


def _readings(cfg, tr, seed, seconds, device):
    run = Run(cell=tiny.cell("mistral7b.chat", "x", "x"), config=cfg,
              traffic=tr, seed=seed, seconds=seconds)
    server = serve.Server(run, device, time.monotonic())
    prompts = server.window(run, False, time.monotonic())
    server.release_engine()
    serve.check(run, server.weights, prompts, control=True)
    return run


def test_control_separates_from_the_program_at_small_size():
    program, control = [], []
    for seed in (1, 2, 3):
        run = _readings(tiny.mistral("bfloat16", **SMALL), tiny.chat(), seed,
                        3.0, torch.device("cpu"))
        program.append(run.checks["logit_gap_max"][0])
        control.append(run.checks["control_logit_gap_max"][0])
    assert min(control) > 3 * max(program)


@pytest.mark.gpu
def test_control_is_not_correct_at_the_cells_size():
    """On the card: one window of mistral7b.chat at its size and load;
    the program's gap within the cell's limit, the control's beyond it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, tr = tiny.load("configs", "mistral-7b-v0.3"), tiny.load(
        "traffic", "mistral7b.chat")
    run = _readings(cfg, tr, 2**31 + 77, 51.0, torch.device("cuda:0"))
    value, limit = run.checks["logit_gap_max"]
    assert value <= limit < run.checks["control_logit_gap_max"][0]
    print(json.dumps({k: v for k, (v, _) in run.checks.items()}))
