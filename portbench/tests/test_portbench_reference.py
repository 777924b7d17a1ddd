"""The references against the program at tiny widths on the CPU (the
test imports both; the reference modules import nothing of the
program)."""

import time

import pytest
import torch

from portbench import run as bench_run, weights
from portbench.drivers import serve, train
from portbench.reference import gpt2 as ref_gpt2, mistral as ref_mistral
from portbench.tests import tiny


def test_mistral_reference_matches_the_program_forward():
    from ant_ray_tpu_torch.models import llama

    cfg = tiny.mistral()
    lcfg = serve.llama_config(llama, cfg)
    w = weights.make(weights.decoder_shapes(cfg), weights.decoder_constant,
                     11, torch.device("cpu"), torch.float32)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    ours = ref_mistral.logits(w, cfg, tokens[0], 0)
    theirs = llama.forward(w, tokens, lcfg, attn_impl="reference")[0]
    assert torch.allclose(ours, theirs, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name,traffic", [("mistral7b.chat", tiny.chat),
                                          ("mistral7b.docs", tiny.docs)])
def test_served_tokens_agree_with_the_reference(name, traffic):
    run = bench_run.execute(tiny.bench(), tiny.cell(name, "x", "x"),
                            2**31 + 3, 2.0, False, "cpu",
                            config=tiny.mistral(), traffic=traffic(),
                            t0=time.monotonic())
    assert run.attempted > 0 and run.failed == 0
    assert serve.finished(run)
    value, _ = run.checks["logit_gap_max"]
    assert value is not None and value < 1e-4
    assert run.checks["short_answers"][0] == 0
    assert run.correct


def test_gpt2_reference_follows_the_program_step():
    run = bench_run.execute(tiny.bench(),
                            tiny.cell("gpt2xl.train", "x", "x"), 2**31 + 9,
                            1.0, False, "cpu", config=tiny.gpt2(),
                            traffic=tiny.train_traffic(), t0=time.monotonic())
    assert len(run.train_steps) >= 1
    for name in ("loss_gap", "grad_gap", "change_gap"):
        assert run.checks[name][0] < 1e-4, name
    assert run.correct


def test_gpt2_reference_loss_matches_the_program_loss():
    from ant_ray_tpu_torch.models import gpt2

    cfg = tiny.gpt2()
    gcfg = train.gpt2_config(gpt2, cfg)
    w = weights.make(weights.gpt2_shapes(cfg), weights.gpt2_constant, 5,
                     torch.device("cpu"), torch.float32)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 33),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        theirs = gpt2.loss_fn(w, {"tokens": tokens}, gcfg,
                              attn_impl="reference")
        ours = ref_gpt2.loss_sum(ref_gpt2.flat(w) | w["layers"], tokens,
                                 cfg) / (3 * 32)
    assert float(ours) == pytest.approx(float(theirs), rel=1e-5)
