"""A run with the timed path broken underneath comes out not correct:
once for each fault the cell can have.  The chip check is skipped
(``execute`` on the CPU, one layer at the published hidden width, so
logits spread as the cell's do and its limits apply); everything after
it runs."""

import time

import pytest

from portbench import faults, run as bench_run
from portbench.drivers import serve
from portbench.tests import tiny


def _serve(name, traffic):
    return bench_run.execute(tiny.bench(), tiny.cell(name, "x", "x"),
                             2**31 + 21, 6.0, False, "cpu",
                             config=tiny.mistral_wide(), traffic=traffic(),
                             t0=time.monotonic())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_chat_faults_come_out_not_correct(fault, monkeypatch):
    """Beside each fault, the same run unbroken is correct (below)."""
    faults.plant(fault, monkeypatch.setattr)
    run = _serve("mistral7b.chat", tiny.chat_long_answers)
    out = bench_run.result(tiny.bench(), run, False, "cpu")
    assert out["correct"] is False
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,traffic",
                         [("mistral7b.chat", tiny.chat_long_answers),
                          ("mistral7b.docs", tiny.docs)])
def test_the_unbroken_run_is_correct(name, traffic):
    run = _serve(name, traffic)
    assert serve.finished(run)
    assert run.correct


def test_docs_token_altered_comes_out_not_correct(monkeypatch):
    from ant_ray_tpu_torch.llm.engine import LLMEngine

    one, _ = faults.altered_sampling(LLMEngine, period=1)
    monkeypatch.setattr(LLMEngine, "_sample_one", one)
    run = _serve("mistral7b.docs", tiny.docs)
    assert run.correct is False


def _train(monkeypatch, fault):
    from ant_ray_tpu_torch.train import step

    orig = step.train_step

    def train_step(params, optimizer, tokens, config, **kw):
        if fault == "state_unchanged":
            optimizer.zero_grad(set_to_none=True)
            loss = step.gpt2.loss_fn(params, {"tokens": tokens}, config)
            loss.backward()            # no update: the state stays
            return loss.detach()
        if fault == "half_batch":
            return orig(params, optimizer, tokens[: tokens.shape[0] // 2],
                        config, **kw)
        return orig(params, optimizer, tokens, config, **kw) * 1.01

    monkeypatch.setattr(step, "train_step", train_step)
    return bench_run.execute(tiny.bench(),
                             tiny.cell("gpt2xl.train", "x", "x"), 2**31 + 5,
                             1.0, False, "cpu", config=tiny.gpt2(),
                             traffic=tiny.train_traffic(),
                             t0=time.monotonic())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_train_faults_come_out_not_correct(fault, monkeypatch):
    run = _train(monkeypatch, fault)
    assert run.correct is False
