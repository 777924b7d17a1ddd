"""The frozen counts against numbers worked out by hand, and against
the program's own parameter counts."""

import json
from pathlib import Path

import pytest

from portbench import counts

HERE = Path(__file__).resolve().parent.parent


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_mistral_sizes():
    c = counts.Decoder(_cfg("mistral-7b-v0.3"))
    # embed + head 2 * 32768 * 4096; a layer: q, o 4096^2 each, k, v
    # 4096 * 1024 each, MLP 3 * 4096 * 14336, two norms; a final norm
    layer = 2 * 4096**2 + 2 * 4096 * 1024 + 3 * 4096 * 14336 + 2 * 4096
    assert c.params == 2 * 32768 * 4096 + 32 * layer + 4096 == 7_248_023_552
    assert c.kv_bytes_per_token == 131072
    assert c.kv_bytes_per_token * 32 * 4096 == 17_179_869_184


def test_gpt2_xl_sizes():
    c = counts.Gpt2(_cfg("gpt2-xl"))
    assert c.params == 1_557_611_200
    assert c.matmul_params == 48 * 12 * 1600**2 + 1600 * 50257
    flops = c.train_step_flops(32, 1024)
    assert flops == pytest.approx(6 * c.matmul_params * 32768
                                  + 12 * 48 * 1600 * (1024 * 1025 // 2) * 32)


def test_counts_agree_with_the_program():
    from ant_ray_tpu_torch.models import gpt2, llama
    from portbench.drivers import serve, train

    m = _cfg("mistral-7b-v0.3")
    assert counts.Decoder(m).params == \
        serve.llama_config(llama, m).num_params()
    g = _cfg("gpt2-xl")
    assert counts.Gpt2(g).params == train.gpt2_config(gpt2, g).num_params()


def test_decode_and_prefill_arithmetic():
    c = counts.Decoder(_cfg("mistral-7b-v0.3"))
    per_tok = 2 * (32 * c.layer_matmul_params + 4096 * 32768)
    attn = 4 * 32 * 32 * 128
    assert c.decode_flops([0, 9]) == per_tok * 2 + attn * (1 + 10)
    assert c.prefill_flops(3) == (2 * 32 * c.layer_matmul_params * 3
                                  + attn * 6 + 2 * 4096 * 32768)
    weights = (32 * c.layer_matmul_params + 32 * 2 * 4096 + 4096
               + 4096 * 32768) * 2
    assert c.decode_bytes([5, 7]) == (weights + 2 * 4096 * 2 + 12 * 131072
                                      + 2 * 131072 + 2 * 32768 * 4)
    assert c.decode_bytes([]) == 0


def test_step_readers_on_a_hand_built_run():
    from portbench import readers
    from portbench.record import EngineStep, Run
    from portbench.trace import Span, Trace, _union

    cfg = json.loads((HERE / "configs" / "mistral-7b-v0.3.json").read_text())
    run = Run(cell={}, config=cfg, traffic={}, seed=0, seconds=1.0,
              counts=counts.Decoder(cfg))
    run.steps = [EngineStep(0.2, {"decode": 0.1}, [(2048, 1500)], [100, 50]),
                 EngineStep(0.1, {"decode": 0.1}, [], [101, 51])]
    assert readers.decode_step_ms(run) == pytest.approx(100.0)
    nbytes = (run.counts.decode_bytes([100, 50])
              + run.counts.decode_bytes([101, 51]))
    assert readers.decode_bw_share(run) == pytest.approx(
        100 * nbytes / (0.2 * 3.35e12))
    flops = (run.counts.prefill_flops(1500)
             + run.counts.decode_flops([100, 50])
             + run.counts.decode_flops([101, 51]))
    assert readers.serve_mfu(run) == pytest.approx(
        100 * flops / (0.3 * 989e12))
    # device busy 0-30 and 40-60 (ns); steps 10-50 and 55-100
    merged = _union([(0, 20, "a", 1), (5, 30, "b", 2), (40, 60, "c", 3)])
    assert merged == [(0, 30), (40, 60)]
    run.trace = Trace(window_s=1.0, busy_ns=50, op_ns={}, busy=merged,
                      spans={"portbench.step": [Span("s", 10, 50),
                                                Span("s", 55, 100)]})
    assert run.trace.busy_within("portbench.step") == (20 + 10 + 5, 85)
    assert readers.device_idle_share(run, "portbench.step") == \
        pytest.approx(100 * (1 - 35 / 85))


def test_spans_align_to_the_synchronises_nearest_the_host_marks():
    from portbench.trace import Span, _align

    spans = [Span("s", 1_000, 2_000), Span("s", 9_000, 10_000)]
    # the trace's clock runs 10 ahead and 1 % fast; the profiler adds a
    # synchronise of its own after the harness's last mark
    _align(spans, (0, 10_000), [10, 10_110, 10_500])
    assert [(s.start, s.end) for s in spans] == [(1_020, 2_030),
                                                 (9_100, 10_110)]
