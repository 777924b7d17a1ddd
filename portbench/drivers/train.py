"""Training driver: the program's ``train/step.py`` ``train_step`` with
``make_optimizer``'s AdamW, on seeded token batches, back to back.

Set-up builds the one training object (weights from the seed, the
optimizer) and drives it through its first ``check_steps`` steps on the
window's own call and feed; those steps are the warm-up too.  The
window then goes on stepping the same object until ``--seconds`` have
passed; each step reads its loss (a synchronise), and the window closes
with the last step begun before its end.

The check, after the program's state is freed: the family's fp32
reference follows the first steps from the same weights and batches,
and the run compares each step's loss, each leaf's gradient norm at
step 1 (the program's worked out from AdamW's first moment after one
step) and each leaf's change after the last check step (taken before
the window's steps move it).  Gaps are taken by the worst leaf, each
against the larger of the reference's norm of that leaf and of the
median leaf.
"""

from __future__ import annotations

import gc
import importlib
import statistics
import time

import torch

from portbench import counts, weights
from portbench.record import Run, TrainStep
from portbench.trace import Profiler, Spans

BETA1 = 0.9              # make_optimizer's first-moment decay
OPTIMIZER_SPAN = "Optimizer.step#AdamW.step"


def gpt2_config(gpt2, cfg: dict):
    """The program's config for a GPT-2 model file."""
    if cfg["activation_function"] != "gelu_new":
        raise ValueError("the program's GPT-2 uses the tanh GELU only")
    if any(cfg[k] for k in ("attn_pdrop", "embd_pdrop", "resid_pdrop")):
        raise ValueError("the program's GPT-2 has no dropout")
    return gpt2.Gpt2Config(
        vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
        dim=cfg["n_embd"], n_layers=cfg["n_layer"], n_heads=cfg["n_head"],
        norm_eps=cfg["layer_norm_epsilon"],
        dtype=weights.DTYPES[cfg["torch_dtype"]])


def batches(seed: int, tr: dict, vocab: int, device):
    """The run's token batches, (batch, seq + 1), drawn on the card."""
    gen = torch.Generator(device=device).manual_seed((int(seed) + 7) % 2**63)
    while True:
        yield torch.randint(0, vocab, (tr["batch"], tr["seq"] + 1),
                            generator=gen, device=device)


def _norms(tree: dict) -> dict:
    from portbench.reference.gpt2 import flat
    return {n: float(t.detach().float().norm()) for n, t in flat(tree).items()}


class Trainer:
    """The program's training object and its first steps' readings."""

    def __init__(self, run: Run, device: torch.device, t0: float):
        from ant_ray_tpu_torch.models import gpt2
        from ant_ray_tpu_torch.train import step

        self.step_mod, self.device, self.cfg = step, device, run.config
        split = run.setup_split
        mark = time.monotonic()
        split["import"] = mark - t0
        self.gcfg = gpt2_config(gpt2, run.config)
        self.shapes = weights.gpt2_shapes(run.config)
        if not weights.same_layout(self.shapes, gpt2.param_shapes(self.gcfg)):
            raise RuntimeError("the program's parameter layout changed")
        self.params = weights.make(self.shapes, weights.gpt2_constant,
                                   run.seed, device, self.gcfg.dtype)
        opt = run.config["step"]
        # fp32 matmuls in TF32 or not, as the configuration states
        torch.backends.cuda.matmul.allow_tf32 = bool(opt["allow_tf32"])
        self.optimizer = step.make_optimizer(self.params, lr=opt["lr"],
                                             weight_decay=opt["weight_decay"])
        self.feed = batches(run.seed, run.traffic, self.gcfg.vocab_size,
                            device)
        _sync(device)
        split["weights"], mark = time.monotonic() - mark, time.monotonic()
        self.readings = self.first_steps(run)
        split["warm_up"] = time.monotonic() - mark

    def step(self, tokens) -> float:
        loss = self.step_mod.train_step(self.params, self.optimizer, tokens,
                                        self.gcfg, device=self.device)
        return float(loss)

    def _first_moment(self, p):
        state = self.optimizer.state.get(p)
        return state["exp_avg"] if state else torch.zeros_like(p)

    def first_steps(self, run: Run) -> dict:
        """The check steps: losses, step-1 gradient norms from AdamW's
        first moment, the change of every leaf after the last one."""
        losses, grads = [], None
        for _ in range(run.traffic["check_steps"]):
            losses.append(self.step(next(self.feed)))
            if grads is None:
                grads = {n: v / (1 - BETA1) for n, v in _norms(
                    {n: self._first_moment(p)
                     for n, p in _flat_params(self.params).items()}).items()}
        start = weights.make(self.shapes, weights.gpt2_constant, run.seed,
                             self.device, self.gcfg.dtype)
        from portbench.reference.gpt2 import flat
        before = flat(start)
        change = {n: float((p.detach().float() - before[n].float()).norm())
                  for n, p in flat(self.params).items()}
        del start, before
        return {"losses": losses, "grad_norms": grads, "change_norms": change}

    def window(self, run: Run, trace_on: bool, t0: float):
        spans = Spans()
        prof = Profiler(spans) if trace_on else None
        opt_step = self.optimizer.step
        if trace_on:
            def traced_step(*args, **kwargs):
                with spans(OPTIMIZER_SPAN):
                    return opt_step(*args, **kwargs)
            self.optimizer.step = traced_step
        gc.collect()
        gc.freeze()        # set-up's objects: not collected in the window
        if prof is not None:
            prof.start()
        start = time.monotonic()
        run.window_start, run.setup_s = start, start - t0
        close = start + run.seconds
        tokens = run.traffic["batch"] * run.traffic["seq"]
        end = start
        while end < close:
            batch = next(self.feed)
            with spans("portbench.train_step"):
                loss = self.step(batch)
            begun, end = end, time.monotonic()
            run.train_steps.append(TrainStep(begun, end, tokens, loss))
        run.window_close = end
        gc.unfreeze()
        if prof is not None:
            run.trace = prof.stop()
            run.notes.append("trace: " + prof.cost)
            self.optimizer.step = opt_step
        run.attempted = len(run.train_steps)
        run.failed = sum(not _finite(st.loss) for st in run.train_steps)

    def release(self):
        self.optimizer = self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _flat_params(params: dict) -> dict:
    from portbench.reference.gpt2 import flat
    return flat(params)


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run: Run, device: torch.device, trace_on: bool, t0: float) -> Run:
    trainer = Trainer(run, device, t0)
    run.counts = counts.Gpt2(run.config)
    trainer.window(run, trace_on, t0)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    prog = trainer.readings
    trainer.release()
    ref = reference_readings(run, device)
    for name, (value, _) in gaps(prog, ref).items():
        run.checks[name] = (value, run.traffic["check"]["limits"][name])
    return run


def reference_readings(run: Run, device, control: bool = False,
                       half_batch: bool = False) -> dict:
    """The family's fp32 reference over the check steps, from the same
    weights and batches (``half_batch``: the first half of each batch's
    rows, a planted fault)."""
    ref = importlib.import_module(
        f"portbench.reference.{run.config['family']}")
    tr = run.traffic
    dtype = weights.DTYPES[run.config["torch_dtype"]]
    w0 = weights.make(weights.gpt2_shapes(run.config), weights.gpt2_constant,
                      run.seed, device, dtype)
    feed = batches(run.seed, tr, run.config["vocab_size"], device)
    steps = [next(feed) for _ in range(tr["check_steps"])]
    if half_batch:
        steps = [b[: b.shape[0] // 2] for b in steps]
    opt = run.config["step"]
    return ref.train(w0, run.config, steps, lr=opt["lr"],
                     weight_decay=opt["weight_decay"], control=control)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared, each against its limit: the worst step's
    relative loss gap, the worst leaf's gap of step-1 gradient norms and
    of change norms.  A leaf whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding, as a key bias
    under softmax) is left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(prog["grad_norms"][n] - v) / max(v, g_med)
               for n, v in g_ref.items())
    kept = [n for n, v in g_ref.items() if v >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[n] for n in kept)
    change = max(abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med)
                 for n in kept)
    return {"loss_gap": (loss, None), "grad_gap": (grad, None),
            "change_gap": (change, None)}


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf (gradient gap, change gap), for a look at the worst."""
    g_ref, c_ref = ref["grad_norms"], ref["change_norms"]
    g_med = statistics.median(g_ref.values())
    c_med = statistics.median(c_ref.values())
    return {n: (abs(prog["grad_norms"][n] - g_ref[n]) / max(g_ref[n], g_med),
                abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med))
            for n in g_ref}
