"""Serving driver: the program's ``LLMEngine`` behind its ``EngineLoop``,
fed by the traffic file's open or closed loop through
``EngineLoop.submit``, as a server's request threads feed it.

Each request's stream is read as it arrives: its handle's event queue
is replaced by a sink that stamps every event with the host's monotonic
clock.  A request's latencies count from when it was due.

After the window: the card's peak memory is read, the program's state
(engine, slabs) is freed, and a sample of the finished requests, drawn
from the seed with the longest among them, is run through the family's
fp32 reference.  ``logit_gap_max`` is the widest gap by which a served
token's reference logit lies below the reference's best at its
position; ``short_answers`` counts finished requests that served another
number of tokens than they asked for.
"""

from __future__ import annotations

import gc
import importlib
import threading
import time

import numpy as np
import torch

from portbench import counts, traffic as gen, weights
from portbench.record import EngineStep, Run, Served
from portbench.trace import Profiler, Spans

class TokenIds:
    """The engine's tokenizer for a run that sends token ids: it has no
    end-of-sequence id (a random model would stop at it by chance) and
    decodes to nothing."""

    eos_id = None

    def encode(self, text):
        raise ValueError("the benchmark sends token ids")

    def decode(self, ids):
        return ""


class _Sink:
    """Stands in for a handle's event queue: stamps what arrives."""

    def __init__(self, served: Served):
        self.served = served

    def put(self, ev):
        now = time.monotonic()
        s = self.served
        if ev["type"] == "token":
            s.token_times.append(now)
        elif ev["type"] == "final":
            s.done = now
            s.tokens = list(ev["output"].token_ids)
        elif ev["type"] == "error":
            s.done = now
            s.error = repr(ev["error"])


def _attach(handle, served: Served):
    old, handle.events = handle.events, _Sink(served)
    while not old.empty():
        handle.events.put(old.get_nowait())


class _Tap:
    """In a traced run: the harness's spans around each engine step and
    each call into the model layer, and one record a step.  Only steps
    that end while the spans record (before the window closes) are
    kept: the step in flight at the close would count the profiler's
    stop in its wall."""

    def __init__(self, engine, llama, spans: Spans):
        self.engine, self.llama, self.spans = engine, llama, spans
        self.steps: list[EngineStep] = []
        self._cur = None
        self._prefill = llama.prefill_into_cache
        self._decode = llama.decode_step
        self._step = engine.step
        llama.prefill_into_cache = self.prefill
        llama.decode_step = self.decode
        engine.step = self.step

    def close(self):
        self.llama.prefill_into_cache = self._prefill
        self.llama.decode_step = self._decode
        del self.engine.step
        self.engine = None

    def prefill(self, params, tokens, cache, slot, length, config, **kw):
        if self._cur is not None:
            self._cur.prefills.append((int(tokens.shape[1]), int(length)))
        with self.spans("portbench.prefill"):
            return self._prefill(params, tokens, cache, slot, length, config,
                                 **kw)

    def decode(self, params, last_tokens, cache, config, active=None):
        if self._cur is not None:
            self._cur.decode_contexts = [
                s.kv_len for s in self.engine._active.values()]
        with self.spans("portbench.decode"):
            return self._decode(params, last_tokens, cache, config,
                                active=active)

    def step(self):
        rec = self._cur = EngineStep(0.0, {}) if self.spans.on else None
        with self.spans("portbench.step"):
            out = self._step()
        self._cur = None
        if rec is not None and self.spans.on:
            _, _, rec.total_s, phases = self.engine.profiler.records[-1]
            rec.phases = dict(phases)
            self.steps.append(rec)
        return out


def llama_config(llama, cfg: dict):
    """The program's config for a Mistral-layout model file."""
    if cfg["head_dim"] * cfg["num_attention_heads"] != cfg["hidden_size"]:
        raise ValueError("the program derives head_dim from hidden_size")
    if cfg.get("sliding_window") is not None:
        raise ValueError("the program has no sliding-window attention")
    return llama.LlamaConfig(
        vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        dtype=weights.DTYPES[cfg["torch_dtype"]],
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)))


def buckets(lo: int, hi: int, cap: int) -> list[int]:
    """The prefill buckets prompts of lo..hi tokens fall in: powers of
    two from 16, at most ``cap`` (the engine's rule)."""
    out, b = [], 16
    while True:
        top = min(b, cap)
        if top >= lo and (not out or out[-1] < top):
            out.append(top)
        if b >= hi or top == cap:
            return out
        b *= 2


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """The program built once: weights from the seed, an engine, its
    cell's shapes warmed.  ``window`` runs one measured window of the
    run's traffic through a fresh ``EngineLoop``."""

    def __init__(self, run: Run, device: torch.device, t0: float):
        from ant_ray_tpu_torch.llm import engine as engine_mod
        from ant_ray_tpu_torch.llm.sampling import SamplingParams
        from ant_ray_tpu_torch.models import llama
        from ant_ray_tpu_torch.observability import step_profiler

        self.engine_mod, self.llama = engine_mod, llama
        self.SamplingParams = SamplingParams
        self.StepProfiler = step_profiler.StepProfiler
        self.device, self.cfg = device, run.config
        split = run.setup_split
        mark = time.monotonic()
        split["import"] = mark - t0
        self.lcfg = llama_config(llama, self.cfg)
        self.shapes = weights.decoder_shapes(self.cfg)
        if not weights.same_layout(self.shapes, llama.param_shapes(self.lcfg)):
            raise RuntimeError("the program's parameter layout changed")
        self.weights = self.engine = None
        self.reseed(run.seed)
        split["weights"], mark = time.monotonic() - mark, time.monotonic()
        self.fresh_engine(run.seed)
        split["cache"], mark = time.monotonic() - mark, time.monotonic()
        self.warm_up(run.traffic)
        split["warm_up"] = time.monotonic() - mark

    def reseed(self, seed: int):
        """The benchmark's weights for ``seed``, made on the card."""
        self.weights = None
        self.weights = weights.make(self.shapes, weights.decoder_constant,
                                    seed, self.device, self.lcfg.dtype)
        _sync(self.device)

    def fresh_engine(self, seed: int):
        """A new engine (empty slabs) on the current weights."""
        eng = self.cfg["engine"]
        self.engine = None
        gc.collect()
        self.engine = self.engine_mod.LLMEngine(
            self.lcfg, params=self.weights, slots=eng["slots"],
            max_seq=eng["max_seq"], tokenizer=TokenIds(), seed=seed % 2**31,
            device=self.device,
            prefill_chunk_tokens=eng["prefill_chunk_tokens"])
        _sync(self.device)

    def warm_up(self, tr: dict):
        """One request at each prefill bucket the traffic reaches, with a
        decode step where the traffic decodes."""
        plo, phi = _length_range(tr["prompt_tokens"])
        decode = _length_range(tr["output_tokens"])[1] > 1
        warm = np.random.default_rng(0)
        for b in buckets(plo, phi, self.engine.max_seq):
            ids = warm.integers(0, self.lcfg.vocab_size, min(b, phi)).tolist()
            self.engine.generate(
                [ids], self.SamplingParams(max_tokens=2 if decode else 1))
        _sync(self.device)

    def window(self, run: Run, trace_on: bool, t0: float) -> dict:
        """Measure one window into ``run``; returns the prompts by
        request index."""
        engine = self.engine
        engine.profiler = self.StepProfiler(
            peak_flops=counts.PEAK_BF16_FLOPS, publish=False, history=1 << 20)
        spans = Spans()
        tap = _Tap(engine, self.llama, spans) if trace_on else None
        prof = Profiler(spans) if trace_on else None
        loop = self.engine_mod.EngineLoop(engine)
        run.counts = counts.Decoder(run.config)
        send = _open_loop if run.traffic["loop"] == "open" else _closed_loop
        held = _KvHeld(engine, run.counts.kv_bytes_per_token)
        try:
            prompts = send(run, loop, self.SamplingParams, prof, t0, held)
        finally:
            loop.shutdown(timeout=120.0)
            if tap is not None:
                run.steps = tap.steps
                tap.close()
                tokens = sum(n for st in run.steps for _, n in st.prefills)
                run.notes.append(
                    f"traced steps {len(run.steps)}: walls "
                    f"{sum(st.total_s for st in run.steps):.3f} s, prefill "
                    f"tokens {tokens}, decode steps "
                    f"{sum(bool(st.decode_contexts) for st in run.steps)}")
        run.attempted = len(run.served)
        run.failed = sum(s.error is not None for s in run.served)
        slabs = (engine.slots * engine.max_seq
                 * run.counts.kv_bytes_per_token)
        if held.samples:
            run.notes.append(held.line(slabs))
        return prompts

    def release_engine(self):
        """Free the program's state (engine, slabs); the weights stay."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(run: Run, device: torch.device, trace_on: bool, t0: float) -> Run:
    server = Server(run, device, t0)
    prompts = server.window(run, trace_on, t0)
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0)
    server.release_engine()
    check(run, server.weights, prompts)
    return run


def _length_range(spec: dict) -> tuple[int, int]:
    if spec["dist"] == "fixed":
        return int(spec["value"]), int(spec["value"])
    return int(spec["min"]), int(spec["max"])


class _Window:
    """Opens the window (after starting the profiler, in a traced run)
    and closes it."""

    def __init__(self, run: Run, prof, t0: float):
        self.run, self.prof = run, prof
        gc.collect()
        gc.freeze()        # set-up's objects: not collected in the window
        if prof is not None:
            prof.start()
        start = time.monotonic()
        run.window_start, run.window_close = start, start + run.seconds
        run.setup_s = start - t0

    def close(self):
        _sleep_to(self.run.window_close)
        gc.unfreeze()
        if self.prof is not None:
            mark = time.monotonic()
            self.run.trace = self.prof.stop()
            self.run.notes.append("trace stopped and reduced in "
                                  f"{time.monotonic() - mark:.3f} s: "
                                  + self.prof.cost)


class _KvHeld:
    """Bytes of K/V the engine's decoding slots hold (their tokens so
    far times the bytes a token takes), read at each open-loop send.  (A
    one-token request leaves no slot decoding: it holds its prompt's K/V
    only during its prefill.)"""

    def __init__(self, engine, per_token: int):
        self.engine, self.per_token = engine, per_token
        self.samples = []

    def read(self):
        active = list(self.engine._active.values())
        self.samples.append(sum(s.kv_len for s in active) * self.per_token)

    def line(self, slabs: int) -> str:
        mean, top = float(np.mean(self.samples)), max(self.samples)
        return (f"K/V held at sends: mean {mean:.0f} bytes, max {top} bytes "
                f"over {len(self.samples)} sends, of {slabs} bytes of slabs "
                f"({100.0 * mean / slabs:.2f} % / {100.0 * top / slabs:.2f} "
                "%)")


def _sleep_to(t: float):
    delay = t - time.monotonic()
    if delay > 0:
        time.sleep(delay)


def _open_loop(run: Run, loop, SamplingParams, prof, t0, held) -> dict:
    reqs = gen.open_loop(run.traffic, run.seed, run.seconds,
                         run.config["vocab_size"])
    window = _Window(run, prof, t0)
    late = []
    for r in reqs:
        s = Served(r.index, window.run.window_start + r.at_s, len(r.prompt),
                   r.max_tokens)
        run.served.append(s)
        _sleep_to(s.due)
        late.append(time.monotonic() - s.due)
        held.read()
        handle = loop.submit(r.prompt.tolist(),
                             SamplingParams(max_tokens=r.max_tokens),
                             request_id=f"q{r.index}")
        _attach(handle, s)
    window.close()
    run.notes.append(f"generator late: median {np.median(late) * 1e3:.3f} ms,"
                     f" max {max(late) * 1e3:.3f} ms over {len(late)} sends")
    return {r.index: r.prompt for r in reqs}


def _closed_loop(run: Run, loop, SamplingParams, prof, t0, held) -> dict:
    stream = gen.ClosedLoop(run.traffic, run.seed, run.config["vocab_size"])
    lock = threading.Lock()
    prompts = {}
    window = _Window(run, prof, t0)

    def client():
        while True:
            with lock:
                now = time.monotonic()
                if now >= run.window_close:
                    return
                r = stream.next()
                s = Served(r.index, now, len(r.prompt), r.max_tokens)
                run.served.append(s)
                prompts[r.index] = r.prompt
            handle = loop.submit(r.prompt.tolist(),
                                 SamplingParams(max_tokens=r.max_tokens),
                                 request_id=f"q{r.index}")
            _attach(handle, s)
            try:
                handle.wait(timeout=max(0.0, run.window_close
                                        - time.monotonic()))
            except TimeoutError:
                return
            except Exception:  # noqa: BLE001 — the sink recorded it
                continue

    clients = [threading.Thread(target=client, name=f"client-{i}",
                                daemon=True)
               for i in range(int(run.traffic["clients"]))]
    for c in clients:
        c.start()
    window.close()
    for c in clients:
        c.join(timeout=120.0)
    return prompts


def finished(run: Run) -> list[Served]:
    """Requests that finished inside the window without an error."""
    return [s for s in run.served if s.error is None and s.done is not None
            and s.done <= run.window_close]


def sample(run: Run, done: list[Served]) -> list[Served]:
    """The longest finished request and others drawn from the seed,
    until the sample serves ``sample_tokens`` tokens or holds
    ``sample_requests`` requests."""
    chk = run.traffic["check"]
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.tokens), s.prompt_len, -s.index))
    pick, n_tok = [longest], len(longest.tokens)
    rng = np.random.default_rng([run.seed & 0xFFFFFFFFFFFFFFFF, 5])
    for j in rng.permutation(len(done)):
        if (len(pick) >= chk["sample_requests"]
                or n_tok >= chk["sample_tokens"]):
            break
        if done[j] is not longest:
            pick.append(done[j])
            n_tok += len(done[j].tokens)
    return pick


def check(run: Run, w: dict, prompts: dict, control: bool = False):
    limits = run.traffic["check"]["limits"]
    done = finished(run)
    short = sum(len(s.tokens) != s.max_tokens for s in done)
    run.checks["short_answers"] = (float(short), limits["short_answers"])
    ref = importlib.import_module(
        f"portbench.reference.{run.config['family']}")
    gap = ctrl = None
    for s in sample(run, done):
        prompt = prompts[s.index].tolist()
        gaps = ref.served_gaps(w, run.config, prompt, s.tokens)
        g = float(gaps.max())
        gap = g if gap is None else max(gap, g)
        if control:
            run.notes.append(
                f"request {s.index}: prompt {len(prompt)}, served "
                f"{len(s.tokens)}, widest gap {g:.5f} at token "
                f"{int(gaps.argmax())}, mean {float(gaps.mean()):.6f}")
        if control:
            c = float(ref.served_gaps(w, run.config, prompt, s.tokens,
                                      control=True).max())
            ctrl = c if ctrl is None else max(ctrl, c)
    run.checks["logit_gap_max"] = (gap, limits["logit_gap_max"])
    if control:
        run.checks["control_logit_gap_max"] = (ctrl, limits["logit_gap_max"])
