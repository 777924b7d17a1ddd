"""Faults planted under the serving path's timed calls, for the tests
that see a broken run come out not correct and for ``calibrate``'s
reading of a fault at a cell's own size.  Not run by the benchmark's
own runs."""

from __future__ import annotations


def frozen_decode(llama):
    orig = llama.decode_step

    def decode_step(params, last, cache, config, active=None):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, cache = orig(params, last, cache, config, active=active)
        cache.update(saved)            # the step leaves its state unchanged
        return logits, cache
    return decode_step


def half_batch_decode(llama):
    orig = llama.decode_step

    def decode_step(params, last, cache, config, active=None):
        logits, cache = orig(params, last, cache, config, active=active)
        half = logits.shape[0] // 2    # the second half's rows left out
        logits = logits.clone()
        logits[half:] = logits[:half].mean(0, keepdim=True)
        return logits, cache
    return decode_step


def altered_sampling(engine_cls, period=3):
    """Every ``period``-th token produced is replaced by its successor."""
    one, every = engine_cls._sample_one, engine_cls._sample_all
    calls = {"n": 0}

    def alter(tok, vocab):
        calls["n"] += 1
        return (tok + 1) % vocab if calls["n"] % period == 0 else tok

    def sample_one(self, seq, logits):
        return alter(int(one(self, seq, logits)), logits.shape[-1])

    def sample_all(self, logits):
        toks = every(self, logits).clone()
        slot = next(iter(self._active))
        toks[slot] = alter(int(toks[slot]), logits.shape[-1])
        return toks
    return sample_one, sample_all


def plant(name: str, setattr_=setattr):
    """Plant the serving fault ``name`` (``state_unchanged``,
    ``half_batch``, ``token_altered``) with ``setattr_``."""
    from ant_ray_tpu_torch.llm.engine import LLMEngine
    from ant_ray_tpu_torch.models import llama

    if name == "state_unchanged":
        setattr_(llama, "decode_step", frozen_decode(llama))
    elif name == "half_batch":
        setattr_(llama, "decode_step", half_batch_decode(llama))
    elif name == "token_altered":
        one, every = altered_sampling(LLMEngine)
        setattr_(LLMEngine, "_sample_one", one)
        setattr_(LLMEngine, "_sample_all", every)
    else:
        raise ValueError(f"no fault {name!r}")
