"""Offline batch inference over Datasets (counterpart of
ant_ray_tpu/llm/batch.py; capability mirror of the reference's
``ray.data.llm`` batch stages, ref: llm/_internal/batch/stages/
vllm_engine_stage.py).

``build_llm_processor`` returns a Dataset→Dataset callable that routes
every block through actor-held engines, so model weights load once per
actor rather than once per block.  ``build_logprob_processor`` scores
pre-tokenized rows in the calling process, fed through the device feed
(data/device_feed.py).
"""

from __future__ import annotations

from ant_ray_tpu_torch.llm.sampling import SamplingParams


class _EngineActor:
    """One actor's engine: a Dataset block of rows in, the same rows
    with the generated text out."""

    def __init__(self, model, slots, max_seq, sampling, prompt_key,
                 output_key, device):
        from ant_ray_tpu_torch.llm.engine import LLMEngine  # noqa: PLC0415

        self.engine = LLMEngine(model, slots=slots, max_seq=max_seq,
                                device=device)
        self._sampling = sampling
        self._prompt_key = prompt_key
        self._output_key = output_key
        self._kept = None       # token ids a block, once _token_ids() asks

    def run(self, rows: list) -> list:
        outs = self.engine.generate(
            [r[self._prompt_key] for r in rows], self._sampling)
        if self._kept is not None:
            self._kept.append([list(out.token_ids) for out in outs])
        return [{**row, self._output_key: out.text}
                for row, out in zip(rows, outs)]

    def _token_ids(self, keep: bool = True) -> list:
        """The generated token ids of the blocks this actor ran since
        the last call (a list of rows a block, in the order it ran
        them), and whether to go on keeping them: off until a first
        call, so a long job holds none."""
        kept, self._kept = self._kept, ([] if keep else None)
        return kept or []

    def _launches(self) -> dict:
        """This process's flash-kernel launch counters (ops/
        flash_attention.py), by name."""
        from ant_ray_tpu_torch.ops import flash_attention as fa  # noqa: PLC0415

        return {name: getattr(fa, name) for name in dir(fa)
                if name.endswith("launch_count")}


def build_llm_processor(model="tiny", *, concurrency: int = 1,
                        slots: int = 8, max_seq: int | None = None,
                        sampling: SamplingParams | None = None,
                        prompt_key: str = "prompt",
                        output_key: str = "generated_text", device=None):
    """rows: dicts with ``prompt_key`` → adds ``output_key``.  Each of
    the ``concurrency`` actors holds one ``LLMEngine`` on ``device``
    (None: the current CUDA device; ``"cpu"`` runs on the CPU)."""
    import ant_ray_tpu_torch as art  # noqa: PLC0415

    sampling = sampling or SamplingParams()
    engine_actor = art.remote(_EngineActor)
    actors = [engine_actor.remote(model, slots, max_seq, sampling,
                                  prompt_key, output_key, device)
              for _ in range(concurrency)]

    def process(dataset):
        blocks = dataset.materialize()._block_refs
        out_refs = [actors[i % concurrency].run.remote(block)
                    for i, block in enumerate(blocks)]
        from ant_ray_tpu_torch.data.dataset import Dataset  # noqa: PLC0415

        return Dataset(out_refs)

    process._actors = actors
    return process


def build_logprob_processor(model="tiny", *, batch_size: int = 8,
                            prefetch_batches: int = 2,
                            max_len: int | None = None,
                            token_key: str = "tokens",
                            output_key: str = "nll",
                            pad_id: int = 0, sharding=None, seed: int = 0):
    """Batch scoring (per-row mean next-token NLL) over pre-tokenized
    rows, fed through the device-feed iterator
    (``DataIterator.iter_device_batches``): a producer thread pads each
    batch to a fixed ``(batch_size, max_len)`` shape and copies batch
    N+1 to the card on a side stream while the forward for batch N
    runs — the same copy/compute overlap the Train ingest path gets.

    ``model`` is what ``checkpoint.resolve_model`` reads: a named
    config, a ``LlamaConfig`` or a checkpoint directory.  ``sharding`` is
    the device the weights load on and the batches go to (None: the
    current CUDA device; ``"cpu"`` for the CPU), or a NamedSharding that
    lays the batches out over a mesh (the weights then on its first
    cell's device).  The
    forward runs over ``tokens[:, :-1]``, as the reference's does: at
    ``max_len - 1`` tokens ``attention(impl="auto")`` takes blockwise
    attention (its multiple-of-128 rule), so this path runs no flash
    kernel.

    rows: dicts with ``token_key`` → list of token ids.  Returns a
    Dataset→Dataset callable producing rows ``{"row": i, output_key:
    nll_per_token}`` aligned with the input order (the feed's
    ``tail_padded_rows`` stat trims the padded tail).
    """
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415
    import torch.nn.functional as F  # noqa: PLC0415

    from ant_ray_tpu_torch.data.device_feed import resolve_placement  # noqa: PLC0415
    from ant_ray_tpu_torch.models import checkpoint as ckpt  # noqa: PLC0415
    from ant_ray_tpu_torch.models import llama  # noqa: PLC0415
    from ant_ray_tpu_torch.parallel.spmd import ShardedTensor  # noqa: PLC0415

    placement = resolve_placement(sharding)
    # A mesh's batches arrive as ShardedTensors; the weights sit on its
    # first cell's device, where each batch is assembled.
    device = getattr(placement, "mesh", None)
    device = device.cell_devices[0] if device is not None else placement
    loaded, config, _ = ckpt.resolve_model(model, device)
    if loaded is not None:
        params = loaded
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama.init_params(config, generator=gen, device=device)
    seq = min(max_len or 128, config.max_seq)

    @torch.inference_mode()
    def _nll(tokens):
        tokens = (tokens.full() if isinstance(tokens, ShardedTensor)
                  else tokens).long()
        mask = (tokens != pad_id).float()
        logits = llama.forward(params, tokens[:, :-1], config)
        losses = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            tokens[:, 1:].reshape(-1),
            reduction="none").view(tokens.shape[0], -1)
        m = mask[:, 1:]
        return (losses * m).sum(-1) / m.sum(-1).clamp_min(1.0)

    def collate(batch):
        """numpy batch → one dense (n, seq) int32 token array (rows
        truncated/padded to seq; list-block dict rows supported)."""
        if isinstance(batch, dict) and token_key in batch:
            col = list(batch[token_key])
        else:
            col = [r[token_key] for r in batch.get("value", [])]
        out = np.full((len(col), seq), pad_id, np.int32)
        for i, ids in enumerate(col):
            ids = list(ids)[:seq]
            out[i, :len(ids)] = ids
        return {"tokens": out}

    def process(dataset):
        it = dataset.iterator()
        nlls = []
        for batch in it.iter_device_batches(
                batch_size, prefetch_batches=prefetch_batches,
                sharding=placement, collate_fn=collate, pad_value=pad_id):
            nlls.append(_nll(batch["tokens"]).cpu().numpy())
        feed = it.stats()["device_feed"]
        n_valid = feed["batches"] * batch_size - feed["tail_padded_rows"]
        flat = (np.concatenate(nlls)[:n_valid] if nlls
                else np.zeros((0,), np.float32))
        from ant_ray_tpu_torch.data.dataset import from_items  # noqa: PLC0415

        return from_items(
            [{"row": i, output_key: float(v)} for i, v in enumerate(flat)])

    return process
