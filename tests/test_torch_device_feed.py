"""The port's device feed (data/device_feed.py) against the JAX
package's: each scenario of tests/test_device_feed.py runs through both
packages, each in its own cluster, with the port's feed on the CPU
(``sharding="cpu"``: CPU tensors, nothing pinned) beside the
reference's on JAX's CPU devices; batch counts, shapes, values and the
feed's stats must be equal.  The reference's mesh test
(``test_sharded_device_put_under_mesh``) lays batches out over a mesh
of 4 CPU cells (parallel.NamedSharding) beside the reference's 4
virtual CPU devices.

``build_logprob_processor`` runs against the reference's on one HF
directory of seeded fp32 weights: row order equal, NLL within
``NLL_TOL`` (both forwards in fp32 on the CPU over the same weights;
sums in another order differ by a few fp32 ulps of the logits).

The card's path — pinned host buffers, copies on the feed's side
stream, the consumer's stream waiting on each copy's event — is
``test_pinned_side_stream_feed_on_the_card`` (marked ``gpu``; it skips
without a card).  This module imports the JAX package only inside the
CPU scenarios, so on the card's machine, which has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_device_feed.py
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import ant_ray_tpu_torch as tart
import ant_ray_tpu_torch.data as tdata
from ant_ray_tpu_torch.data import device_feed as tfeed

# |NLL(port) - NLL(reference)| per row, fp32 forwards of a 2-layer model
# on the CPU: the reading is 4.77e-7, one fp32 ulp of NLLs between 4 and
# 8; the bound allows 20 such ulps.
NLL_TOL = 1e-5

DIMS = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 128, "max_position_embeddings": 128,
        "torch_dtype": "float32"}


def write_model_dir(path, seed=0):
    """config.json and a model.safetensors of seeded fp32 weights in the
    HF layout ((out, in) projections scaled by 1/sqrt(in))."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, f, v = (DIMS[k] for k in ("hidden_size", "intermediate_size",
                                 "vocab_size"))
    kv = d // DIMS["num_attention_heads"] * DIMS["num_key_value_heads"]

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
            np.float32)

    state = {"model.embed_tokens.weight": w(v, d), "lm_head.weight": w(v, d),
             "model.norm.weight": np.ones(d, np.float32)}
    for i in range(DIMS["num_hidden_layers"]):
        for name, shape in (("self_attn.q_proj", (d, d)),
                            ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)),
                            ("self_attn.o_proj", (d, d)),
                            ("mlp.gate_proj", (f, d)),
                            ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            state[f"model.layers.{i}.{name}.weight"] = w(*shape)
        for name in ("input_layernorm", "post_attention_layernorm"):
            state[f"model.layers.{i}.{name}.weight"] = np.ones(d, np.float32)
    (path / "config.json").write_text(json.dumps(DIMS))
    save_file(state, str(path / "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def clusters():
    import ant_ray_tpu as jart

    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _jax_package():
    import ant_ray_tpu as jart
    import ant_ray_tpu.data as jdata

    return jart, jdata


def _both(scenario):
    """``scenario(art, data, placement)`` through the JAX package (its
    default device), then the port (``"cpu"``); returns (want, got)."""
    jart, jdata = _jax_package()
    return (scenario(jart, jdata, None), scenario(tart, tdata, "cpu"))


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------- tentpole


def test_device_batches_fixed_shapes_and_padding(clusters):
    """100 rows / batch 16 → 7 batches, ALL shaped (16,): the tail pads
    so a step never sees a second shape."""
    def scenario(art, data, placement):
        it = data.range(100, parallelism=4).iterator()
        batches = list(it.iter_device_batches(
            batch_size=16, prefetch_batches=2, sharding=placement))
        stats = it.stats()["device_feed"]
        return ([tuple(b["value"].shape) for b in batches],
                np.concatenate([_np(b["value"]) for b in batches]).tolist(),
                stats["batches"], stats["tail_padded_rows"])

    want, got = _both(scenario)
    assert got == want
    shapes, vals, n_batches, padded = got
    assert shapes == [(16,)] * 7 and n_batches == 7
    assert padded == 7 * 16 - 100
    counts = np.bincount(vals, minlength=100)
    assert counts[0] == 1 + padded and all(counts[1:100] == 1)
    it = tdata.range(20, parallelism=2).iterator()
    assert all(isinstance(b["value"], torch.Tensor)
               and b["value"].device.type == "cpu"
               for b in it.iter_device_batches(batch_size=8,
                                               sharding="cpu"))


def test_device_batches_dict_rows_explode_to_columns(clusters):
    def scenario(art, data, placement):
        ds = data.from_items([{"x": i, "y": 2.0 * i} for i in range(20)],
                             parallelism=2)
        batches = list(ds.iterator().iter_device_batches(
            batch_size=8, prefetch_batches=1, sharding=placement))
        return [{k: (tuple(v.shape), _np(v).tolist())
                 for k, v in sorted(b.items())} for b in batches], \
            {k: str(_np(v).dtype) for k, v in batches[0].items()}

    (want, jax_dtypes), (got, dtypes) = _both(scenario)
    assert got == want
    assert len(got) == 3 and sorted(got[0]) == ["x", "y"]
    assert all(b["x"][0] == (8,) and b["y"][0] == (8,) for b in got)
    # JAX without x64 narrows 64-bit columns; the port keeps numpy's.
    assert jax_dtypes == {"x": "int32", "y": "float32"}
    assert dtypes == {"x": "int64", "y": "float64"}


def test_prefetch_overlap_reduces_consumer_starvation(clusters):
    """With prefetch≥2 the producer's block-pull + collate + copy hide
    behind the consumer's (simulated) step, so the starve fraction drops
    strictly below the prefetch=0 baseline, which pays production on
    the critical path.  Each setting's fraction is the least of three
    alternating epochs (~0.15 s each), so that one scheduler stall of a
    loaded host does not decide the comparison."""
    def scenario(art, data, placement):
        def run(prefetch):
            it = data.range(2048, parallelism=4).iterator()
            for _ in it.iter_device_batches(batch_size=128,
                                            prefetch_batches=prefetch,
                                            sharding=placement):
                time.sleep(0.008)          # simulated train_step
            return it.stats()["device_feed"]

        run(2)                             # warmup (plan + device init)
        epochs = [(run(0), run(2)) for _ in range(3)]
        base, overlapped = epochs[-1]
        return (min(o["consumer_starve_fraction"] for _, o in epochs)
                < min(b["consumer_starve_fraction"] for b, _ in epochs),
                [(s["batches"], s["consumer_wall_s"] > 0,
                  s["block_wait_s"] >= 0, s["collate_s"] >= 0,
                  s["transfer_issue_s"] >= 0) for s in (base, overlapped)],
                sorted(base) == sorted(overlapped))

    want, got = _both(scenario)
    assert got == want == (True, [(16, True, True, True, True)] * 2, True)


def test_placement_over_several_devices_raises_and_callable_resolves(
        clusters):
    """A placement over several devices is a NamedSharding of the port's
    mesh: a plain list of devices, or the JAX package's NamedSharding,
    raises.  A callable placement is called as (rank, world) lazily in
    the consuming process, in both packages."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    foreign = NamedSharding(Mesh(np.array(jax.devices()[:4]), ("dp",)),
                            P("dp"))
    for several, error in ((["cuda:0", "cuda:1"], ValueError),
                           (foreign, TypeError)):
        it = tdata.range(64, parallelism=4).iterator()
        with pytest.raises(error):
            next(it.iter_device_batches(batch_size=16, sharding=several))

    def scenario(art, data, placement):
        seen = {}
        one = placement if placement else jax.devices()[0]

        def make(rank, world):
            seen["rank_world"] = (rank, world)
            return one

        it = data.range(32, parallelism=2).iterator()
        batches = list(it.iter_device_batches(
            batch_size=16, prefetch_batches=2, sharding=make))
        return seen["rank_world"], [_np(b["value"]).tolist()
                                    for b in batches]

    want, got = _both(scenario)
    assert got == want
    assert got[0] == (0, 1) and len(got[1]) == 2


def test_sharded_device_put_under_mesh(clusters):
    """Twin of tests/test_device_feed.py's: batches land already laid out
    over the caller's mesh, and a callable sharding resolves in the
    consuming process.  The port's mesh is 4 CPU cells of one device (a
    virtual mesh), so where the reference counts 4 distinct devices in
    ``device_set`` this counts the mesh's cells and the batch's shards;
    the values each cell holds equal the block its JAX device holds."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ant_ray_tpu_torch import parallel

    jsharding = NamedSharding(Mesh(np.array(jax.devices()[:4]), ("dp",)),
                              P("dp"))
    tsharding = parallel.NamedSharding(
        parallel.Mesh(np.array(["cpu"] * 4), ("dp",)),
        parallel.PartitionSpec("dp"))

    def scenario(art, data, sharding):
        seen = {}

        def make(rank, world):
            seen["rank_world"] = (rank, world)
            return sharding

        out = []
        for placement in (sharding, make):
            it = data.range(64 if placement is sharding else 32,
                            parallelism=4).iterator()
            batches = list(it.iter_device_batches(
                batch_size=16, prefetch_batches=2, sharding=placement))
            assert all(b["value"].sharding == sharding for b in batches)
            out.append([[np.asarray(block).tolist() for block in (
                [s.data for s in b["value"].addressable_shards]
                if hasattr(b["value"], "addressable_shards")
                else b["value"].shards)] for b in batches])
        return seen["rank_world"], out

    jart, jdata = _jax_package()
    want = scenario(jart, jdata, jsharding)
    got = scenario(tart, tdata, tsharding)
    assert got == want
    assert got[0] == (0, 1) and len(got[1][0]) == 4
    it = tdata.range(64, parallelism=4).iterator()
    batch = next(it.iter_device_batches(batch_size=16,
                                        sharding=tsharding))["value"]
    assert isinstance(batch, parallel.ShardedTensor)
    assert tsharding.mesh.size == len(batch.shards) == 4
    assert [tuple(s.shape) for s in batch.shards] == [(4,)] * 4
    assert tsharding.device_set == {torch.device("cpu")}


def test_producer_thread_shuts_down_on_early_consumer_exit(clusters):
    def scenario(art, data, placement):
        it = data.range(4096, parallelism=8).iterator()
        gen = it.iter_device_batches(batch_size=32, prefetch_batches=2,
                                     sharding=placement)
        next(gen)
        gen.close()                        # consumer bails mid-epoch
        thread = it._last_device_feed.thread
        deadline = time.monotonic() + 10
        while thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        return thread.is_alive()

    want, got = _both(scenario)
    assert got == want is False, "device-feed producer leaked"


def test_configure_device_feed_defaults_and_overrides(clusters):
    def scenario(art, data, placement):
        it = data.range(32, parallelism=2).iterator()
        it.configure_device_feed(batch_size=8, prefetch_batches=0,
                                 sharding=placement)
        first = len(list(it.iter_device_batches()))
        prefetch = it.stats()["device_feed"]["prefetch_batches"]
        # Explicit call-site arguments beat configured defaults.
        second = len(list(it.iter_device_batches(batch_size=16)))
        return first, prefetch, second, \
            it.stats()["device_feed"]["batch_size"]

    want, got = _both(scenario)
    assert got == want == (4, 0, 2, 16)


def test_producer_error_propagates_to_consumer(clusters):
    def scenario(art, data, placement):
        ds = data.range(64, parallelism=2).map(
            lambda r: (_ for _ in ()).throw(ValueError("bad row")))
        it = ds.iterator()
        with pytest.raises(Exception, match="bad row") as info:
            list(it.iter_device_batches(batch_size=8, prefetch_batches=2,
                                        sharding=placement))
        return "bad row" in str(info.value)

    want, got = _both(scenario)
    assert got == want is True


def test_collate_and_pad_equal_the_reference():
    from ant_ray_tpu.data import device_feed as jfeed

    batches = [{"value": np.arange(5)},
               {"value": np.array([{"a": 1, "b": 2.5}, {"a": 3, "b": 4.0}],
                                  dtype=object)},
               [1, 2, 3]]
    for batch in batches:
        want = jfeed.default_collate(batch)
        got = tfeed.default_collate(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        (pw, nw), (pg, ng) = (jfeed.pad_to_batch(want, 8, -1),
                              tfeed.pad_to_batch(got, 8, -1))
        assert ng == nw
        for k in pw:
            np.testing.assert_array_equal(pg[k], pw[k])
    ragged = {"value": np.array([[1, 2], [3]], dtype=object)}
    for mod in (jfeed, tfeed):
        with pytest.raises(TypeError, match="not dense"):
            mod.default_collate(ragged)


# ------------------------------------------- llm batch inference feed


def test_llm_logprob_processor_streams_device_batches(clusters,
                                                      tmp_path_factory):
    from ant_ray_tpu.llm import build_logprob_processor as jbuild
    from ant_ray_tpu_torch.llm import build_logprob_processor

    model = write_model_dir(tmp_path_factory.mktemp("logprob"))
    rng = np.random.RandomState(0)
    rows = [{"tokens": rng.randint(1, 250, size=rng.randint(4, 24))
             .tolist()} for _ in range(6)]
    jart, jdata = _jax_package()
    outs = []
    for build, art, data, kw in (
            (jbuild, jart, jdata, {}),
            (build_logprob_processor, tart, tdata, {"sharding": "cpu"})):
        process = build(model, batch_size=4, prefetch_batches=2, max_len=32,
                        **kw)
        ds = data.from_items(rows, parallelism=2)
        outs.append(sorted(process(ds).take_all(), key=lambda r: r["row"]))
    want, got = outs
    assert [r["row"] for r in got] == [r["row"] for r in want] == \
        list(range(6))
    assert all(np.isfinite(r["nll"]) and r["nll"] > 0 for r in got)
    err = max(abs(g["nll"] - w["nll"]) for g, w in zip(got, want))
    assert err <= NLL_TOL, err


# -------------------------------------- stale-epoch error regression


def test_streaming_split_retry_after_epoch_error_starts_clean(
        clusters, tmp_path):
    """An epoch that fails must not leak its error into the NEXT epoch:
    a rank arriving early at the retry barrier must not see the stale
    failure."""
    def scenario(art, data, placement):
        flag = str(tmp_path / f"failed_once_{art.__name__}")

        def boom_once(row):
            if not os.path.exists(flag):
                with open(flag, "w"):
                    pass
                raise ValueError("boom-once")
            return row

        its = data.range(32, parallelism=4).map(boom_once).streaming_split(
            2, equal=True)

        def consume(it, delay, out, errors):
            time.sleep(delay)
            try:
                for batch in it.iter_batches(batch_size=8,
                                             batch_format="rows"):
                    out.extend(batch)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def epoch(delays, outs):
            errors: list = []
            threads = [threading.Thread(target=consume,
                                        args=(its[i], delays[i], outs[i],
                                              errors))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            return errors

        errs0 = epoch((0.0, 0.0), [[], []])
        outs = [[], []]
        errs1 = epoch((0.0, 1.0), outs)        # staggered retry
        return (len(errs0), all("boom-once" in repr(e) for e in errs0),
                [repr(e) for e in errs1], sorted(outs[0] + outs[1]))

    want, got = _both(scenario)
    assert got == want == (2, True, [], list(range(32)))


# ------------------------------------------------------ the card's path


@pytest.mark.gpu
def test_pinned_side_stream_feed_on_the_card(monkeypatch):
    """On CUDA the feed copies from pinned buffers on its own stream:
    batches equal the collated host batches bitwise, with and without
    prefetch, even with the side stream's copies held back on the card
    (a refilled buffer would show); every copy's event is waited on by
    the consumer's stream; every copy to the card reads pinned
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the feed's CUDA path has no CPU "
                    "mode")
    recorded, waited, pinned = [], [], []
    record, wait_event = torch.cuda.Event.record, torch.cuda.Stream.wait_event
    pin_memory = torch.Tensor.pin_memory
    to_device = tfeed.DeviceFeed._to_device
    feeds = []

    def spy_record(self, stream=None):
        recorded.append(self)
        return record(self, stream)

    def spy_wait(self, event):
        waited.append((self, event))
        return wait_event(self, event)

    def spy_pin(self, *args, **kwargs):
        out = pin_memory(self, *args, **kwargs)
        pinned.append(out)
        return out

    def slow_copies(self, tree):
        if self not in feeds:
            feeds.append(self)
        with torch.cuda.stream(self._stream):
            torch.cuda._sleep(2_000_000)       # ~1 ms of spin per batch
        return to_device(self, tree)

    monkeypatch.setattr(torch.cuda.Event, "record", spy_record)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", spy_wait)
    monkeypatch.setattr(tfeed.DeviceFeed, "_to_device", slow_copies)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    rows = [{"x": np.arange(i, i + 64, dtype=np.int32), "y": 0.5 * i}
            for i in range(100)]
    tart.init(local_mode=True)
    try:
        ds = tdata.from_items(rows, parallelism=4)
        host = [tfeed.pad_to_batch(tfeed.default_collate(b), 16)[0]
                for b in ds.iter_batches(batch_size=16,
                                         batch_format="numpy")]
        for prefetch in (2, 0):
            it = ds.iterator()
            got = list(it.iter_device_batches(
                batch_size=16, prefetch_batches=prefetch, sharding="cuda"))
            torch.cuda.synchronize()
            assert len(got) == len(host) == 7
            for g, h in zip(got, host):
                assert sorted(g) == sorted(h)
                for k in h:
                    assert g[k].device.type == "cuda"
                    assert np.array_equal(g[k].cpu().numpy(), h[k])
                    assert g[k].dtype == torch.from_numpy(h[k]).dtype
    finally:
        tart.shutdown()
    consumer = torch.cuda.current_stream()
    waited_ids = {id(e) for s, e in waited if s == consumer}
    assert recorded and all(id(e) in waited_ids for e in recorded)
    assert len(pinned) == 2 * 7 * 2 and all(t.is_pinned() for t in pinned)
    assert all(s != consumer for s in {f._stream for f in feeds})
