"""Data→Train ingest in the port (``datasets=`` on ``TorchTrainer``,
``train.get_dataset_shard``, coordinated ``streaming_split``) against
the JAX package's: the twins of tests/test_train_data.py's ``:98``
(streaming shards), ``:142`` (a broadcast dataset), ``:165`` (a dead
rank's shard reassigned), ``:216`` (the device feed, forwarded from
``DataConfig.device_feed``) and ``:266`` (an unknown name), each run in
a cluster of each package with the reference's assertions; outcomes
equal.  The port's device feed puts batches on the device its
``sharding`` names — the host here (``"cpu"``), where the reference's
lands on its jax devices."""

import importlib

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart


@pytest.fixture(scope="module")
def clusters():
    jart.init(num_cpus=4, num_tpus=0)
    try:
        tart.init(num_cpus=4, num_tpus=0)
        try:
            yield
        finally:
            tart.shutdown()
    finally:
        jart.shutdown()


def _both(scenario, tmp_path_factory):
    out = []
    for art in (jart, tart):
        train = importlib.import_module(f"{art.__name__}.train")
        data = importlib.import_module(f"{art.__name__}.data")
        trainer = getattr(train, "JaxTrainer", None) or train.TorchTrainer
        out.append(scenario(art, train, data, trainer, str(
            tmp_path_factory.mktemp(art.__name__))))
    return tuple(out)


class Sink:
    def __init__(self):
        self._d = {}

    def put(self, key, rank, rows):
        self._d.setdefault(key, {})[rank] = rows
        return True

    def get(self):
        return self._d


# -------------------------------------------- tests/test_train_data.py :98

def test_trainer_datasets_streaming_shards(clusters, tmp_path_factory):
    def scenario(art, train, data, Trainer, storage):
        ds = data.range(64, parallelism=8)

        def loop(config):
            shard = train.get_dataset_shard("train")
            seen = []
            for batch in shard.iter_batches(batch_size=8,
                                            batch_format="rows"):
                seen.extend(batch)
            art.get(config["sink"].put.remote(0, train.get_world_rank(),
                                              seen))
            train.report({"rows": len(seen)})

        sink = art.remote(Sink).remote()
        result = Trainer(
            loop, train_loop_config={"sink": sink},
            datasets={"train": ds},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="td1",
                                       storage_path=storage)).fit()
        assert result.error is None
        per_rank = art.get(sink.get.remote())[0]
        assert set(per_rank) == {0, 1}
        assert len(per_rank[0]) == len(per_rank[1]) == 32
        assert sorted(per_rank[0] + per_rank[1]) == list(range(64))
        art.kill(sink)
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------- tests/test_train_data.py :142

def test_trainer_broadcast_dataset_not_split(clusters, tmp_path_factory):
    def scenario(art, train, data, Trainer, storage):
        ds = data.range(16, parallelism=2)

        def loop(config):
            shard = train.get_dataset_shard("val")
            rows = list(shard.iter_rows())
            train.report({"rows": len(rows), "distinct": len(set(rows))})

        result = Trainer(
            loop, train_loop_config={}, datasets={"val": ds},
            dataset_config=train.DataConfig(datasets_to_split=[]),
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="td2",
                                       storage_path=storage)).fit()
        assert result.error is None
        assert result.metrics["rows"] == 16
        assert result.metrics["distinct"] == 16
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------- tests/test_train_data.py :165

def test_trainer_shard_reassigned_after_worker_death(clusters,
                                                     tmp_path_factory):
    def scenario(art, train, data, Trainer, storage):
        ds = data.range(32, parallelism=4)

        def loop(config):
            import os  # noqa: PLC0415

            ctx = train.get_context()
            shard = train.get_dataset_shard("train")
            seen = []
            for batch in shard.iter_batches(batch_size=8,
                                            batch_format="rows"):
                seen.extend(batch)
                if ctx.attempt == 0 and ctx.world_rank == 1:
                    os._exit(1)        # die mid-epoch, holding a shard
            art.get(config["sink"].put.remote(
                ctx.attempt, ctx.world_rank, seen))
            train.report({"rows": len(seen)})

        sink = art.remote(Sink).remote()
        result = Trainer(
            loop, train_loop_config={"sink": sink},
            datasets={"train": ds},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(
                name="td3", storage_path=storage,
                failure_config=train.FailureConfig(max_failures=1))).fit()
        assert result.error is None
        attempt1 = art.get(sink.get.remote())[1]
        assert set(attempt1) == {0, 1}
        assert sorted(attempt1[0] + attempt1[1]) == list(range(32))
        assert len(attempt1[0]) == len(attempt1[1]) == 16
        art.kill(sink)
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------- tests/test_train_data.py :216

def test_trainer_device_feed_end_to_end(clusters, tmp_path_factory):
    """The controller forwards DataConfig.device_feed (with each
    worker's rank/world) to each shard, and the step loop receives
    batches already on the device."""
    def scenario(art, train, data, Trainer, storage):
        ds = data.range(64, parallelism=8)
        port = art is tart

        def loop(config):
            if port:
                import torch  # noqa: PLC0415

                is_device_batch = lambda v: isinstance(v, torch.Tensor)  # noqa: E731
            else:
                from ant_ray_tpu._private.jax_utils import import_jax  # noqa: PLC0415

                jax = import_jax()
                is_device_batch = lambda v: isinstance(v, jax.Array)  # noqa: E731
            shard = train.get_dataset_shard("train")
            n = 0
            shapes = set()
            total = 0
            for batch in shard.iter_device_batches():
                assert is_device_batch(batch["value"])
                shapes.add(tuple(batch["value"].shape))
                total += int(batch["value"].sum())
                n += 1
            feed = shard.stats()["device_feed"]
            defaults = shard._device_feed_defaults or {}
            train.report({
                "batches": n, "distinct_shapes": len(shapes),
                "prefetch": feed["prefetch_batches"],
                "feed_rank": defaults.get("rank"),
                "feed_world": defaults.get("world")})

        feed = {"batch_size": 8, "prefetch_batches": 2}
        if port:
            feed["sharding"] = "cpu"      # the card's place in a GPU gang
        result = Trainer(
            loop, train_loop_config={}, datasets={"train": ds},
            dataset_config=train.DataConfig(device_feed=feed),
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="td5",
                                       storage_path=storage)).fit()
        assert result.error is None
        assert result.metrics["batches"] == 4
        assert result.metrics["distinct_shapes"] == 1
        assert result.metrics["prefetch"] == 2
        assert result.metrics["feed_rank"] == 0
        assert result.metrics["feed_world"] == 2
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------- tests/test_train_data.py :266

def test_get_dataset_shard_unknown_name_raises(clusters, tmp_path_factory):
    def scenario(art, train, data, Trainer, storage):
        def loop(config):
            train.get_dataset_shard("nope")

        trainer = Trainer(
            loop, train_loop_config={}, datasets={"train": data.range(4)},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="td4", storage_path=storage))
        with pytest.raises(Exception, match="nope") as ei:
            trainer.fit()
        return type(ei.value).__name__

    want, got = _both(scenario, tmp_path_factory)
    assert got == want
