"""The twin of tests/test_train_elastic.py:29: a node's loss mid-run
restarts the worker group with a smaller world (elastic), resuming from
the latest checkpoint, in a two-node ``Cluster`` of each package in
turn, the JAX package's ``JaxTrainer`` beside the port's
``TorchTrainer`` on the same loop.  The final step and world must be
equal.  ``slow``, as the reference is (its parked ranks sleep 30 s); run
it by hand: ``python -m pytest tests/test_torch_train_elastic.py -m
slow``."""

import os
import threading
import time

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import mod


def _loop(config):
    import importlib
    import time as _t

    train = importlib.import_module(config["package"] + ".train")
    ctx = train.get_context()
    start = 0
    if ctx.latest_checkpoint is not None:
        start = ctx.latest_checkpoint.to_pytree()["step"] + 1
    for step in range(start, 6):
        if step >= 2 and ctx.world_size > 1:
            _t.sleep(30)  # park until the node kill fails us
        train.report({"step": step, "world": ctx.world_size},
                     checkpoint={"step": step})


def _downscale(art, tmp_path_factory):
    train = mod(art, "train")
    cluster = mod(art, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 2})
    second = cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        run_config = train.RunConfig(
            name="elastic",
            storage_path=str(tmp_path_factory.mktemp("train")),
            failure_config=train.FailureConfig(max_failures=2))
        trainer_cls = getattr(train, "JaxTrainer", None) or \
            train.TorchTrainer
        trainer = trainer_cls(
            _loop, train_loop_config={"package": art.__name__},
            scaling_config=train.ScalingConfig(
                num_workers=2, min_workers=1,
                resources_per_worker={"CPU": 2.0}),
            run_config=run_config)
        box = {}
        # daemon: a wedged fit() fails the assert below, never the exit.
        thread = threading.Thread(target=lambda: box.update(
            result=trainer.fit()), daemon=True)
        thread.start()
        # The node dies once the group demonstrably runs (rank 0 reported
        # checkpoints 0 and 1): a kill during setup is another scenario.
        store = run_config.resolved_storage_path()
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            done = [d for d in (os.listdir(store)
                                if os.path.isdir(store) else [])
                    if d.startswith("checkpoint")]
            if len(done) >= 2:
                break
            time.sleep(0.5)
        else:
            raise AssertionError(f"{art.__name__}: never reached step 2")
        time.sleep(1.0)  # both ranks parked in the step-2 sleep
        cluster.remove_node(second)
        thread.join(timeout=120)
        assert not thread.is_alive(), "fit() never finished after node loss"
        result = box["result"]
        assert result.error is None
        # The restarted group ran with ONE worker and resumed, not from
        # step 0.
        assert result.metrics["world"] == 1
        assert result.metrics["step"] == 5
        return result.metrics["step"], result.metrics["world"]
    finally:
        art.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_elastic_downscale_after_node_loss(tmp_path_factory):
    want, got = (_downscale(art, tmp_path_factory) for art in (jart, tart))
    assert got == want == (5, 1)
