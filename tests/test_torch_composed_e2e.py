"""Composed end-to-end twins of tests/test_composed_e2e.py: the train
controller, a slice reservation, a gloo collective group, a sharded
step and failure recovery in one run, in a ``Cluster`` of each package
in turn.  The JAX package runs the reference's own loop
(``_sharded_sgd_loop``: ``shard_map`` over four local devices); the
port runs its counterpart, the step sharded over a virtual mesh of four
CPU cells (``parallel/spmd.py``: ``split``, ``psum``), gradients summed
across ranks over the gloo group.  Both draw the same seeded batches, so
the slice run's final loss and weights agree to 1e-5 (fp32); the elastic
run's node loss lands at a step the host's timing decides, so there the
reference's assertions hold in each package and the step and world are
equal.  In the elastic run each step is paced (``STEP_S`` after each
report, in both packages): unpaced, the reference's ten toy steps end
before its poll for three checkpoints and the node's removal, and its
world never shrinks (ROADMAP §C, "Reference-side faults").  A removed
node's workers outlive its daemon by their liveness poll (three failed
polls 2 s apart, ``_private/worker_main.py``), so the steps left after
the removal must outlast that.

The reference's v4 ``2x2x2`` slices (8 chips, 2 hosts of 4) are held
against the port's gb200 ``2x4`` slices (8 cards, 2 hosts of 4): the
same geometry in GPU terms, with the labels ``gpu-pod-name``,
``gpu-worker-id``, ``gpu-generation``, ``gpu-pod-type`` and
``gpu-topology`` where the reference has their ``tpu-`` names (as
tests/test_torch_autoscaler.py maps them).

Both tests are ``slow``, as the reference's are; run them by hand:
``python -m pytest tests/test_torch_composed_e2e.py -m slow``."""

import os
import threading
import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart
from runtime_twins import mod
from test_composed_e2e import _sharded_sgd_loop as _jax_loop

TRUE_W = [1.0, -2.0, 3.0, 0.5]
STEP_S = 1.5        # the elastic run's pause after each step's report


def _paced(loop):
    """``loop`` with a pause of ``config["step_s"]`` after every
    ``train.report`` of its package (the loops look ``report`` up on the
    module at each call)."""
    def run(config):
        import importlib

        train = importlib.import_module(config["package"] + ".train")
        report = train.report

        def paced_report(*args, **kwargs):
            report(*args, **kwargs)
            time.sleep(config["step_s"])

        train.report = paced_report
        try:
            loop(config)
        finally:
            train.report = report

    return run


def _torch_loop(config):
    """The reference's loop in the port: each rank's step sharded over a
    virtual mesh of four CPU cells along ``data`` (each cell the mean
    gradient of its rows, summed over the axis with ``psum``), the
    gradient averaged across ranks over the gloo group, then SGD.

    The sum over the cells is the step the reference takes: its
    ``jax.lax.pmean`` of a gradient of ``w`` (replicated, ``P()``)
    inside ``shard_map`` gives the four shards' sum, four times the
    batch's mean gradient, on jax 0.9 (ROADMAP §C, "Reference-side
    faults")."""
    import torch

    from ant_ray_tpu_torch import train
    from ant_ray_tpu_torch.parallel import spmd
    from ant_ray_tpu_torch.parallel.mesh import Mesh
    from ant_ray_tpu_torch.util import collective as col

    ctx = train.get_context()
    world, rank = ctx.world_size, ctx.world_rank
    start = 0
    weights = np.zeros(4, np.float32)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_pytree()
        start = int(state["step"]) + 1
        weights = np.asarray(state["w"], np.float32)
    # A restarted gang's group must not meet attempt N-1's rendezvous.
    group = f"e2e-{config['run_tag']}-{world}-a{ctx.attempt}"
    col.init_collective_group(world, rank, backend="gloo",
                              group_name=group)
    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("data",))
    true_w = np.asarray(TRUE_W, np.float32)

    def local_grad(w, x, y):
        w = w.clone().requires_grad_(True)
        torch.mean((x @ w - y) ** 2).backward()
        return w.grad

    rng = np.random.default_rng(1234 + rank)
    for step in range(start, config["steps"]):
        x = rng.standard_normal((8, 4)).astype(np.float32)
        y = x @ true_w
        w = torch.from_numpy(weights)
        xs = spmd.split(torch.from_numpy(x), spmd.P("data"), mesh)
        ys = spmd.split(torch.from_numpy(y), spmd.P("data"), mesh)
        grad = spmd.psum([local_grad(w, xc, yc) for xc, yc in zip(xs, ys)],
                         mesh, "data")[0]
        # Cross-rank gradient allreduce (the DCN hop).
        grad = np.asarray(col.allreduce(grad, group_name=group)) / world
        weights = weights - 0.1 * grad.astype(np.float32)
        loss = float(np.mean((x @ weights - y) ** 2))
        train.report({"step": step, "loss": loss, "world": world},
                     checkpoint={"step": np.asarray(step),
                                 "w": weights, "loss": loss})
        if config.get("die_at") == step and \
                rank == 0 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)         # hard crash mid-run -> group restart


def _slice_cluster(art):
    """A 2-CPU head and two slices of two hosts, 4 accelerators each."""
    cluster = mod(art, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 2, "num_tpus": 0} if art is jart
        else {"num_cpus": 2})
    for slice_name in ("slice-A", "slice-B"):
        for host in range(2):
            if art is jart:
                cluster.add_node(
                    num_cpus=2, num_tpus=4,
                    labels={"tpu-pod-name": slice_name,
                            "tpu-worker-id": str(host),
                            "tpu-generation": "v4", "tpu-pod-type": "v4-8",
                            "tpu-topology": "2x2x2"})
            else:
                cluster.add_node(
                    num_cpus=2, num_gpus=4,
                    labels={"gpu-pod-name": slice_name,
                            "gpu-worker-id": str(host),
                            "gpu-generation": "gb200",
                            "gpu-pod-type": "gb200-8",
                            "gpu-topology": "2x4"})
    cluster.connect()
    return cluster


def _slice_run(art, tmp_path_factory):
    train = mod(art, "train")
    cluster = _slice_cluster(art)
    try:
        marker = str(tmp_path_factory.mktemp("m") / "died")
        if art is jart:
            trainer_cls, loop = train.JaxTrainer, _jax_loop
            scaling = train.ScalingConfig(
                num_workers=2, use_tpu=True, topology="2x2x2",
                accelerator_type="TPU-V4", chips_per_worker=4)
        else:
            trainer_cls, loop = train.TorchTrainer, _torch_loop
            scaling = train.ScalingConfig(
                num_workers=2, use_gpu=True, topology="2x4",
                accelerator_type="GB200")
        result = trainer_cls(
            loop,
            train_loop_config={"steps": 8, "die_at": 3,
                               "marker": marker, "run_tag": "slice"},
            scaling_config=scaling,
            run_config=train.RunConfig(
                name="composed-slice",
                storage_path=str(tmp_path_factory.mktemp("train")),
                failure_config=train.FailureConfig(max_failures=2))).fit()
        assert result.error is None, result.error
        assert result.metrics["step"] == 7
        assert result.metrics["world"] == 2      # slice gang: fixed size
        assert os.path.exists(marker), "the crash never happened"
        # The loss kept falling across the restart.
        assert float(result.metrics["loss"]) < 0.5
        w = np.asarray(result.checkpoint.to_pytree()["w"], np.float32)
        np.testing.assert_allclose(w, TRUE_W, atol=0.35)
        return (result.metrics["step"], result.metrics["world"],
                float(result.metrics["loss"]), w)
    finally:
        art.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_slice_train_collective_restart_composed(tmp_path_factory):
    """Slice reservation + controller + gloo group + sharded step + group
    restart after a worker crash at step 3: the gang re-reserves, resumes
    from the checkpoint, and the loss keeps falling across the restart."""
    want, got = (_slice_run(art, tmp_path_factory) for art in (jart, tart))
    assert got[:2] == want[:2] == (7, 2)
    assert got[2] == pytest.approx(want[2], abs=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)


def _elastic_run(art, tmp_path_factory):
    train = mod(art, "train")
    cluster = mod(art, "cluster_utils").Cluster(
        head_node_args={"num_cpus": 2})
    second = cluster.add_node(num_cpus=2)
    cluster.connect()
    try:
        run_config = train.RunConfig(
            name="composed-elastic",
            storage_path=str(tmp_path_factory.mktemp("train")),
            failure_config=train.FailureConfig(max_failures=2))
        trainer_cls, loop = ((train.JaxTrainer, _jax_loop) if art is jart
                             else (train.TorchTrainer, _torch_loop))
        trainer = trainer_cls(
            _paced(loop),
            train_loop_config={"steps": 10, "run_tag": "elastic",
                               "marker": str(tmp_path_factory.mktemp("m2")
                                             / "unused"),
                               "package": art.__name__, "step_s": STEP_S},
            scaling_config=train.ScalingConfig(
                num_workers=2, min_workers=1,
                resources_per_worker={"CPU": 2.0}),
            run_config=run_config)
        box = {}
        thread = threading.Thread(target=lambda: box.update(
            result=trainer.fit()), daemon=True)
        thread.start()
        # Real progress of the 2-worker group, then a node's loss.
        store = run_config.resolved_storage_path()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            done = [d for d in (os.listdir(store)
                                if os.path.isdir(store) else [])
                    if d.startswith("checkpoint")]
            if len(done) >= 3:
                break
            time.sleep(0.5)
        else:
            raise AssertionError(f"{art.__name__}: no progress")
        cluster.remove_node(second)
        thread.join(timeout=180)
        assert not thread.is_alive(), "fit() wedged after node loss"
        result = box["result"]
        assert result.error is None, result.error
        assert result.metrics["world"] == 1       # the world shrank
        assert result.metrics["step"] == 9
        assert float(result.metrics["loss"]) < 0.5
        return result.metrics["step"], result.metrics["world"]
    finally:
        art.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_elastic_world_change_collective_composed(tmp_path_factory):
    """A node's loss shrinks the world from 2 to 1; the restarted group
    re-forms its collective at the new size, resumes from the checkpoint,
    and the loss keeps falling."""
    want, got = (_elastic_run(art, tmp_path_factory) for art in (jart, tart))
    assert got == want == (9, 1)
