"""The port's train plane (``ant_ray_tpu_torch.train``: ``TorchTrainer``,
the controller, the session, the scaling policies) against the JAX
package's ``JaxTrainer``: the twins of tests/test_train.py's ``:27``,
``:46``, ``:63``, ``:97``, ``:115``, ``:133``, ``:165``, ``:222`` and
``:247`` — each scenario runs in a cluster of each package, keeps the
reference's assertions, and the outcomes must be equal — and two parity
tests on the same weights and tokens:

* the tiny-llama trainer (``:181``): the JAX package's ``tiny`` weights
  from PRNGKey(0) through ``models/convert.py``
  ``params_from_jax_numpy``, Adam at 1e-3, three steps in one worker of
  each package; the losses agree to 1e-5 (fp32);
* data parallelism: each package trains ``tiny`` on two ranks, each rank
  its own half of a seeded batch, gradients averaged with
  ``train.sync_gradients``, SGD at 0.1; each rank's per-step losses
  agree to 1e-5 and the final parameters to 1e-6 (fp32), and both
  ranks end with the same parameters.

Also: ``ScalingConfig(use_gpu=...)`` asks for GPUs where the JAX
package's ``use_tpu`` asked for chips (a whole-slice worker for all of
its host's cards), and a multi-rank GPU gang's loop sees
torch.distributed's env:// variables.  test_train_elastic.py's node-loss
scenario (parked ranks sleep 30 s) has no twin here."""

import importlib
import os

import numpy as np
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


def _train(art):
    return importlib.import_module(f"{art.__name__}.train")


def _trainer(art):
    train = _train(art)
    return getattr(train, "JaxTrainer", None) or train.TorchTrainer


def _both(scenario, tmp_path_factory):
    """The scenario's outcome in the JAX package, then in the port."""
    want = _retry_reference_race(lambda: scenario(
        jart, _train(jart), _trainer(jart),
        str(tmp_path_factory.mktemp(jart.__name__))))
    return want, scenario(tart, _train(tart), _trainer(tart),
                          str(tmp_path_factory.mktemp(tart.__name__)))


def _retry_reference_race(run):
    """``run()`` (the JAX package's side of a scenario), run once more
    where its gloo rendezvous lost the port it had picked to another
    process (``EADDRINUSE``: the race between its pick and its bind,
    ROADMAP §C, which the port's rendezvous does not have).  The rerun
    starts from a KV without the failed attempt's advertised address."""
    try:
        return run()
    except Exception as e:  # noqa: BLE001 — re-raised unless the race
        if "EADDRINUSE" not in str(e):
            raise
    from ant_ray_tpu._private.worker import global_worker

    gcs = global_worker.runtime._gcs
    for key in gcs.call("KVKeys", {"prefix": "collective:"}) or []:
        gcs.call("KVDel", {"key": key})
    return run()



# ------------------------------------------------ tests/test_train.py :27

def test_single_worker_reports_metrics(clusters, tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        def loop(config):
            ctx = train.get_context()
            assert ctx.world_size == 1
            for step in range(3):
                train.report({"step": step, "loss": 1.0 / (step + 1)})

        result = Trainer(
            loop, train_loop_config={},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="t1",
                                       storage_path=storage)).fit()
        assert result.error is None
        assert result.metrics["step"] == 2
        assert result.metrics["loss"] == pytest.approx(1 / 3)
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------------ tests/test_train.py :46

def test_multi_worker_ranks(clusters, tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        def loop():
            ctx = train.get_context()
            train.report({"rank": ctx.world_rank, "world": ctx.world_size,
                          "local": ctx.local_rank})

        result = Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="t2",
                                       storage_path=storage)).fit()
        assert result.metrics["rank"] == 0
        assert result.metrics["world"] == 2
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------------ tests/test_train.py :63

def test_sync_gradients_buckets_across_workers(clusters, tmp_path_factory):
    """Data-parallel gradient sync via the fused bucketed collective
    path: a 2-rank CPU gang averages a gradient pytree, lazily creating
    its gloo group."""
    def scenario(art, train, Trainer, storage):
        def loop():
            col = importlib.import_module(
                train.__name__.rsplit(".", 1)[0] + ".util.collective")
            ctx = train.get_context()
            grads = {"w": np.full((8, 4), float(ctx.world_rank + 1),
                                  np.float32),
                     "b": np.full((4,), float(ctx.world_rank), np.float32)}
            synced = train.sync_gradients(grads)
            w_ok = bool(np.allclose(np.asarray(synced["w"]), 1.5))
            b_ok = bool(np.allclose(np.asarray(synced["b"]), 0.5))
            stats = col.fusion_stats(
                f"train-sync-{ctx.experiment_name}-a{ctx.attempt}")
            train.report({"rank": ctx.world_rank, "w_ok": w_ok,
                          "b_ok": b_ok, "buckets": stats["buckets"],
                          "tensors": stats["tensors"],
                          "w": np.asarray(synced["w"]).tolist()})

        result = Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="tsync",
                                       storage_path=storage)).fit()
        assert result.error is None
        assert result.metrics["w_ok"] and result.metrics["b_ok"]
        assert result.metrics["tensors"] == 2
        assert result.metrics["buckets"] == 1
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ------------------------------------------------ tests/test_train.py :97

def test_sync_gradients_world1_is_identity(clusters, tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        def loop():
            grads = {"w": np.ones((3,), np.float32)}
            out = train.sync_gradients(grads)
            train.report({"same": out is grads})

        result = Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="tsync1",
                                       storage_path=storage)).fit()
        assert result.error is None
        assert result.metrics["same"] is True
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ----------------------------------------------- tests/test_train.py :115

def test_checkpoint_roundtrip(clusters, tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        def loop(config):
            params = {"w": np.arange(4.0), "step": np.asarray(7)}
            train.report({"done": 1}, checkpoint=params)

        result = Trainer(
            loop, train_loop_config={},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="t3",
                                       storage_path=storage)).fit()
        assert result.checkpoint is not None
        restored = result.checkpoint.to_pytree()
        np.testing.assert_array_equal(restored["w"], np.arange(4.0))
        assert int(restored["step"]) == 7
        return (np.asarray(restored["w"]).tolist(), int(restored["step"]),
                os.path.basename(result.checkpoint.path))

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


def test_torch_checkpoint_reported_from_a_rank(clusters, tmp_path_factory):
    """A pytree of torch tensors (bfloat16 among them) reported by a
    rank is saved by the controller and loads back bitwise."""
    import torch

    from ant_ray_tpu_torch import train

    def loop(config):
        import torch as _torch

        gen = _torch.Generator().manual_seed(3)
        tree = {"w": _torch.randn(5, 7, generator=gen).to(_torch.bfloat16),
                "opt": {"step": _torch.tensor(3.0), "lr": 1e-3,
                        "betas": (0.9, 0.999)}}
        train.report({"done": 1}, checkpoint=tree)

    result = train.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="t3t",
            storage_path=str(tmp_path_factory.mktemp("ckpt")))).fit()
    restored = result.checkpoint.to_pytree()
    gen = torch.Generator().manual_seed(3)
    want = torch.randn(5, 7, generator=gen).to(torch.bfloat16)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], want)
    assert restored["opt"]["lr"] == 1e-3
    assert restored["opt"]["betas"] == (0.9, 0.999)
    assert float(restored["opt"]["step"]) == 3.0


# ----------------------------------------------- tests/test_train.py :133

def test_failure_recovery_resumes_from_checkpoint(clusters,
                                                  tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        marker = os.path.join(storage, "marker")
        os.makedirs(marker)

        def loop(config):
            ckpt = train.get_checkpoint()
            start = 0
            if ckpt is not None:
                start = int(ckpt.to_pytree()["step"]) + 1
            for step in range(start, 4):
                train.report({"step": step, "start": start},
                             checkpoint={"step": np.asarray(step)})
                if step == 1 and not os.path.exists(
                        os.path.join(config["marker"], "died")):
                    open(os.path.join(config["marker"], "died"),
                         "w").close()
                    os._exit(1)  # simulate worker crash mid-training

        result = Trainer(
            loop, train_loop_config={"marker": marker},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                name="t4", storage_path=storage,
                failure_config=train.FailureConfig(max_failures=1))).fit()
        assert result.error is None
        assert result.metrics["step"] == 3
        return result.metrics

    want, got = _both(scenario, tmp_path_factory)
    # The restarted loop resumed at step 2, not 0, in both.
    assert got == want == {"step": 3, "start": 2}


# ----------------------------------------------- tests/test_train.py :165

def test_failure_exhausted_raises(clusters, tmp_path_factory):
    def scenario(art, train, Trainer, storage):
        def loop():
            os._exit(1)

        trainer = Trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                name="t5", storage_path=storage,
                failure_config=train.FailureConfig(max_failures=0)))
        with pytest.raises(Exception) as ei:
            trainer.fit()
        return type(ei.value).__name__

    want, got = _both(scenario, tmp_path_factory)
    assert got == want


# ----------------------------------------------- tests/test_train.py :222

def test_elastic_policy_sizes_group_to_capacity():
    """Unit: elastic policy fits the world to total capacity within
    [min, num_workers] (ref: scaling_policy/)."""
    from ant_ray_tpu.train import ScalingConfig as JScalingConfig
    from ant_ray_tpu.train.scaling_policy import policy_for as jpolicy_for
    from ant_ray_tpu_torch.train import ScalingConfig
    from ant_ray_tpu_torch.train.scaling_policy import (
        ElasticScalingPolicy,
        FixedScalingPolicy,
        policy_for,
    )

    for Scaling, pf in ((JScalingConfig, jpolicy_for),
                        (ScalingConfig, policy_for)):
        scaling = Scaling(num_workers=4, min_workers=2)
        policy = pf(scaling)
        assert type(policy).__name__ == "ElasticScalingPolicy"
        assert policy.workers_for_attempt(scaling, {}, {"CPU": 16.0}) == 4
        assert policy.workers_for_attempt(scaling, {}, {"CPU": 3.0}) == 3
        assert policy.workers_for_attempt(scaling, {}, {"CPU": 1.0}) == 2
        assert type(pf(Scaling(num_workers=4))).__name__ == \
            "FixedScalingPolicy"
    assert isinstance(policy_for(ScalingConfig(num_workers=4, min_workers=2)),
                      ElasticScalingPolicy)
    assert isinstance(policy_for(ScalingConfig(num_workers=4)),
                      FixedScalingPolicy)
    # Both refuse min_workers beside a whole-slice topology.
    with pytest.raises(ValueError, match="slice"):
        jpolicy_for(JScalingConfig(num_workers=4, min_workers=2,
                                   use_tpu=True, topology="2x4"))
    with pytest.raises(ValueError, match="slice"):
        policy_for(ScalingConfig(num_workers=4, min_workers=2, use_gpu=True,
                                 topology="2x4"))
    # GPU demand where the reference asked for chips; an explicit share
    # in resources_per_worker wins.
    assert ScalingConfig(use_gpu=True).worker_resources() == \
        {"GPU": 1.0, "CPU": 1.0}
    assert ScalingConfig(use_gpu=True, gpus_per_worker=2).worker_resources() \
        == {"GPU": 2.0, "CPU": 1.0}
    assert ScalingConfig(use_gpu=True, resources_per_worker={
        "CPU": 1, "GPU": 0.5}).worker_resources() == {"CPU": 1, "GPU": 0.5}
    assert ScalingConfig().worker_resources() == \
        JScalingConfig().worker_resources() == {"CPU": 1.0}
    assert JScalingConfig(use_tpu=True, chips_per_worker=4) \
        .worker_resources() == {"TPU": 4.0, "CPU": 1.0}
    # A whole-slice worker binds its host's cards, as chips_per_worker
    # binds a TPU host's chips (gb200 hosts 4 cards, as v4 hosts 4 chips).
    assert ScalingConfig(use_gpu=True, topology="2x2x2",
                         accelerator_type="GB200").worker_resources() == \
        {"GPU": 4.0, "CPU": 1.0}
    assert ScalingConfig(use_gpu=True, topology="2x4",
                         accelerator_type="H100").worker_resources() == \
        {"GPU": 8.0, "CPU": 1.0}
    assert ScalingConfig(accelerator_type="H100").worker_resources() == \
        {"CPU": 1.0}


# ----------------------------------------------- tests/test_train.py :247

def test_elastic_policy_converges_on_unplaceable_gangs():
    """Fragmented capacity: a failed reservation steps the next request
    down; a successful launch resets the learned cap."""
    from ant_ray_tpu.train import ScalingConfig as JScalingConfig
    from ant_ray_tpu.train.scaling_policy import (
        ElasticScalingPolicy as JElastic,
    )
    from ant_ray_tpu_torch.train import ScalingConfig
    from ant_ray_tpu_torch.train.scaling_policy import ElasticScalingPolicy

    for Scaling, Elastic in ((JScalingConfig, JElastic),
                             (ScalingConfig, ElasticScalingPolicy)):
        scaling = Scaling(num_workers=4, min_workers=2,
                          resources_per_worker={"CPU": 2.0})
        policy = Elastic(2)
        total = {"CPU": 6.0}
        assert policy.workers_for_attempt(scaling, {}, total) == 3
        policy.note_unplaceable(3)
        assert policy.workers_for_attempt(scaling, {}, total,
                                          attempt=1) == 2
        policy.note_group_started()
        assert policy.workers_for_attempt(scaling, {}, total) == 3


# ------------------------------------------------ a GPU gang's rendezvous

def test_gpu_gang_exports_torch_env_rendezvous(tmp_path):
    """A multi-rank GPU gang's ranks see MASTER_ADDR / MASTER_PORT /
    RANK / WORLD_SIZE / LOCAL_RANK (the counterpart of the reference's
    jax.distributed rendezvous); a CPU gang's do not."""
    from ant_ray_tpu_torch.train.controller import TrainWorker

    saved = {k: os.environ.get(k) for k in
             ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK")}
    try:
        cpu = TrainWorker(1, 2, str(tmp_path), "x", use_gpu=False)
        assert cpu.setup_distributed("10.0.0.1:1234") is False
        rank0 = TrainWorker(0, 2, str(tmp_path), "x", use_gpu=True)
        coordinator = rank0.propose_coordinator()
        host, port = coordinator.rsplit(":", 1)
        assert int(port) > 0
        gpu = TrainWorker(1, 2, str(tmp_path), "x", use_gpu=True)
        assert gpu.setup_distributed(coordinator, local_rank=1) is True
        assert (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"],
                os.environ["RANK"], os.environ["WORLD_SIZE"],
                os.environ["LOCAL_RANK"]) == (host, port, "1", "2", "1")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------- tests/test_train.py :181, parity

TOKENS = np.tile(np.arange(8), 9)[None, :65]


def test_train_tiny_llama_matches_the_jax_trainer(clusters,
                                                  tmp_path_factory):
    """The JaxTrainer driving the reference's tiny llama loop (Adam 1e-3,
    three steps, PRNGKey(0) weights), and the TorchTrainer driving the
    port's on the same weights through params_from_jax_numpy: losses to
    1e-5."""
    import jax

    from ant_ray_tpu.models import llama as jllama
    from ant_ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig
    from ant_ray_tpu_torch import train

    def jloop(config):
        import jax
        import jax.numpy as jnp
        import optax

        from ant_ray_tpu import train as jtrain
        from ant_ray_tpu.models import llama

        cfg = llama.CONFIGS["tiny"]
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        opt = optax.adam(1e-3)
        state = opt.init(params)
        tokens = jnp.asarray(config["tokens"], jnp.int32)

        @jax.jit
        def step(params, state):
            loss, grads = jax.value_and_grad(llama.loss_fn)(
                params, {"tokens": tokens}, cfg)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for i in range(3):
            params, state, loss = step(params, state)
            losses.append(float(loss))
            jtrain.report({"loss": float(loss), "step": i,
                           "losses": list(losses)})

    def tloop(config):
        import torch

        from ant_ray_tpu_torch import train as ttrain
        from ant_ray_tpu_torch.models import llama
        from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
        from ant_ray_tpu_torch.train.step import param_leaves

        cfg = llama.CONFIGS["tiny"]
        params = params_from_jax_numpy(config["params"], cfg, device="cpu")
        leaves = [p.requires_grad_() for p in param_leaves(params)]
        opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999),
                               eps=1e-8)
        tokens = torch.as_tensor(config["tokens"])
        losses = []
        for i in range(3):
            opt.zero_grad(set_to_none=True)
            loss = llama.loss_fn(params, {"tokens": tokens}, cfg)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            ttrain.report({"loss": loss.item(), "step": i,
                           "losses": list(losses)})

    want = JaxTrainer(
        jloop, train_loop_config={"tokens": TOKENS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="t6", storage_path=str(
            tmp_path_factory.mktemp("jax")))).fit()
    params = jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS["tiny"], jax.random.PRNGKey(0)))
    got = train.TorchTrainer(
        tloop, train_loop_config={"tokens": TOKENS, "params": params},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="t6", storage_path=str(
            tmp_path_factory.mktemp("torch")))).fit()
    assert want.error is None and got.error is None
    assert got.metrics["step"] == want.metrics["step"] == 2
    assert np.isfinite(got.metrics["loss"])
    np.testing.assert_allclose(got.metrics["losses"], want.metrics["losses"],
                               rtol=0, atol=1e-5)
    assert got.metrics["losses"][-1] < got.metrics["losses"][0]


def test_data_parallel_two_ranks_match_the_jax_trainer(clusters,
                                                       tmp_path_factory):
    """Two ranks of each package train tiny, each on its half of a
    seeded 4 x 33 batch, gradients averaged by train.sync_gradients, SGD
    at 0.1 for three steps: per-step losses of each rank to 1e-5, final
    parameters to 1e-6, and both ranks end equal."""
    import jax

    from ant_ray_tpu.models import llama as jllama
    from ant_ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig
    from ant_ray_tpu_torch import train

    tokens = np.random.default_rng(24).integers(0, 256, (4, 33))
    params = jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS["tiny"], jax.random.PRNGKey(1)))

    def jloop(config):
        import jax
        import jax.numpy as jnp

        from ant_ray_tpu import train as jtrain
        from ant_ray_tpu.models import llama

        ctx = jtrain.get_context()
        cfg = llama.CONFIGS["tiny"]
        params = jax.tree.map(jnp.asarray, config["params"])
        r = ctx.world_rank
        tokens = jnp.asarray(config["tokens"][2 * r:2 * r + 2], jnp.int32)
        grad_fn = jax.jit(lambda p: jax.value_and_grad(llama.loss_fn)(
            p, {"tokens": tokens}, cfg))
        losses = []
        for _ in range(3):
            loss, grads = grad_fn(params)
            grads = jtrain.sync_gradients(grads)
            params = jax.tree.map(lambda p, g: p - 0.1 * jnp.asarray(g),
                                  params, grads)
            losses.append(float(loss))
        final = jax.tree.map(lambda p: np.asarray(p).tolist(), params)
        with open(f"{config['out']}/jax{r}.json", "w") as f:
            import json

            json.dump({"losses": losses, "params": final}, f)
        jtrain.report({"losses": losses})

    def tloop(config):
        import json

        import torch

        from ant_ray_tpu_torch import train as ttrain
        from ant_ray_tpu_torch.models import llama
        from ant_ray_tpu_torch.models.convert import params_from_jax_numpy
        from ant_ray_tpu_torch.train.step import param_leaves

        ctx = ttrain.get_context()
        cfg = llama.CONFIGS["tiny"]
        params = params_from_jax_numpy(config["params"], cfg, device="cpu")
        leaves = [p.requires_grad_() for p in param_leaves(params)]
        opt = torch.optim.SGD(leaves, lr=0.1)
        r = ctx.world_rank
        tokens = torch.as_tensor(config["tokens"][2 * r:2 * r + 2])

        def grads_of(tree):
            return {k: grads_of(v) if isinstance(v, dict) else v.grad
                    for k, v in tree.items()}

        def set_grads(tree, grads):
            for k, v in tree.items():
                if isinstance(v, dict):
                    set_grads(v, grads[k])
                else:
                    v.grad = grads[k]

        losses = []
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            loss = llama.loss_fn(params, {"tokens": tokens}, cfg)
            loss.backward()
            set_grads(params, ttrain.sync_gradients(grads_of(params)))
            opt.step()
            losses.append(loss.item())

        def to_lists(tree):
            return {k: to_lists(v) if isinstance(v, dict)
                    else v.detach().numpy().tolist()
                    for k, v in tree.items()}

        with open(f"{config['out']}/torch{r}.json", "w") as f:
            json.dump({"losses": losses, "params": to_lists(params)}, f)
        ttrain.report({"losses": losses})

    out = tmp_path_factory.mktemp("dp")
    config = {"tokens": tokens, "params": params, "out": str(out)}
    want = _retry_reference_race(lambda: JaxTrainer(
        jloop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dp", storage_path=str(
            tmp_path_factory.mktemp("jax")))).fit())
    got = train.TorchTrainer(
        tloop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="dp", storage_path=str(
            tmp_path_factory.mktemp("torch")))).fit()
    assert want.error is None and got.error is None
    import json

    runs = {name: json.loads((out / f"{name}.json").read_text())
            for name in ("jax0", "jax1", "torch0", "torch1")}
    for r in (0, 1):
        np.testing.assert_allclose(runs[f"torch{r}"]["losses"],
                                   runs[f"jax{r}"]["losses"], rtol=0,
                                   atol=1e-5)
    assert runs["torch0"]["losses"][-1] < runs["torch0"]["losses"][0]
    jleaves = jax.tree.leaves(runs["jax0"]["params"],
                              is_leaf=lambda x: isinstance(x, list))
    for r in (0, 1):
        tleaves = jax.tree.leaves(runs[f"torch{r}"]["params"],
                                  is_leaf=lambda x: isinstance(x, list))
        assert len(tleaves) == len(jleaves)
        for t, j in zip(tleaves, jleaves):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j),
                                       rtol=0, atol=1e-6)
    assert runs["torch0"]["params"] == runs["torch1"]["params"]


def test_error_serializes_while_torch_is_still_importing(monkeypatch):
    """A process that imports torch on one thread (the controller's
    checkpoint save) while another serializes an error (a rank's death
    reaching its owner) holds a partial ``torch`` module without
    ``Tensor``.  The serializer's tensor probe treats it as not loaded:
    before, reading ``torch.Tensor`` raised inside the connection-loss
    handler, the rank's ``ActorDiedError`` was never stored, and the
    controller waited for the dead rank forever (the fit under
    test_failure_recovery_resumes_from_checkpoint hung under load)."""
    import sys
    import types

    from ant_ray_tpu_torch import exceptions
    from ant_ray_tpu_torch._private import serialization

    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    err = exceptions.ActorDiedError(None, "rank died")
    payload = serialization.serialize_error(err).to_payload()
    back = serialization.deserialize(
        serialization.SerializedObject.from_payload(payload))
    assert "rank died" in str(back)
