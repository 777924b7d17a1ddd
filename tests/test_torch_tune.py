"""The port's ``tune/`` (the trial-actor controller, the searchers, the
ASHA / median-stopping / PBT schedulers) against the JAX package's.
Each of tests/test_tune.py's nine tests has its twin here, run through
both packages (the cluster scenarios in a cluster of each), with the
reference's assertions held on both.  Beside them, parity on seeded
inputs: ``expand_param_space``, the three schedulers fed one stream of
results, ``TPESearcher`` fed one stream of observations, and
``Tuner.fit`` with a deterministic trainable under ASHA must agree
call for call with the reference."""

import glob
import importlib
import math
import os
import time

import numpy as np
import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


def _tune(art):
    return importlib.import_module(f"{art.__name__}.tune")


@pytest.fixture(scope="module")
def clusters():
    started = []
    try:
        for art in PACKAGES:
            art.init(num_cpus=4, num_tpus=0)
            started.append(art)

            @art.remote
            def _warm(i):
                return i

            # Warm each worker pool, as the reference's fixture does, so
            # an async PBT population overlaps.
            art.get([_warm.remote(i) for i in range(4)])
        yield
    finally:
        for art in reversed(started):
            art.shutdown()


def _both(scenario):
    out = [scenario(art, _tune(art)) for art in PACKAGES]
    assert out[0] == out[1]
    return out[1]


# ------------------------------------------------ tests/test_tune.py twins

def test_param_space_expansion():
    def scenario(art, tune):
        space = {"lr": tune.grid_search([0.1, 0.01]),
                 "wd": tune.grid_search([0, 1]),
                 "seed": 7}
        configs = tune.tuner.expand_param_space(space, num_samples=1)
        assert len(configs) == 4
        assert all(c["seed"] == 7 for c in configs)
        space2 = {"lr": tune.loguniform(1e-4, 1e-1)}
        configs2 = tune.tuner.expand_param_space(space2, num_samples=5,
                                                 seed=0)
        assert len(configs2) == 5
        assert all(1e-4 <= c["lr"] <= 1e-1 for c in configs2)
        return configs, configs2

    _both(scenario)


def test_grid_search_finds_optimum(clusters):
    def scenario(art, tune):
        def trainable(config):
            loss = (config["x"] - 3) ** 2 + config["y"]
            tune.report({"loss": loss})

        tuner = tune.Tuner(
            trainable,
            param_space={"x": tune.grid_search([1, 2, 3, 4]),
                         "y": tune.grid_search([0.5, 0.0])},
            tune_config=tune.TuneConfig(max_concurrent_trials=4))
        grid = tuner.fit()
        assert len(grid) == 8
        best = grid.get_best_result("loss", mode="min")
        assert best.config["x"] == 3 and best.config["y"] == 0.0
        assert best.metrics["loss"] == 0.0
        return sorted((r.config["x"], r.config["y"], r.metrics["loss"])
                      for r in grid)

    _both(scenario)


def test_returned_metrics_and_history(clusters):
    def scenario(art, tune):
        def trainable(config):
            for step in range(3):
                tune.report({"step": step})
            return {"final": config["k"] * 10}

        grid = tune.Tuner(
            trainable, param_space={"k": tune.grid_search([1, 2])}).fit()
        best = grid.get_best_result("final", mode="max")
        assert best.metrics["final"] == 20
        assert len(best.history) == 3
        return best.config, best.metrics, best.history

    _both(scenario)


def test_trial_error_captured(clusters):
    def scenario(art, tune):
        def trainable(config):
            if config["x"] == 1:
                raise ValueError("bad trial")
            tune.report({"ok": config["x"]})

        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([0, 1])}).fit()
        assert len(grid.errors) == 1
        assert "bad trial" in str(grid.errors[0])
        best = grid.get_best_result("ok", mode="max")
        assert best.config["x"] == 0
        return sorted((r.config["x"], r.error is None) for r in grid)

    _both(scenario)


def test_random_sampling_num_samples(clusters):
    def scenario(art, tune):
        def trainable(config):
            tune.report({"v": config["lr"]})

        grid = tune.Tuner(
            trainable,
            param_space={"lr": tune.uniform(0, 1)},
            tune_config=tune.TuneConfig(num_samples=6, seed=1)).fit()
        assert len(grid) == 6
        return sorted(r.metrics["v"] for r in grid)

    _both(scenario)


def _step_decay(tune):
    """The reference test's ``_StepDecay`` as a subclass of ``tune``'s
    Trainable: loss = offset + 1/iter, with its optional rendezvous and
    step pacing (see tests/test_tune.py)."""

    class StepDecay(tune.Trainable):
        def setup(self, config):
            self.offset = config["offset"]
            self.iter = 0
            self._rendezvous = config.get("rendezvous")
            self._rendezvous_count = config.get("rendezvous_count", 2)
            self._step_sleep = config.get("step_sleep", 0.0)
            if self._rendezvous:
                open(os.path.join(self._rendezvous,
                                  f"up_{config['offset']}"), "w").close()

        def step(self):
            if self._rendezvous and self.iter == 0:
                deadline = time.monotonic() + 120
                pattern = os.path.join(self._rendezvous, "up_*")
                while time.monotonic() < deadline and \
                        len(glob.glob(pattern)) < self._rendezvous_count:
                    time.sleep(0.02)
            if self._step_sleep:
                time.sleep(self._step_sleep)
            self.iter += 1
            return {"loss": self.offset + 1.0 / self.iter}

        def save_checkpoint(self):
            return {"iter": self.iter, "offset": self.offset}

        def load_checkpoint(self, state):
            self.iter = state["iter"]
            self.offset = state["offset"]

    return StepDecay


def test_asha_stops_bad_trials_early(clusters):
    def scenario(art, tune):
        tuner = tune.Tuner(
            _step_decay(tune),
            param_space={"offset": tune.grid_search([0.0, 1.0, 2.0, 3.0])},
            tune_config=tune.TuneConfig(
                stop={"training_iteration": 12},
                scheduler=tune.AsyncHyperBandScheduler(
                    metric="loss", mode="min", max_t=12, grace_period=2,
                    reduction_factor=2),
            ))
        grid = tuner.fit()
        assert not grid.errors
        best = grid.get_best_result("loss", mode="min")
        assert best.config["offset"] == 0.0
        iters = {r.config["offset"]: len(r.history) for r in grid}
        assert iters[0.0] == 12
        assert any(n < 12 for cfg, n in iters.items() if cfg != 0.0), iters
        # Which bad trial is culled depends on rung-arrival order, so
        # only the winner and its length are compared across packages.
        return best.config["offset"], iters[0.0]

    _both(scenario)


def test_median_stopping_rule_decisions():
    def scenario(art, tune):
        rule = tune.MedianStoppingRule(metric="score", mode="max",
                                       grace_period=2,
                                       min_samples_required=2)
        decisions = []
        for tid, score in (("a", 10.0), ("b", 9.0)):
            for it in (1, 2, 3):
                decisions.append(rule.on_trial_result(
                    tid, {"score": score, "training_iteration": it}))
        assert set(decisions) == {"CONTINUE"}
        decision = rule.on_trial_result(
            "c", {"score": 1.0, "training_iteration": 3})
        assert decision == "STOP"
        return decisions, decision

    _both(scenario)


def test_pbt_exploits_checkpoint_and_mutates_config(clusters, tmp_path):
    def scenario(art, tune):
        rendezvous = tmp_path / art.__name__
        rendezvous.mkdir()
        tuner = tune.Tuner(
            _step_decay(tune),
            param_space={"offset": tune.grid_search([0.0, 5.0]),
                         "rendezvous": str(rendezvous),
                         "step_sleep": 0.05},
            tune_config=tune.TuneConfig(
                stop={"training_iteration": 8},
                scheduler=tune.PopulationBasedTraining(
                    metric="loss", mode="min", perturbation_interval=3,
                    quantile_fraction=0.5,
                    hyperparam_mutations={"offset": [0.0, 5.0]}, seed=0),
            ))
        grid = tuner.fit()
        assert not grid.errors
        assert min(r.metrics["loss"] for r in grid) < 5.0
        assert all(r.metrics["loss"] < 5.0 for r in grid)
        return len(grid)

    _both(scenario)


def test_tpe_searcher_beats_random_on_quadratic(clusters):
    def scenario(art, tune):
        space = {"x": tune.uniform(-10.0, 10.0)}

        def objective(config):
            tune.report({"loss": (config["x"] - 3.0) ** 2})

        tuner = tune.Tuner(
            objective, param_space=space,
            tune_config=tune.TuneConfig(
                search_alg=tune.TPESearcher(
                    space, metric="loss", mode="min", num_samples=30,
                    n_initial=8, seed=0),
                max_concurrent_trials=4))
        grid = tuner.fit()
        assert len(grid) == 30
        best = grid.get_best_result("loss", mode="min")
        assert abs(best.config["x"] - 3.0) < 1.5
        return len(grid)

    _both(scenario)


# --------------------------------------------------- parity, seeded inputs

def _space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1),
            "wd": tune.uniform(0.0, 0.3),
            "layers": tune.randint(2, 9),
            "act": tune.choice(["relu", "gelu", "silu"]),
            "bs": tune.grid_search([16, 32, 64]),
            "fixed": "x"}


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_expand_param_space_same_configs_for_the_same_seed(seed):
    configs = [_tune(art).tuner.expand_param_space(
        _space(_tune(art)), num_samples=4, seed=seed) for art in PACKAGES]
    assert len(configs[1]) == 12
    assert configs[0] == configs[1]


def _result_stream(seed, trials=6, steps=12):
    """Interleaved results of ``trials`` trials, made from a seed: each
    trial's loss decays from its own offset with noise, and the order
    in which trials report is shuffled step by step."""
    rng = np.random.default_rng(seed)
    offsets = rng.uniform(0.0, 3.0, size=trials)
    stream = []
    for step in range(1, steps + 1):
        for t in rng.permutation(trials):
            loss = float(offsets[t] + 1.0 / step
                         + 0.05 * rng.standard_normal())
            stream.append((f"trial_{t}", {"loss": loss,
                                          "training_iteration": step}))
    return stream


def _feed(scheduler, stream):
    """Decisions of ``scheduler`` on ``stream``; a stopped trial reports
    no more, as under the controller."""
    stopped, out = set(), []
    for tid, result in stream:
        if tid in stopped:
            continue
        decision = scheduler.on_trial_result(tid, dict(result))
        if decision == "STOP":
            stopped.add(tid)
            scheduler.on_trial_complete(tid, dict(result))
        if not isinstance(decision, str):
            decision = ("exploit", decision.source_trial_id,
                        sorted(decision.config.items()))
            scheduler.on_exploit_applied(tid, dict(decision[2]))
        out.append((tid, decision))
    return out


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_asha_same_decisions_on_one_stream(seed):
    stream = _result_stream(seed)
    outs = [_feed(_tune(art).AsyncHyperBandScheduler(
        metric="loss", mode="min", max_t=12, grace_period=2,
        reduction_factor=2), stream) for art in PACKAGES]
    assert outs[0] == outs[1]
    assert any(d == "STOP" for _, d in outs[1])


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_median_rule_same_decisions_on_one_stream(seed):
    stream = _result_stream(seed)
    outs = [_feed(_tune(art).MedianStoppingRule(
        metric="loss", mode="min", grace_period=3,
        min_samples_required=2), stream) for art in PACKAGES]
    assert outs[0] == outs[1]
    assert any(d == "STOP" for _, d in outs[1])


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_pbt_same_exploit_target_and_mutated_config(seed):
    stream = _result_stream(seed)
    outs = []
    for art in PACKAGES:
        tune = _tune(art)
        pbt = tune.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2,
            quantile_fraction=0.5, resample_probability=0.3,
            hyperparam_mutations={"lr": [1e-4, 1e-3, 1e-2],
                                  "wd": tune.uniform(0.0, 0.3),
                                  "layers": [2, 4, 8]},
            seed=seed)
        for t in range(6):
            pbt.on_trial_add(f"trial_{t}", {"lr": 1e-3, "wd": 0.1 * t,
                                            "layers": 4, "act": "relu"})
        outs.append(_feed(pbt, stream))
    assert outs[0] == outs[1]
    assert any(not isinstance(d, str) for _, d in outs[1])


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_same_suggestions_for_the_same_seed_and_observations(seed):
    outs = []
    for art in PACKAGES:
        tune = _tune(art)
        space = {k: v for k, v in _space(tune).items() if k != "bs"}
        searcher = tune.TPESearcher(space, metric="loss", mode="min",
                                    num_samples=24, n_initial=6,
                                    seed=seed)
        suggested = []
        for i in range(24):
            config = searcher.suggest(f"t{i}")
            suggested.append(sorted(config.items()))
            loss = (math.log10(config["lr"]) + 3) ** 2 + config["wd"] \
                + 0.1 * config["layers"] \
                + (0.5 if config["act"] == "relu" else 0.0)
            searcher.on_trial_complete(f"t{i}", {"loss": loss},
                                       error=(i % 7 == 5))
        assert searcher.suggest("end") is None
        outs.append(suggested)
    assert outs[0] == outs[1]


def test_fit_same_best_config_and_asha_stops(clusters):
    """One trial at a time, so ASHA sees the rungs in a fixed order:
    the same best config and the same trials stopped early, in each
    package's own cluster."""
    def scenario(art, tune):
        def trainable(config):
            for it in range(1, 9):
                tune.report({"loss": config["offset"] + 1.0 / it})

        grid = tune.Tuner(
            trainable,
            param_space={"offset": tune.grid_search(
                [2.0, 0.5, 3.0, 0.0, 1.0])},
            tune_config=tune.TuneConfig(
                max_concurrent_trials=1,
                scheduler=tune.AsyncHyperBandScheduler(
                    metric="loss", mode="min", max_t=8, grace_period=1,
                    reduction_factor=2))).fit()
        assert not grid.errors
        best = grid.get_best_result("loss", mode="min")
        stopped = sorted(r.config["offset"] for r in grid
                         if len(r.history) < 8)
        assert stopped
        return best.config, stopped, sorted(
            (r.config["offset"], len(r.history)) for r in grid)

    _both(scenario)


def test_tune_imports_no_torch():
    import subprocess
    import sys

    code = ("import sys, ant_ray_tpu_torch.tune, "
            "ant_ray_tpu_torch.autoscaler, "
            "ant_ray_tpu_torch._private.sim_node, "
            "ant_ray_tpu_torch._lint.checkers\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ant_ray_tpu')))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
