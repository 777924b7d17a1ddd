"""The train plane's telemetry in the port against the JAX package's:
the twins of tests/test_observability.py's ``:85`` (a device feed's
stats become phases), ``:106`` (a collective group's fusion stats
become phases), ``:203`` (the controller's cross-rank skew summary),
``:231`` (the latest record per rank), ``:429`` (the train step gauges
in the dashboard's ``/metrics``) and ``:461`` (the timeline's per-rank
step rows), with the reference's assertions and equal outcomes.  Also:
a profiler made inside a train loop registers on the session, its
records carry the session's rank, ``report()`` carries its last record,
and ``sync_gradients`` feeds the gang's fusion stats into its phases."""

import importlib
import json
import os
import time
import urllib.request

import pytest

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _profilers():
    return [_mod(art, "observability").StepProfiler for art in PACKAGES]


# ------------------------------------------ tests/test_observability.py :85

def test_attached_device_feed_stats_become_phases():
    got = []
    for StepProfiler in _profilers():
        feed = {"consumer_starve_s": 0.0, "transfer_issue_s": 0.0}
        prof = StepProfiler(publish=False)
        prof.attach_data_iterator(feed)
        feed["consumer_starve_s"] += 0.25
        feed["transfer_issue_s"] += 0.5
        with prof.step():
            time.sleep(0.001)
        rec = prof.last
        assert rec.phases["data_wait"] == pytest.approx(0.25)
        assert rec.phases["h2d"] == pytest.approx(0.5)
        feed["consumer_starve_s"] += 0.1
        with prof.step():
            time.sleep(0.001)
        assert prof.last.phases["data_wait"] == pytest.approx(0.1)
        assert "h2d" not in prof.last.phases
        got.append(sorted(prof.last.phases))
    assert got[0] == got[1]


# ----------------------------------------- tests/test_observability.py :106

def test_attached_fusion_stats_become_phases():
    got = []
    for StepProfiler in _profilers():
        live = {"pack_s": 0.0, "transfer_s": 0.0, "collective_s": 0.0,
                "unpack_s": 0.0, "overlap_s": 0.0}
        prof = StepProfiler(publish=False)
        prof._fusion_fns.append({"fn": lambda live=live: live,
                                 "snap": dict(live)})
        live["pack_s"] += 0.1
        live["collective_s"] += 0.2
        live["transfer_s"] += 0.05
        live["overlap_s"] += 0.15          # hidden under backward
        with prof.step():
            time.sleep(0.001)
        rec = prof.last
        assert rec.phases["collective"] == pytest.approx(0.15)
        assert rec.phases["h2d"] == pytest.approx(0.05)
        got.append(rec.phases["collective"])
    assert got[0] == pytest.approx(got[1])


def test_attach_fusion_stats_reads_a_live_group():
    """``attach_fusion_stats`` reads ``collective.fusion_stats`` of a
    group of the port each step."""
    import numpy as np

    from ant_ray_tpu_torch.observability import StepProfiler
    from ant_ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="gloo", group_name="obs_g")
    try:
        prof = StepProfiler(publish=False).attach_fusion_stats("obs_g")
        with prof.step():
            col.allreduce_coalesced([np.ones(64, np.float32)] * 3,
                                    group_name="obs_g")
        stats = col.fusion_stats("obs_g")
        want = stats["pack_s"] + stats["collective_s"] + stats["unpack_s"]
        assert prof.last.phases["collective"] == pytest.approx(
            max(0.0, want - stats["overlap_s"]))
        assert prof.last.phases["h2d"] == pytest.approx(stats["transfer_s"])
    finally:
        col.destroy_collective_group("obs_g")
    with prof.step():                     # group gone: best-effort
        pass


# ----------------------------------------- tests/test_observability.py :203

def _record_dict(rank, total_s, phases=None, mfu=None):
    return {"step": 1, "ts": 0.0, "total_s": total_s,
            "phases": phases or {"compute": total_s}, "mfu": mfu,
            "rank": rank}


def _controllers(tmp_path, name, world):
    out = []
    for art in PACKAGES:
        config = _mod(art, "train.config")
        controller = _mod(art, "train.controller").TrainController(
            loop_fn=lambda: None, loop_config=None,
            scaling=config.ScalingConfig(num_workers=world),
            run_config=config.RunConfig(
                name=name, storage_path=str(tmp_path / art.__name__)))
        out.append(controller)
    return out


def test_controller_skew_aggregation(tmp_path):
    summaries = []
    for controller in _controllers(tmp_path, "skew", 2):
        assert controller.get_step_summary() == {"ranks": 0}
        controller.report_from_worker(
            0, {"loss": 1.0, "_step_record": _record_dict(
                0, 0.1, {"compute": 0.08, "data_wait": 0.02}, mfu=0.4)},
            None)
        controller.report_from_worker(
            1, {"loss": 1.0, "_step_record": _record_dict(
                1, 0.3, {"compute": 0.3})}, None)
        s = controller.get_step_summary()
        assert s["ranks"] == 2
        assert s["step_time_max_s"] == pytest.approx(0.3)
        assert s["step_time_mean_s"] == pytest.approx(0.2)
        assert s["skew_ratio"] == pytest.approx(0.3 / 0.2)
        assert s["phase_data_wait_fraction"] == pytest.approx(0.1)
        assert s["mfu_mean"] == pytest.approx(0.4)
        assert "_step_record" not in controller._latest_metrics
        summaries.append(s)
    assert summaries[0] == summaries[1]


# ----------------------------------------- tests/test_observability.py :231

def test_controller_keeps_latest_record_per_rank(tmp_path):
    for controller in _controllers(tmp_path, "latest", 1):
        controller.report_from_worker(
            0, {"_step_record": _record_dict(0, 0.5)}, None)
        controller.report_from_worker(
            0, {"_step_record": _record_dict(0, 0.1)}, None)
        assert controller.get_step_summary()["step_time_max_s"] == \
            pytest.approx(0.1)


# ---------------------------------- tests/test_observability.py :429, :461

@pytest.fixture(scope="module")
def obs_clusters():
    """A cluster of each package with its dashboard, each having run
    the reference's two-rank profiled training loop."""
    prior = os.environ.get("ART_INCLUDE_DASHBOARD")
    os.environ["ART_INCLUDE_DASHBOARD"] = "1"
    for art in PACKAGES:
        _mod(art, "_private.config")._global_config = None
    out = {}
    try:
        for art in PACKAGES:
            ctx = art.init(num_cpus=4)
            assert ctx.dashboard_url, "dashboard did not start"
            out[art] = {"url": ctx.dashboard_url}
        yield out
    finally:
        for art in PACKAGES:
            art.shutdown()
        if prior is None:
            os.environ.pop("ART_INCLUDE_DASHBOARD", None)
        else:
            os.environ["ART_INCLUDE_DASHBOARD"] = prior
        for art in PACKAGES:
            _mod(art, "_private.config")._global_config = None


def _train_with_profiler(art, world: int, storage: str):
    train = _mod(art, "train")
    Trainer = getattr(train, "JaxTrainer", None) or train.TorchTrainer
    package = art.__name__

    def loop(config):
        import importlib as _il
        import time as _t

        _train = _il.import_module(f"{package}.train")
        _SP = _il.import_module(f"{package}.observability").StepProfiler
        ctx = _train.get_context()
        prof = _SP(flops_per_step=1e9, peak_flops=1e12, publish_batch=2)
        for step in range(4):
            with prof.step():
                with prof.phase("data_wait"):
                    _t.sleep(0.002)
                _t.sleep(0.005 + 0.02 * ctx.world_rank)  # rank skew
            _train.report({"step": step, "prof_rank": prof.last.rank,
                           "registered": ctx.step_profiler is prof})
        prof.close()

    result = Trainer(
        loop, train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=world),
        run_config=train.RunConfig(name="obs-e2e",
                                   storage_path=storage)).fit()
    assert result.error is None, result.error
    return result.metrics


def test_train_step_gauges_reach_prometheus(obs_clusters, tmp_path_factory):
    for art in PACKAGES:
        metrics = _train_with_profiler(
            art, 2, str(tmp_path_factory.mktemp(art.__name__)))
        assert metrics["prof_rank"] == 0 and metrics["registered"] is True
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(obs_clusters[art]["url"]
                                        + "/metrics", timeout=10) as resp:
                text = resp.read().decode()
            if "art_train_step_mfu" in text or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        for stat in ("mean", "p50", "max"):
            assert (f'art_train_step_time_s{{run="obs-e2e",stat="{stat}"}}'
                    in text), text
        assert 'art_train_step_phase_fraction{phase="data_wait",' \
               'run="obs-e2e"}' in text
        skew_line = next(line for line in text.splitlines()
                         if line.startswith("art_train_step_skew_ratio"))
        assert float(skew_line.split()[-1]) >= 1.0
        mfu_line = next(line for line in text.splitlines()
                        if line.startswith("art_train_step_mfu"))
        assert 0 < float(mfu_line.split()[-1]) < 1


def test_timeline_has_step_phase_device_rows(obs_clusters):
    """The trace of each package's cluster holds per-rank step-phase
    slices (the training run above published them): the records carry
    each rank's own number."""
    got = []
    for art in PACKAGES:
        worker = _mod(art, "_private.worker").global_worker
        from_trace = _mod(art, "util.timeline").timeline
        # Each package's runtime is the module-global of its own worker:
        # timeline() reads that package's GCS.
        assert worker.connected
        trace = from_trace()
        step_slices = [t for t in trace if t.get("cat") == "train_step"]
        assert {t["tid"] for t in step_slices} >= {"rank-0", "rank-1"}
        phase_names = {t["name"] for t in trace
                       if t.get("cat") == "step_phase"}
        assert {"data_wait", "compute"} <= phase_names
        json.dumps(trace)
        got.append(sorted({t["tid"] for t in step_slices}))
    assert got[0] == got[1]


def test_sync_gradients_feeds_the_profilers_collective_phase(
        obs_clusters, tmp_path):
    """In a two-rank gang of the port, the first ``sync_gradients``
    attaches the gang's fusion stats to the loop's profiler: the step
    that syncs has a collective phase, on each rank's own record."""
    from ant_ray_tpu_torch import train

    def loop(config):
        import numpy as np

        from ant_ray_tpu_torch import train as _train
        from ant_ray_tpu_torch.observability import StepProfiler

        ctx = _train.get_context()
        prof = StepProfiler(publish=False)
        grads = {"w": np.full((256, 64), float(ctx.world_rank), np.float32)}
        with prof.step():
            synced = _train.sync_gradients(grads)
        with prof.step():
            synced = _train.sync_gradients(grads)
        _train.report({"collective": prof.last.phases.get("collective", 0.0),
                       "rank": prof.last.rank,
                       "w": float(np.asarray(synced["w"])[0, 0])})

    result = train.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="obs-sync",
                                   storage_path=str(tmp_path))).fit()
    assert result.error is None
    assert result.metrics["collective"] > 0
    assert result.metrics["rank"] == 0 and result.metrics["w"] == 0.5


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA A100-SXM4-80GB", 312e12),
    ("NVIDIA H100 PCIe", None),
    ("Some Other Card", None)])
def test_profiler_peak_comes_from_the_accelerator_table(monkeypatch, name,
                                                        peak):
    """One peak table: the profiler reads the card's bf16 peak from
    ``accelerators/gpu.py``; the H100's entry gives the same peak
    (989e12 FLOP/s, NVIDIA's data sheet) and so the same MFU as the
    profiler's own entry did, exactly; a card without a row gives no
    MFU."""
    import torch

    from ant_ray_tpu_torch.observability.step_profiler import StepProfiler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    prof = StepProfiler(flops_per_step=2e12, publish=False)
    assert prof._peak_flops == peak
    with prof.step():
        time.sleep(0.01)
    summary = prof.summary()
    if peak is None:
        assert "mfu_mean" not in summary
    else:
        rec = prof.last
        assert summary["mfu_mean"] == pytest.approx(
            2e12 / (rec.total_s * peak), rel=1e-12)
