"""The port's cgroup v2 isolation manager (ref: src/ray/common/cgroup2/
— system vs worker process separation): tests/test_cgroup2.py's five
cases on ``ant_ray_tpu_torch``.  Driven against a fake cgroupfs root in
a tmp directory: the manager only does file I/O, so a plain directory
exercises every path except the kernel's enforcement, and nothing here
writes under /sys/fs/cgroup."""

import os

import ant_ray_tpu_torch as art
from ant_ray_tpu._private.cgroup2 import CgroupManager as JaxCgroupManager
from ant_ray_tpu_torch._private.cgroup2 import CgroupManager


def _fake_root(tmp_path, controllers="memory cpu pids", name="cgroup"):
    root = tmp_path / name
    root.mkdir()
    (root / "cgroup.controllers").write_text(controllers + "\n")
    (root / "cgroup.procs").write_text("")
    return str(root)


def test_available_requires_controllers_file(tmp_path):
    assert not CgroupManager.available(str(tmp_path))
    root = _fake_root(tmp_path)
    assert CgroupManager.available(root)


def _tree(root):
    """Every file under ``root`` with its text, by relative path."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path) as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_setup_creates_subtree_and_applies_limits(tmp_path):
    trees = []
    for cls, name in ((JaxCgroupManager, "jax"), (CgroupManager, "port")):
        root = _fake_root(tmp_path, name=name)
        base = os.path.join(root, "art_s1")
        os.makedirs(base)
        with open(os.path.join(base, "cgroup.controllers"), "w") as f:
            f.write("memory cpu\n")
        mgr = cls("s1", root=root,
                  workers_memory_max=512 * 1024 * 1024,
                  workers_cpu_weight=200)
        assert mgr.setup()
        trees.append(_tree(root))
    # The port's manager writes the JAX package's files, byte for byte.
    assert trees[0] == trees[1]
    assert mgr.active
    workers = os.path.join(base, "workers")
    assert os.path.isdir(os.path.join(base, "system"))
    with open(os.path.join(base, "cgroup.subtree_control")) as f:
        assert f.read() == "+memory +cpu"
    with open(os.path.join(workers, "memory.max")) as f:
        assert f.read() == str(512 * 1024 * 1024)
    with open(os.path.join(workers, "memory.oom.group")) as f:
        assert f.read() == "0"
    with open(os.path.join(workers, "cpu.weight")) as f:
        assert f.read() == "200"


def test_process_placement_and_cleanup(tmp_path):
    root = _fake_root(tmp_path)
    mgr = CgroupManager("s2", root=root)
    assert mgr.setup()
    assert mgr.add_system_process(101)
    assert mgr.add_worker_process(202)
    base = os.path.join(root, "art_s2")
    with open(os.path.join(base, "workers", "cgroup.procs")) as f:
        assert f.read().split() == ["202"]
    mgr.cleanup()
    # (On a real cgroupfs the rmdir also succeeds — interface files
    # vanish with the cgroup; a plain-fs fake keeps the dir around.)
    assert not mgr.active
    # stragglers were migrated back to the root
    with open(os.path.join(root, "cgroup.procs")) as f:
        assert "202" in f.read()


def test_inactive_manager_is_inert(tmp_path):
    mgr = CgroupManager("s3", root=str(tmp_path / "missing"))
    assert not mgr.add_worker_process(1)
    mgr.cleanup()          # must not raise on a half-missing tree


def test_cluster_boots_with_cgroups_enabled_but_unavailable(monkeypatch,
                                                            tmp_path):
    """enable_cgroups on a host without a delegated cgroup2 tree must
    degrade to a no-op, not break worker spawning.  The root is pinned
    to an empty dir so the test never mutates a real (writable-as-root)
    /sys/fs/cgroup."""
    monkeypatch.setenv("ART_ENABLE_CGROUPS", "1")
    monkeypatch.setenv("ART_CGROUP_ROOT", str(tmp_path / "no-cgroups"))
    from ant_ray_tpu_torch._private import config as config_mod

    config_mod._global_config = None
    art.init(num_cpus=1)
    try:
        @art.remote
        def f():
            return 7

        assert art.get(f.remote()) == 7
    finally:
        art.shutdown()
        config_mod._global_config = None


def test_daemon_places_workers_in_the_workers_cgroup(monkeypatch, tmp_path):
    """With a writable (fake) tree the node daemon builds its subtree,
    puts itself in ``system`` and every worker it spawns in ``workers``,
    and moves them back to the root at shutdown."""
    root = _fake_root(tmp_path)
    monkeypatch.setenv("ART_ENABLE_CGROUPS", "1")
    monkeypatch.setenv("ART_CGROUP_ROOT", root)
    monkeypatch.setenv("ART_CGROUP_WORKERS_CPU_WEIGHT", "150")
    from ant_ray_tpu_torch._private import config as config_mod

    config_mod._global_config = None
    art.init(num_cpus=1)
    try:
        @art.remote
        def pid():
            return os.getpid()

        worker = art.get(pid.remote())
        (base,) = [os.path.join(root, d) for d in os.listdir(root)
                   if d.startswith("art_")]
        with open(os.path.join(base, "workers", "cgroup.procs")) as f:
            assert str(worker) in f.read().split()
        with open(os.path.join(base, "workers", "cpu.weight")) as f:
            assert f.read() == "150"
        with open(os.path.join(base, "system", "cgroup.procs")) as f:
            daemon = int(f.read().split()[0])
        assert daemon != worker
    finally:
        art.shutdown()
        config_mod._global_config = None
    with open(os.path.join(root, "cgroup.procs")) as f:
        assert {str(worker), str(daemon)} <= set(f.read().split())
