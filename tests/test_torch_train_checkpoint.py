"""The port's train checkpoints (``train/checkpoint.py``) against the JAX
package's: the twins of tests/test_checkpoint.py ``:189`` (run-token
scoped restore) and tests/test_resilience.py ``:385`` (an atomic save
keeps the previous checkpoint), ``:420`` (a load adopts an orphaned
``.old-``) and ``:434`` (pack / unpack), the reference's assertions kept
and run on both packages, where the port's format is its own (one
``torch.save`` file in place of orbax).  Also: a pytree of torch
tensors round-trips bitwise without CUDA, bfloat16 and views included,
numpy leaves come back as numpy and plain values as they were, and a
checkpoint of another structure than ``abstract_tree`` raises."""

import glob
import os

import numpy as np
import pytest
import torch

from ant_ray_tpu.train import checkpoint as jckpt
from ant_ray_tpu_torch.train import checkpoint as ckpt

MODULES = (jckpt, ckpt)


# ------------------------------------------ tests/test_checkpoint.py :189

@pytest.mark.parametrize("mod", MODULES, ids=["jax", "torch"])
def test_restore_adopts_only_this_fits_checkpoints(tmp_path, mod):
    """Token-scoped restore: a recreated controller (restore=True) must
    adopt the CURRENT fit's checkpoints, never a previous same-named
    run's leftovers — and a fresh manager must not delete them."""
    storage = str(tmp_path / "exp1")
    mgr_a = mod.CheckpointManager(storage, restore=False)
    for i in range(2):
        path = mgr_a.next_checkpoint_dir(i)
        os.makedirs(path)
        mgr_a.register(mod.Checkpoint.from_directory(path))
    mgr_b = mod.CheckpointManager(storage, restore=False)
    assert os.path.isdir(mgr_a.next_checkpoint_dir(0))
    assert mgr_b.latest is None
    restored_early = mod.CheckpointManager(storage, restore=True)
    assert restored_early.latest is None
    path_b = mgr_b.next_checkpoint_dir(5)
    os.makedirs(path_b)
    mgr_b.register(mod.Checkpoint.from_directory(path_b))
    restored = mod.CheckpointManager(storage, restore=True)
    assert restored.latest is not None
    assert restored.latest.path == os.path.abspath(path_b)
    assert restored.next_index == 6


def test_retention_keeps_the_newest_and_the_latest_replica(tmp_path):
    for mod in MODULES:
        storage = str(tmp_path / mod.__name__)
        mgr = mod.CheckpointManager(storage, num_to_keep=2)
        for i in range(4):
            path = mgr.next_checkpoint_dir(i)
            os.makedirs(path)
            mgr.register(mod.Checkpoint(path=os.path.abspath(path),
                                        replica=f"ref{i}"))
        assert sorted(os.listdir(storage)) == [
            ".run_token", "checkpoint_000002", "checkpoint_000003"]
        assert mgr.latest.replica == "ref3"
        assert mgr._checkpoints[0].replica is None


# ----------------------------------------- tests/test_resilience.py :385

def test_save_pytree_atomic_preserves_previous_checkpoint(tmp_path,
                                                          monkeypatch):
    """save_pytree to an existing path never destroys the previous
    checkpoint before the new one is completely written."""
    import orbax.checkpoint as ocp

    class Boom(RuntimeError):
        pass

    def exploding_save(self, directory, *a, **k):
        raise Boom("torn write")

    def exploding_write(tree, directory):
        os.makedirs(directory)            # a torn, partial directory
        raise Boom("torn write")

    explode = {jckpt: lambda m: m.setattr(
                   ocp.PyTreeCheckpointer, "save", exploding_save),
               ckpt: lambda m: m.setattr(
                   ckpt, "_write_tree", exploding_write)}
    for mod in MODULES:
        path = str(tmp_path / mod.__name__ / "ckpt")
        os.makedirs(os.path.dirname(path))
        mod.save_pytree({"step": 1}, path)
        with monkeypatch.context() as m:
            explode[mod](m)
            with pytest.raises(Boom):
                mod.save_pytree({"step": 2}, path)
        assert int(mod.load_pytree(path)["step"]) == 1   # old copy intact
        assert glob.glob(path + ".tmp-*") == []          # no leftovers
        mod.save_pytree({"step": 3}, path)
        assert int(mod.load_pytree(path)["step"]) == 3
        assert glob.glob(path + ".*") == []


# ----------------------------------------- tests/test_resilience.py :420

@pytest.mark.parametrize("mod", MODULES, ids=["jax", "torch"])
def test_load_pytree_adopts_orphaned_old(tmp_path, mod):
    path = str(tmp_path / "ckpt")
    mod.save_pytree({"step": 4}, path)
    os.rename(path, path + ".old-dead0")     # crash mid-swap
    assert int(mod.load_pytree(path)["step"]) == 4
    assert os.path.isdir(path)
    assert glob.glob(path + ".old-*") == []


# ----------------------------------------- tests/test_resilience.py :434

@pytest.mark.parametrize("mod", MODULES, ids=["jax", "torch"])
def test_checkpoint_pack_unpack_roundtrip(tmp_path, mod):
    src = str(tmp_path / "src")
    mod.save_pytree({"w": [1.0, 2.0], "step": 9}, src)
    blob = mod.pack_checkpoint_dir(src)
    dest = str(tmp_path / "nested" / "dest")
    assert mod.unpack_checkpoint(blob, dest) == dest
    restored = mod.load_pytree(dest)
    assert int(restored["step"]) == 9
    assert [float(x) for x in restored["w"]] == [1.0, 2.0]


# ----------------------------------------------------- the port's format

def test_tensor_pytree_round_trip_is_bitwise_without_cuda(tmp_path):
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=gen)
    tree = {"params": {"w": base.to(torch.bfloat16),
                       "view": base[::2, 1:5],         # a strided view
                       "i": torch.arange(5, dtype=torch.int64)},
            "opt": [torch.tensor(3.0), {"lr": 1e-3, "name": "adamw",
                                        "maximize": False, "foreach": None}],
            "np": np.linspace(0, 1, 7, dtype=np.float32),
            "step": 12, "betas": (0.9, 0.999)}
    path = str(tmp_path / "tree")
    ckpt.save_pytree(tree, path)
    assert os.listdir(path) == [ckpt.PYTREE_FILE]
    back = ckpt.load_pytree(path)
    w = back["params"]["w"]
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    assert torch.equal(w.view(torch.int16),
                       tree["params"]["w"].view(torch.int16))
    assert torch.equal(back["params"]["view"], tree["params"]["view"])
    assert back["params"]["view"].is_contiguous()
    assert torch.equal(back["params"]["i"], tree["params"]["i"])
    assert isinstance(back["np"], np.ndarray)
    assert back["np"].tobytes() == tree["np"].tobytes()
    assert back["opt"][1] == tree["opt"][1]
    assert back["step"] == 12 and back["betas"] == (0.9, 0.999)
    assert torch.equal(back["opt"][0], tree["opt"][0])
    # device= puts the tensors there (the card in practice; the host
    # here), numpy leaves stay numpy
    again = ckpt.load_pytree(path, device="cpu")
    assert torch.equal(again["params"]["w"], w)
    # the Checkpoint handle reads the same tree
    handle = ckpt.Checkpoint.from_directory(path)
    assert torch.equal(handle.to_pytree()["params"]["i"],
                       tree["params"]["i"])
    # a structure check against abstract_tree
    ckpt.load_pytree(path, abstract_tree=tree)
    with pytest.raises(ValueError, match="structure"):
        ckpt.load_pytree(path, abstract_tree={"params": tree["params"]})


def test_save_pytree_refuses_what_it_cannot_load(tmp_path):
    with pytest.raises(TypeError, match="leaf"):
        ckpt.save_pytree({"f": object()}, str(tmp_path / "x"))
    assert glob.glob(str(tmp_path / "x*")) == []
