"""A ``num_gpus=1`` task in a pip runtime env on the card: its worker runs
on the venv's interpreter, imports a wheel made here (pip asks no
index), loads the sm90 flash forward's library as built in
``ant_ray_tpu_torch/_build/`` (the venv changes neither the sources nor
nvcc's flags that name it, so nothing is rebuilt) and launches it once
at row 1's shape (B=1 S=4096 H=32 KVH=8 D=128 bf16, causal), within
chip_smoke's tolerance of its plain version; a task without the env
cannot import the wheel.  Marked ``gpu``: skipped without a card.  This
file imports no JAX, so the card's machine runs it: ``python -m pytest
--noconftest -m gpu tests/test_torch_runtime_env_card.py``."""

import os
import sys
import time
import zipfile

import pytest

ATTN = (1, 4096, 4096, 32, 8, 128)
TOL_OUT, TOL_LSE = 2e-2, 1e-3       # chip_smoke's TOL["bfloat16"]


def _make_wheel(path) -> str:
    name, version = "artcardwheel", "0.1"
    whl = path / f"{name}-{version}-py3-none-any.whl"
    info = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", "MAGIC = 4096\n")
        zf.writestr(f"{info}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{info}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-"
                    "Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{info}/RECORD", "")
    return str(whl)


def _kernel_check(attn):
    import artcardwheel
    import torch

    from ant_ray_tpu_torch.ops import _build
    from ant_ray_tpu_torch.ops import flash_attention as fa

    lib = "flash_attention_fwd_sm90"
    prebuilt = _build._library_path(lib).exists()
    t0 = time.perf_counter()
    _build.load(lib)
    load_s = time.perf_counter() - t0
    batch, q_len, kv_len, heads, kv_heads, dim = attn
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q = rand(batch, q_len, heads, dim)
    k = rand(batch, kv_len, kv_heads, dim)
    v = rand(batch, kv_len, kv_heads, dim)
    before = (fa.launch_count, fa.fwd_sm90_launch_count)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    launched = (fa.launch_count - before[0],
                fa.fwd_sm90_launch_count - before[1])
    ref_out, ref_lse = fa.flash_attention_fwd_lse_ref(q, k, v, causal=True)
    return {"prefix": sys.prefix, "wheel": artcardwheel.MAGIC,
            "prebuilt": prebuilt, "load_s": load_s, "launched": launched,
            "err_out": (out.float() - ref_out.float()).abs().max().item(),
            "err_lse": (lse - ref_lse).abs().max().item()}


def _imports_the_wheel():
    try:
        import artcardwheel  # noqa: F401
        return True
    except ImportError:
        return False


@pytest.mark.gpu
def test_pip_venv_task_launches_the_sm90_forward_unbuilt(tmp_path,
                                                         monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the task launches a CUDA kernel")
    import ant_ray_tpu_torch as art
    from ant_ray_tpu_torch.ops import _build

    _build.build_all()
    for key in ("PIP_NO_INDEX", "PIP_DISABLE_PIP_VERSION_CHECK"):
        monkeypatch.setenv(key, "1")
    wheel = _make_wheel(tmp_path)
    art.init(num_cpus=2)
    try:
        check = art.remote(num_gpus=1)(_kernel_check)
        got = art.get(check.options(runtime_env={"pip": [wheel]}).remote(
            ATTN), timeout=900)
        bare = art.get(art.remote(_imports_the_wheel).remote(), timeout=120)
    finally:
        art.shutdown()
    assert "venvs" in got["prefix"] and got["wheel"] == 4096, got
    assert got["prebuilt"] and got["launched"] == (1, 1), got
    assert got["err_out"] <= TOL_OUT and got["err_lse"] <= TOL_LSE, got
    assert not bare
    assert os.path.basename(sys.prefix) != os.path.basename(got["prefix"])
