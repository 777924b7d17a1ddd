"""The port's shared-memory channels (``experimental/channel.py`` over
``art_torch_native.Channel``) against the JAX package's: the twins of
tests/test_channel_hardening.py — reader-death recovery, a
multi-process stress, and the native stress driver built from the
port's copy of ``channel_stress.cpp`` (plain, and under ThreadSanitizer
as ``slow``, as the reference marks it) — run through both packages
with equal outcomes; a CPU tensor's round trip, bitwise; the capacity
``MemoryError`` naming both sizes.  The card test (marked ``gpu``,
skipped here) sends a CUDA tensor through a compiled DAG on the card;
this file loads no JAX, so the card's machine runs it: ``python -m
pytest --noconftest -m gpu tests/test_torch_channel.py``."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ant_ray_tpu.experimental import channel as jchannel
from ant_ray_tpu_torch.experimental import channel as tchannel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = {"jax": jchannel, "torch": tchannel}


def _native_or_skip():
    from ant_ray_tpu._private.native import load_native as jload
    from ant_ray_tpu_torch._private.native import load_native as tload

    if jload() is None or tload() is None:
        pytest.skip("native extension unavailable (no g++)")


def _both(scenario, tmp_path):
    _native_or_skip()
    out = []
    for name in ("jax", "torch"):
        where = tmp_path / name
        where.mkdir()
        out.append(scenario(CHANNELS[name], where))
    return out


def _mask(message: str) -> str:
    return re.sub(r"\d+", "<n>", message.replace(str(REPO), "<repo>"))


# ------------------------------------------ tests/test_channel_hardening.py

def _reader_death(ch_mod, tmp_path):
    path = str(tmp_path / "chan")
    writer = ch_mod.ShmChannel(path, capacity=1 << 16, num_readers=2,
                               create=True)
    live = ch_mod.ShmChannel(path)
    dead = ch_mod.ShmChannel(path)   # this reader will "die" unreleased
    out = []
    writer.write({"v": 1})
    out.append(live.begin_read()["v"])
    live.end_read()
    out.append(dead.begin_read()["v"])
    # `dead` never calls end_read (its process crashed).  The writer
    # cannot publish version 2...
    with pytest.raises(ch_mod.ChannelTimeoutError):
        writer.write({"v": 2}, timeout=0.3)
    # ...until the control plane reports the death.
    out.append(writer.remove_reader())
    writer.write({"v": 2}, timeout=5.0)
    out.append(live.begin_read()["v"])
    live.end_read()
    out.append(writer.version)
    for ch in (live, dead, writer):
        ch.close()
    return out


def test_reader_death_recovery_unblocks_writer(tmp_path):
    want, got = _both(_reader_death, tmp_path)
    assert want == got == [1, 1, 1, 2, 2]


def _stress(ch_mod, tmp_path):
    """Two reader PROCESSES verify every version's integrity while the
    writer hammers: cross-process visibility of the atomics, not just
    cross-thread."""
    path = str(tmp_path / "chan")
    n_versions = 400
    reader_src = tmp_path / "reader.py"
    reader_src.write_text(
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from %s import ShmChannel\n"
        "ch = ShmChannel(%r)\n"
        "last = 0\n"
        "while True:\n"
        "    value = ch.begin_read(timeout=30)\n"
        "    if value['seq'] == -1:\n"
        "        ch.end_read(); print('DONE', last); break\n"
        "    assert value['seq'] > last, (value['seq'], last)\n"
        "    assert value['fill'] == bytes([value['seq'] %% 256]) * 512\n"
        "    last = value['seq']\n"
        "    ch.end_read()\n"
        % (REPO, ch_mod.__name__, path))
    writer = ch_mod.ShmChannel(path, capacity=1 << 16, num_readers=2,
                               create=True)
    procs = [subprocess.Popen([sys.executable, str(reader_src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    for seq in range(1, n_versions + 1):
        writer.write({"seq": seq, "fill": bytes([seq % 256]) * 512},
                     timeout=30)
    writer.write({"seq": -1, "fill": b""}, timeout=30)
    outs = []
    for proc in procs:
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        outs.append(out.strip())
    writer.close()
    return outs


def test_multiprocess_channel_stress(tmp_path):
    want, got = _both(_stress, tmp_path)
    assert want == got == ["DONE 400", "DONE 400"]


def _compile(src, tmp_path, *extra):
    binary = str(tmp_path / ("stress" + ("_tsan" if extra else "")))
    cmd = ["g++", "-O1", "-std=c++17", "-pthread", *extra, src,
           "-o", binary]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=120)
    return binary if proc.returncode == 0 else None


STRESS_SOURCES = {
    "jax": os.path.join(REPO, "native", "channel_stress.cpp"),
    "torch": os.path.join(REPO, "ant_ray_tpu_torch", "native",
                          "channel_stress.cpp")}


def _stress_driver(tmp_path, args, *extra):
    """Each package's stress driver, built from its own copy of the
    source against its own ``channel_core.h``; stdout and the TSAN
    verdict of each."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = []
    for name, src in STRESS_SOURCES.items():
        where = tmp_path / name
        where.mkdir()
        binary = _compile(src, where, *extra)
        if binary is None and extra:
            pytest.skip("toolchain lacks -fsanitize=thread")
        assert binary, f"the {name} stress driver failed to compile"
        run = subprocess.run([binary, *args], capture_output=True,
                             text=True, timeout=300)
        out.append((run.returncode, run.stdout.strip(),
                    "WARNING: ThreadSanitizer" in run.stderr))
    return out


def test_native_stress_driver(tmp_path):
    want, got = _stress_driver(tmp_path, ["30000", "3"])
    assert want == got == (0, "stress OK: 30000 versions, 3 readers",
                           False)


@pytest.mark.slow
def test_native_stress_under_tsan(tmp_path):
    """The protocol's atomics under ThreadSanitizer — any data race in
    publish/acquire/release/remove_reader fails this test."""
    want, got = _stress_driver(tmp_path, ["4000", "3"],
                               "-fsanitize=thread")
    assert want == got == (0, "stress OK: 4000 versions, 3 readers",
                           False)


# ------------------------------------------------------- tensors and sizes

def test_cpu_tensor_round_trip_is_bitwise(tmp_path):
    """A CPU tensor written into a channel reads back as a CPU tensor of
    the same dtype, shape and bits (NaNs and signed zeros included), and
    owns its memory: the next version does not reach it."""
    import torch

    _native_or_skip()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((33, 7), generator=gen, dtype=torch.float32)
    x[0, 0], x[0, 1] = float("nan"), -0.0
    values = {"f32": x, "bf16": x.to(torch.bfloat16),
              "i64": torch.arange(-5, 12, dtype=torch.int64),
              "strided": x.t()}
    path = str(tmp_path / "chan")
    writer = tchannel.ShmChannel(path, capacity=1 << 16, create=True)
    reader = tchannel.ShmChannel(path)
    writer.write(values)
    got = reader.begin_read(timeout=10)
    reader.end_read()
    writer.write({"f32": torch.zeros_like(x)})
    reader.begin_read(timeout=10)
    reader.end_read()
    for name, want in values.items():
        assert got[name].device.type == "cpu"
        assert got[name].dtype == want.dtype
        assert got[name].shape == want.shape
        assert torch.equal(got[name].contiguous().view(torch.uint8),
                           want.contiguous().view(torch.uint8)), name
    writer.close(unlink=True)
    reader.close()


def _over_capacity(ch_mod, tmp_path):
    import torch

    path = str(tmp_path / "chan")
    writer = ch_mod.ShmChannel(path, capacity=4096, create=True)
    try:
        writer.write(np.zeros(512, np.float32))   # 2048 bytes: fits
        with pytest.raises(MemoryError) as ei:
            writer.write(torch.zeros(2048, dtype=torch.float32))
        return str(ei.value)
    finally:
        writer.close(unlink=True)


def test_tensor_over_capacity_raises_naming_both_sizes(tmp_path):
    """A tensor over the channel's capacity meets the native
    ``MemoryError``, which names the message's size and the capacity."""
    want, got = _both(_over_capacity, tmp_path)
    assert _mask(want) == _mask(got) == \
        "message of <n> bytes exceeds channel capacity <n>"
    assert re.fullmatch(r"message of (\d+) bytes exceeds channel "
                        r"capacity 4096", got)
    assert int(got.split()[2]) > 2048 * 4


def test_channel_dir_is_under_dev_shm():
    want, got = jchannel.channel_dir(), tchannel.channel_dir()
    assert want == got
    assert got == os.path.join(
        "/dev/shm" if os.path.isdir("/dev/shm") else "/tmp", "art_channels")


# ------------------------------------------------------------------- card

@pytest.mark.gpu
def test_cuda_tensor_through_a_compiled_dag_on_the_card():
    """On the card: the driver writes a CUDA tensor into a compiled
    DAG's input channel; a ``num_gpus=1`` actor's stage gets it on
    ``cuda`` and returns a CUDA tensor, which the driver reads back on
    ``cuda``, bitwise equal to the same function called directly.  A
    CUDA tensor over ``buffer_size_bytes`` raises the capacity error."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tensors live on it")
    import ant_ray_tpu_torch as art
    from ant_ray_tpu_torch.dag import InputNode
    from ant_ray_tpu_torch.dag.compiled import ChannelCompiledDAG

    art.init(num_cpus=2, _system_config={"include_dashboard": False,
                                         "enable_node_agent": False})
    try:
        @art.remote(num_gpus=1)
        class Stage:
            def apply(self, x):
                assert x.device.type == "cuda", x.device
                return (x.float() * 3 + 1).softmax(-1)

        stage = Stage.remote()
        with InputNode() as inp:
            dag = stage.apply.bind(inp)
        compiled = dag.experimental_compile(buffer_size_bytes=1 << 20)
        assert isinstance(compiled, ChannelCompiledDAG)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((64, 1000), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        got = compiled.execute(x).get(timeout=300)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert torch.equal(got, (x.float() * 3 + 1).softmax(-1))
        big = torch.zeros(1 << 19, device="cuda")   # 2 MiB
        with pytest.raises(MemoryError, match="exceeds channel capacity"):
            compiled.execute(big)
        compiled.teardown()
        assert art.get(compiled._loop_refs, timeout=60) == [
            {"iterations": 1}]
        assert not any(os.path.exists(s.path)
                       for s in compiled._channel_specs.values())
    finally:
        art.shutdown()
