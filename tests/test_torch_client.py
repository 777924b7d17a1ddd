"""The port's client (``init("art://host:port")``, ``util/client/``)
against the JAX package's: the scenarios of tests/test_client.py (task,
put/get with ref args, actor lifecycle, errors, wait, a streaming
generator, cluster info) run through a client of each package, each
connected to its own client server beside its own cluster, with equal
outcomes.  Besides: a CPU tensor round trip, the server's release of a
stored object once the client's mirror of its ref is collected, and the
slice as a whole — a small Llama (``tiny``, weights carried across from
the JAX package's numpy parameters) in an actor created through
``art://``, whose greedy token ids must equal the JAX package's actor's.

One cluster, one client server and one client per package for the
module (the suite-speed rule).  The port's server stores and forwards
payloads without rebuilding them; what the client gets back is held to
what it put."""

from __future__ import annotations

import gc
import importlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ant_ray_tpu as jart
import ant_ray_tpu_torch as tart

PACKAGES = (jart, tart)
MAX_SEQ = 256
N_TOKENS = 8
PROMPTS = [np.random.default_rng(n).integers(0, 250, n).tolist()
           for n in (3, 50, 100)]


def _mod(art, name):
    return importlib.import_module(f"{art.__name__}.{name}")


def _mask(message: str) -> str:
    message = message.replace("ant_ray_tpu_torch", "ant_ray_tpu")
    return re.sub(r"\b[0-9a-f]{8,}\b", "<id>", message)


def _start_server(art, cluster_address):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{art.__name__}.util.client.server",
         "--cluster-address", cluster_address, "--host", "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"client server died (code={proc.poll()})")
        text = line.decode(errors="replace").strip()
        if text.startswith("ART_CLIENT_SERVER_READY"):
            return proc, text.split(" ", 1)[1]
    proc.kill()
    raise RuntimeError("client server never became ready")


@pytest.fixture(scope="module")
def clients():
    """Per package: a cluster, a client server fronting it, and this
    process connected to the server through ``art://``."""
    started = {}
    try:
        for art in PACKAGES:
            cluster = _mod(art, "cluster_utils").Cluster(
                head_node_args={"num_cpus": 4})
            started[art] = {"cluster": cluster}
            proc, address = _start_server(art, cluster.address)
            started[art].update(proc=proc, address=address)
            art.init(f"art://{address}")
            started[art]["connected"] = True
        yield started
    finally:
        for art, c in started.items():
            if c.get("connected"):
                art.shutdown()
            if "proc" in c:
                c["proc"].kill()
                c["proc"].wait(timeout=10)
            c["cluster"].shutdown()


def _each(scenario):
    got = [scenario(art) for art in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome under comparison
        return ("raise", type(e).__name__, _mask(str(e)))


def test_client_task_roundtrip(clients):
    def scenario(art):
        @art.remote
        def square(x):
            return x * x

        return art.get([square.remote(i) for i in range(5)])

    assert _each(scenario) == [0, 1, 4, 9, 16]


def test_client_put_get_and_ref_args(clients):
    def scenario(art):
        ref = art.put({"k": list(range(10))})
        last = art.get(ref)["k"][-1]

        @art.remote
        def length(d):
            return len(d["k"])

        # Top-level ObjectRef args resolve server-side, same as in-cluster.
        nested = art.put([ref])
        return last, art.get(length.remote(ref)), \
            art.get(art.get(nested)[0])["k"][:3]

    assert _each(scenario) == (9, 10, [0, 1, 2])


def test_client_actor_lifecycle(clients):
    def scenario(art):
        @art.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

        c = Counter.options(name="client_counter").remote(100)
        out = [art.get(c.incr.remote()), art.get(c.incr.remote(by=9))]
        # Named lookup goes through the proxied GCS path.
        again = art.get_actor("client_counter")
        out.append(art.get(again.incr.remote()))
        art.kill(c)
        time.sleep(0.2)
        with pytest.raises(Exception):
            art.get(again.incr.remote())
        return out

    assert _each(scenario) == [101, 110, 111]


def test_client_error_propagation(clients):
    def scenario(art):
        @art.remote
        def boom():
            raise ValueError("client boom")

        with pytest.raises(Exception, match="client boom") as ei:
            art.get(boom.remote())
        return type(ei.value).__name__, type(ei.value.cause).__name__

    assert _each(scenario) == ("TaskError", "ValueError")


def test_client_wait(clients):
    def scenario(art):
        @art.remote
        def fast():
            return "fast"

        @art.remote
        def slow():
            time.sleep(5)
            return "slow"

        f, s = fast.remote(), slow.remote()
        ready, not_ready = art.wait([f, s], num_returns=1, timeout=3)
        return ready == [f], not_ready == [s]

    assert _each(scenario) == (True, True)


def test_client_streaming_generator(clients):
    def scenario(art):
        @art.remote(num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield i * i

        return [art.get(r) for r in gen.remote(4)]

    assert _each(scenario) == [0, 1, 4, 9]


def test_client_cluster_info(clients):
    def scenario(art):
        return (art.cluster_resources().get("CPU", 0) >= 4,
                any(n.get("Alive") for n in art.nodes()))

    assert _each(scenario) == (True, True)


def test_client_cpu_tensor_round_trip(clients):
    """A tensor put through the client comes back equal, bitwise, also
    from a task that takes it by ref and returns it (bf16 included)."""
    def scenario(art):
        gen = torch.Generator().manual_seed(3)
        tensors = [torch.randn(64, 33, generator=gen),
                   torch.randn(4096, generator=gen).to(torch.bfloat16)]

        @art.remote
        def echo(x):
            return x

        out = []
        for t in tensors:
            ref = art.put(t)
            back = [art.get(ref), art.get(echo.remote(ref))]
            out.append([(b.dtype, tuple(b.shape), b.device.type,
                         torch.equal(b, t)) for b in back])
        return out

    assert _each(scenario) == [
        [(torch.float32, (64, 33), "cpu", True)] * 2,
        [(torch.bfloat16, (4096,), "cpu", True)] * 2]


def _store_used(art, c) -> int:
    pool = _mod(art, "_private.protocol").ClientPool()
    try:
        node = c["cluster"]._node_addresses[0]
        return pool.get(node).call("GetStoreStats", {}, timeout=10)["used"]
    finally:
        pool.close_all()


def test_server_releases_a_ref_once_the_mirror_is_collected(clients):
    """A stored object lives while the client holds a mirror of its ref
    and is freed from the node's store once the mirror is collected."""
    def scenario(art):
        c = clients[art]
        before = _store_used(art, c)
        ref = art.put(np.ones(4 << 20, dtype=np.uint8))
        held = _store_used(art, c) - before
        del ref
        gc.collect()
        deadline = time.monotonic() + 20
        while _store_used(art, c) > before and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        return held >= 4 << 20, _store_used(art, c) == before

    assert _each(scenario) == (True, True)


def test_llama_in_an_actor_through_the_client(clients):
    """The slice as a whole: a tiny Llama's engine in an actor created
    through ``art://``, its weights the JAX package's (as numpy, carried
    across by ``params_from_jax_numpy``), generates greedy token ids
    equal to the JAX package's actor's."""
    import jax

    from ant_ray_tpu.models import llama as jl
    from ant_ray_tpu_torch.models import llama as tl
    from ant_ray_tpu_torch.models.convert import params_from_jax_numpy

    jparams = jax.tree.map(np.asarray, jl.init_params(
        jl.CONFIGS["tiny"], jax.random.PRNGKey(21)))
    tparams = params_from_jax_numpy(jparams, tl.CONFIGS["tiny"],
                                    device="cpu")

    @jart.remote
    class JaxLlama:
        def __init__(self, params):
            from ant_ray_tpu.llm import LLMEngine

            self.engine = LLMEngine("tiny", params, slots=4,
                                    max_seq=MAX_SEQ)

        def generate(self, prompts, n):
            from ant_ray_tpu.llm import SamplingParams

            outs = self.engine.generate(prompts, SamplingParams(max_tokens=n))
            return [list(o.token_ids) for o in outs]

    @tart.remote
    class TorchLlama:
        def __init__(self, params):
            from ant_ray_tpu_torch.llm import LLMEngine

            self.engine = LLMEngine("tiny", params, slots=4,
                                    max_seq=MAX_SEQ, device="cpu")

        def generate(self, prompts, n):
            from ant_ray_tpu_torch.llm import SamplingParams

            outs = self.engine.generate(prompts, SamplingParams(max_tokens=n))
            return [list(o.token_ids) for o in outs]

    want = jart.get(JaxLlama.remote(jart.put(jparams)).generate.remote(
        PROMPTS, N_TOKENS), timeout=300)
    actor = TorchLlama.remote(tart.put(tparams))
    got = tart.get(actor.generate.remote(PROMPTS, N_TOKENS), timeout=300)
    assert [len(t) for t in got] == [N_TOKENS] * len(PROMPTS)
    assert got == want
