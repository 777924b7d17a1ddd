"""Channel-compiled DAG execution.

Role of the reference's ``CompiledDAG``
(ref: python/ray/dag/compiled_dag_node.py:805): compile an actor-method
graph into per-actor EXECUTION LOOPS connected by preallocated mutable
shm channels (``experimental/channel.py``), so a steady-state step pays
zero task submissions — the driver writes the input channel, every
stage wakes on its input versions, and the result appears in the output
channel.  Backpressure is intrinsic: a writer cannot publish version
N+1 until all readers released N, which is the microbatch pipelining
contract GPipe-style inter-actor pipelines need.

As in the JAX package, the channels are plain mmap files with atomic
version counters, and the exec loop is a plain actor task that never
returns until teardown, so it composes with the actor runtime
(ordering, restarts, death detection).  It holds the actor's executor
thread while it runs: calls through ``.remote()`` to an actor with
``max_concurrency=1`` wait for teardown.  CUDA tensors cross a channel
as their bytes (the writer's ``.cpu()`` is the only wait on the card)
and are rebuilt on ``cuda`` in the reading process.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from ant_ray_tpu_torch.experimental.channel import (
    ChannelClosedError,
    ChannelTimeoutError,
    ShmChannel,
    channel_dir,
)

EXEC_LOOP_METHOD = "__art_exec_loop__"


@dataclass
class ChannelSpec:
    path: str
    capacity: int
    num_readers: int


@dataclass
class StepSpec:
    """One actor-method call inside an exec loop.

    ``args``/``kwargs`` templates: ("const", v) | ("chan", idx) |
    ("input", (input_channel, input_index)) | ("local", node_pos) —
    "chan" reads another actor's output channel, "local" reuses a value
    produced earlier in this same loop iteration (same-actor fusion: no
    channel, no copy).
    """

    method_name: str
    args: tuple
    kwargs: dict
    node_pos: int                      # position in the global topo order
    out_channel: int | None            # index into the program's channels


@dataclass
class ActorProgram:
    steps: list[StepSpec]
    # channel index -> spec; this actor opens only the ones its steps use
    channels: dict[int, ChannelSpec] = field(default_factory=dict)
    input_channel: int | None = None   # index of the driver input channel
    # Overlap pass (ref: dag_node_operation.py:325,576 — per-actor op
    # reordering that starts READs before COMPUTE): every channel the
    # tick will read is acquired and deserialized on prefetch threads at
    # tick start, so waits on one upstream overlap with deserializing
    # another and with this actor's own earlier compute steps.
    overlap: bool = True


class _PropagatedError:
    """An upstream step failed; carried as a value so the pipeline keeps
    flowing and the error reaches the driver through the output channel."""

    __slots__ = ("err",)

    def __init__(self, err: Exception):
        self.err = err


def _templates(step: StepSpec):
    return list(step.args) + list(step.kwargs.values())


def exec_loop(actor_instance, program: ActorProgram) -> dict:
    """Runs inside the actor's worker (dispatched by the worker's
    TaskExecutor for ``EXEC_LOOP_METHOD``).  Opens this actor's
    channels, then loops: read inputs → run steps → write outputs, until
    any channel is closed by teardown.  Returns ``{"iterations": n}``."""
    opened: dict[int, ShmChannel] = {
        idx: ShmChannel(spec.path, create=False)
        for idx, spec in program.channels.items()}

    # Channels this program reads each tick (for the overlap prefetch).
    read_idxs: set[int] = set()
    for step in program.steps:
        for kind, payload in _templates(step):
            if kind == "chan":
                read_idxs.add(payload)
            elif kind == "input":
                read_idxs.add(payload[0])
    pool = None
    if program.overlap and len(read_idxs) > 1:
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

        pool = ThreadPoolExecutor(max_workers=len(read_idxs),
                                  thread_name_prefix="dag-read")

    iterations = 0
    try:
        while True:
            # One pipeline tick: values this iteration produced/read.
            local: dict[int, Any] = {}      # node_pos -> value
            chan_vals: dict[int, Any] = {}  # channel idx -> value
            reading: list[ShmChannel] = []
            prefetched: dict[int, Any] = {}
            if pool is not None:
                # Overlap pass: all reads in flight before any compute.
                for idx in read_idxs:
                    prefetched[idx] = pool.submit(
                        opened[idx].begin_read_tagged)

            def fetch_chan(idx: int):
                if idx not in chan_vals:
                    ch = opened[idx]
                    fut = prefetched.pop(idx, None)
                    tag, value = (fut.result() if fut is not None
                                  else ch.begin_read_tagged())
                    reading.append(ch)
                    chan_vals[idx] = (_PropagatedError(value)
                                      if tag == "error" else value)
                return chan_vals[idx]

            try:
                for step in program.steps:
                    try:
                        args = [_resolve(t, fetch_chan, local)
                                for t in step.args]
                        kwargs = {k: _resolve(t, fetch_chan, local)
                                  for k, t in step.kwargs.items()}
                        failed = next(
                            (v for v in [*args, *kwargs.values()]
                             if isinstance(v, _PropagatedError)), None)
                        if failed is not None:
                            result = failed
                        else:
                            method = getattr(actor_instance,
                                             step.method_name)
                            result = method(*args, **kwargs)
                    except ChannelClosedError:
                        # Teardown closed a channel this tick reads: the
                        # loop ends here.  (The JAX package's loop turns
                        # it into an error value and may still publish
                        # that into a channel not closed yet, counting
                        # one more iteration than the driver executed.)
                        raise
                    except Exception as e:  # noqa: BLE001 — propagated
                        result = _PropagatedError(e)
                    local[step.node_pos] = result
                    if step.out_channel is not None:
                        out = opened[step.out_channel]
                        if isinstance(result, _PropagatedError):
                            out.write_error(result.err)
                        else:
                            out.write(result)
            finally:
                for ch in reading:
                    ch.end_read()
            iterations += 1
    except ChannelClosedError:
        pass  # teardown
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
        for ch in opened.values():
            ch.close()
    return {"iterations": iterations}


def _resolve(template, fetch_chan, local):
    kind, payload = template
    if kind == "const":
        return payload
    if kind == "chan":
        return fetch_chan(payload)
    if kind == "input":
        value = fetch_chan(payload[0])
        if isinstance(value, _PropagatedError):
            return value
        return value[payload[1]]
    if kind == "local":
        return local[payload]
    raise AssertionError(f"unknown template {kind}")


class CompiledDAGRef:
    """Handle to one in-flight compiled-DAG execution (ref:
    python/ray/experimental/compiled_dag_ref.py).  Results must be
    consumed in submission order — the output channel is a stream."""

    def __init__(self, dag: "ChannelCompiledDAG", version: int):
        self._dag = dag
        self._version = version
        self._value: Any = None
        self._done = False

    def get(self, timeout: float | None = None):
        if not self._done:
            self._dag._drain_until(self._version, timeout)
            self._value = self._dag._results.pop(self._version)
            self._done = True
        if isinstance(self._value, Exception):
            raise self._value
        return self._value


class ChannelCompiledDAG:
    """Driver-side compiled graph: creates the channels, starts the
    per-actor exec loops, and pumps input/output."""

    def __init__(self, output_node, buffer_size_bytes: int = 8 << 20,
                 overlap: bool = True):
        from ant_ray_tpu_torch.dag.nodes import ActorMethodNode, InputNode  # noqa: PLC0415

        self._buffer = buffer_size_bytes
        self._overlap = overlap
        self._output_node = output_node
        order = output_node._topology()
        self._order = order
        pos = {id(n): i for i, n in enumerate(order)}

        actor_nodes = [n for n in order
                       if isinstance(n, ActorMethodNode)]
        input_nodes = [n for n in order if isinstance(n, InputNode)]
        if not actor_nodes or len(actor_nodes) + len(input_nodes) != \
                len(order):
            raise ValueError(
                "channel compilation requires a graph of actor-method "
                "nodes (+ inputs); use .execute() for task graphs")

        # consumers[node_pos] = set of actor ids that read that node
        consumers: dict[int, set] = {}
        for n in actor_nodes:
            for child in n._children():
                consumers.setdefault(pos[id(child)], set()).add(
                    n._handle.actor_id)

        # Input channel: read once per iteration by each actor that
        # consumes any InputNode.
        input_consumer_actors = {
            n._handle.actor_id for n in actor_nodes
            if any(isinstance(c, InputNode) for c in n._children())}
        if not input_consumer_actors:
            # Without an input channel the exec loops would free-run on
            # output backpressure alone, decoupled from execute() calls —
            # diverging from one-execution-per-execute semantics.  Such
            # graphs stay on the interpreted executor.
            raise ValueError(
                "channel compilation requires an InputNode feeding the "
                "graph")

        self._dir = os.path.join(channel_dir(),
                                 f"dag_{uuid.uuid4().hex[:10]}")
        self._channel_specs: dict[int, ChannelSpec] = {}

        def make_channel(tag: str, readers: int) -> int:
            idx = len(self._channel_specs)
            self._channel_specs[idx] = ChannelSpec(
                path=os.path.join(self._dir, f"{tag}_{idx}"),
                capacity=self._buffer, num_readers=readers)
            return idx

        self._input_chan = make_channel("in", len(input_consumer_actors))

        # Output channels: one per node consumed by a DIFFERENT actor,
        # plus the final output (read by the driver).
        node_chan: dict[int, int] = {}
        for n in actor_nodes:
            p = pos[id(n)]
            other_actors = {a for a in consumers.get(p, set())
                            if a != n._handle.actor_id}
            readers = len(other_actors) + (1 if n is output_node else 0)
            if readers:
                node_chan[p] = make_channel(f"n{p}", readers)
        self._node_chan = node_chan

        # Per-actor programs, steps in topo order.
        programs: dict = {}
        handles: dict = {}
        for n in actor_nodes:
            aid = n._handle.actor_id
            prog = programs.get(aid)
            if prog is None:
                prog = programs[aid] = ActorProgram(steps=[],
                                                    overlap=self._overlap)
                handles[aid] = n._handle
            p = pos[id(n)]
            args = tuple(self._template(a, pos, aid)
                         for a in n._bound_args)
            kwargs = {k: self._template(v, pos, aid)
                      for k, v in n._bound_kwargs.items()}
            prog.steps.append(StepSpec(
                method_name=n._method_name, args=args, kwargs=kwargs,
                node_pos=p, out_channel=node_chan.get(p)))

        # Wire channel specs into each program (only the ones it touches).
        for prog in programs.values():
            used: set[int] = set()
            for step in prog.steps:
                if step.out_channel is not None:
                    used.add(step.out_channel)
                for kind, payload in _templates(step):
                    if kind == "chan":
                        used.add(payload)
                    elif kind == "input":
                        used.add(payload[0])
            prog.channels = {i: self._channel_specs[i] for i in used}

        self._programs = programs
        self._handles = handles
        self._started = False
        self._closed = False
        self._loop_refs: list = []
        self._driver_in: ShmChannel | None = None
        self._driver_out: ShmChannel | None = None
        self._submitted = 0
        self._results: dict[int, Any] = {}
        self._drained = 0

    def _template(self, value, pos, actor_id):
        from ant_ray_tpu_torch.dag.nodes import (  # noqa: PLC0415
            ActorMethodNode,
            DAGNode,
            InputNode,
        )

        if isinstance(value, InputNode):
            return ("input", (self._input_chan, value._index))
        if isinstance(value, ActorMethodNode):
            p = pos[id(value)]
            if value._handle.actor_id == actor_id:
                return ("local", p)       # same-actor fusion: no channel
            return ("chan", self._node_chan[p])
        if isinstance(value, DAGNode):
            raise ValueError("unsupported DAG node type in channel mode")
        return ("const", value)

    # ------------------------------------------------------------ start

    def _start(self):
        from ant_ray_tpu_torch.actor import ActorMethod  # noqa: PLC0415

        # Create every channel file up front (driver owns the files).
        os.makedirs(self._dir, exist_ok=True)
        self._creators = {
            idx: ShmChannel(spec.path, capacity=spec.capacity,
                            num_readers=spec.num_readers, create=True)
            for idx, spec in self._channel_specs.items()}
        self._driver_in = self._creators[self._input_chan]
        out_pos = self._order.index(self._output_node)
        self._driver_out = self._creators[self._node_chan[out_pos]]

        for aid, prog in self._programs.items():
            # Reserved method name, dispatched by the worker's
            # TaskExecutor (bypasses __getattr__'s public-name check).
            method = ActorMethod(self._handles[aid], EXEC_LOOP_METHOD, 1)
            self._loop_refs.append(method.remote(prog))
        self._started = True

    # ------------------------------------------------------------ api

    def execute(self, *input_args):
        if self._closed:
            raise RuntimeError(
                "this compiled DAG was torn down; call "
                "experimental_compile() again for a fresh pipeline")
        if not self._started:
            self._start()
        self._submitted += 1
        # The pipeline has a finite depth (one in-flight version per
        # channel).  When it is full, the input write blocks until a
        # stage releases — which can require the DRIVER to drain
        # finished results first (it is the output channel's reader).
        # So: poll results between short write attempts instead of
        # blocking forever (ref: CompiledDAG buffered results).
        while True:
            self._poll_results()
            try:
                self._driver_in.write(tuple(input_args), timeout=0.05)
                break
            except ChannelTimeoutError:
                # A dead stage actor would stall the pipeline forever;
                # surface it instead of spinning.
                self._check_loops()
        return CompiledDAGRef(self, self._submitted)

    def _check_loops(self):
        """Raise if any exec loop terminated while the DAG is live (actor
        death or an internal loop failure — either way the pipeline is
        wedged).  An actor's death surfaces as the ``ActorDiedError``
        that its loop's ref raised, chained as the cause."""
        if not self._loop_refs:
            return
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        ready, _ = art.wait(self._loop_refs, num_returns=1, timeout=0.001)
        if not ready:
            return
        try:
            art.get(ready[0])
        except Exception as e:
            raise RuntimeError(
                f"compiled DAG wedged: an exec-loop actor died ({e})"
            ) from e
        raise RuntimeError(
            "compiled DAG wedged: an exec loop exited before teardown")

    def _take(self, timeout: float) -> bool:
        try:
            _tag, value = self._driver_out.begin_read_tagged(timeout)
        except ChannelTimeoutError:
            return False
        self._driver_out.end_read()
        self._drained += 1
        self._results[self._drained] = value
        return True

    def _poll_results(self):
        """Non-blocking drain of finished results into the buffer."""
        while self._drained < self._submitted and self._take(0):
            pass

    def _drain_until(self, version: int, timeout: float | None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self._drained < version:
            remaining = (0.2 if deadline is None else
                         min(0.2, max(0.001,
                                      deadline - time.monotonic())))
            if self._take(remaining):
                continue
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError(
                    f"no new value within {remaining}s on "
                    f"{self._driver_out.path}")
            self._check_loops()  # dead actor ⇒ raise, don't hang

    def teardown(self):
        """Close every channel, wait for the exec loops to return (each
        loop's ref, in ``_loop_refs``, then holds ``{"iterations": n}``
        or the error that ended it), and unlink the channel files."""
        if not self._started:
            return
        for ch in self._creators.values():
            ch.close()
        # Loops exit on ChannelClosedError and the actor replies arrive;
        # collect them so the actors are provably idle again.
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        try:
            art.wait(self._loop_refs, num_returns=len(self._loop_refs),
                     timeout=10)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        for spec in self._channel_specs.values():
            try:
                os.unlink(spec.path)
            except OSError:
                pass
        try:
            os.rmdir(self._dir)
        except OSError:
            pass
        self._started = False
        # Channels and loop actors are gone; the object is terminal.
        self._closed = True
