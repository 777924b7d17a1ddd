"""Serialization: pickle-5 with out-of-band buffers + cloudpickle for code.

Equivalent role to the reference's serialization layer
(ref: python/ray/_private/serialization.py + the cloudpickle fork): data moves
zero-copy where possible (numpy buffers and tensors' bytes become out-of-band
PickleBuffers backed by shared memory on the receive side), functions and
actor classes go through cloudpickle, and ObjectRefs found inside values are
recorded so the ownership layer can track borrows.

A ``torch.Tensor`` travels as its value, as the JAX package sends a
``jax.Array``: its elements' raw bytes (fetched to the host if the tensor
lives on a card) as ONE out-of-band buffer in stream order, beside its
dtype, shape and device type.  The deserializer rebuilds a plain,
contiguous tensor of that dtype and shape on the same device type (the
current CUDA device for a CUDA tensor), copying the bytes out of the
buffer.  What that means, case by case:

* dtypes numpy lacks (bfloat16, float8) cross unchanged: the bytes are
  never routed through ``Tensor.numpy()`` of the value's own dtype;
* a non-contiguous tensor, or a view into a larger storage, sends its
  own elements only;
* gradient tracking, ``nn.Parameter`` and other tensor subclasses are
  dropped: the result is a detached plain tensor (a value, like a jax
  array);
* the rebuilt tensor never aliases the buffer, so writes to it cannot
  reach a stored object in the shared-memory arena;
* a CUDA tensor deserialized in a process without a CUDA device raises
  ``RuntimeError``; it never lands on the CPU.
"""

from __future__ import annotations

import io
import os
import pickle
import sys
import threading
import types
import warnings
from dataclasses import dataclass
from typing import Any

import cloudpickle


def _torch_if_loaded():
    """torch, ONLY if this process already imported it: a value can be a
    tensor only when torch is loaded, so the SERIALIZE-side probe never
    pulls torch's multi-second import onto a reply path of a process
    that moves plain values (the counterpart of the JAX package's
    ``_jax_if_loaded``).  While another thread is still importing
    torch, ``sys.modules`` holds a partial module without ``Tensor``: no
    tensor exists yet, so the probe answers None (reading ``Tensor`` off
    it would raise, and an error reply being serialized then was lost).
    """
    torch = sys.modules.get("torch")
    return torch if getattr(torch, "Tensor", None) is not None else None


@dataclass
class SerializedObject:
    """A serialized value: a metadata pickle stream + raw buffers."""

    inband: bytes          # pickle-5 stream (buffers externalized)
    buffers: list[bytes | memoryview]
    contained_refs: list   # ObjectRefs found inside the value
    _header: bytes | None = None

    def total_bytes(self) -> int:
        return len(self.inband) + sum(len(b) for b in self.buffers)

    def _header_bytes(self) -> bytes:
        if self._header is None:
            self._header = pickle.dumps(
                (len(self.inband),
                 [memoryview(b).nbytes for b in self.buffers]),
                protocol=5)
        return self._header

    def payload_nbytes(self) -> int:
        """Exact wire size, without materializing the payload — lets the
        put path reserve an arena window and write straight into shared
        memory (one copy end-to-end instead of concat + copy)."""
        return (4 + len(self._header_bytes()) + len(self.inband)
                + sum(memoryview(b).nbytes for b in self.buffers))

    def to_payload(self) -> bytes:
        """Flatten to one contiguous byte string (header + inband + buffers)."""
        out = io.BytesIO()
        self._write_parts(out.write)
        return out.getvalue()

    def write_into(self, view: memoryview) -> None:
        """Write the payload directly into a writable buffer (an arena
        write grant) — the zero-intermediate-copy produce path."""
        pos = 0

        def sink(part):
            nonlocal pos
            n = memoryview(part).nbytes
            view[pos:pos + n] = part
            pos += n

        self._write_parts(sink)

    def _write_parts(self, write) -> None:
        header = self._header_bytes()
        write(len(header).to_bytes(4, "big"))
        write(header)
        write(self.inband)
        for b in self.buffers:
            write(b)

    @classmethod
    def from_payload(cls, payload: bytes | memoryview,
                     pin_owner=None) -> "SerializedObject":
        """Parse the wire form zero-copy: inband and buffers are
        memoryview slices of ``payload``.  When ``pin_owner`` is given
        (a zero-copy get from a pinned arena slot), each buffer slice is
        wrapped so deserialized arrays keep the pin alive for as long as
        they reference the shared memory (see _PinnedSlice)."""
        payload = memoryview(payload)
        hlen = int.from_bytes(payload[:4], "big")
        inband_len, buf_lens = pickle.loads(payload[4:4 + hlen])
        off = 4 + hlen
        inband = payload[off:off + inband_len]
        off += inband_len
        buffers = []
        for blen in buf_lens:
            mv = payload[off:off + blen]
            buffers.append(mv if pin_owner is None
                           else _pin_buffer(mv, pin_owner))
            off += blen
        return cls(inband=inband, buffers=buffers, contained_refs=[])


def _pin_buffer(mv: memoryview, owner):
    """A read-only buffer over ``mv`` whose consumers keep ``owner``
    (the client-side arena pin) alive: a numpy array deserialized
    zero-copy keeps it as its base, deferring the daemon-side ReadDone
    until the array is garbage collected — so the store can never
    recycle the slot under live readers (ref: plasma-backed read-only
    arrays).  Prefers the C-level art_native.PinnedBuffer (works on
    every CPython); falls back to the PEP 688 ``__buffer__`` wrapper on
    3.12+, and to a safe copy-out where neither is available (CPython
    < 3.12 can't export the buffer protocol from pure Python)."""
    from ant_ray_tpu_torch._private.native import load_native  # noqa: PLC0415

    native = load_native()
    if native is not None:
        return native.PinnedBuffer(mv.toreadonly(), owner)
    if sys.version_info >= (3, 12):
        return _PinnedSlice(mv, owner)
    return bytes(mv)


class _PinnedSlice:
    """Pure-Python fallback for _pin_buffer (PEP 688 ``__buffer__``,
    honored by CPython 3.12+ only — see _pin_buffer for the dispatch)."""

    __slots__ = ("_mv", "_owner")

    def __init__(self, mv: memoryview, owner):
        self._mv = mv.toreadonly()
        self._owner = owner

    def __buffer__(self, flags):
        return self._mv

    def __len__(self):
        return self._mv.nbytes


_thread_local = threading.local()

_by_value_modules: set[str] = set()
_installed_top_levels: set[str] | None = None


def _is_installed_distribution(top_level: str) -> bool:
    """True if ``top_level`` belongs to any installed distribution
    (covers editable installs, whose __file__ points at the checkout)."""
    global _installed_top_levels
    if _installed_top_levels is None:
        try:
            from importlib import metadata  # noqa: PLC0415

            _installed_top_levels = set(metadata.packages_distributions())
        except Exception:  # noqa: BLE001 — no metadata, assume script
            _installed_top_levels = set()
    return top_level in _installed_top_levels


def _register_driver_module_by_value(obj: Any) -> None:
    """Ship driver-script code by value.

    cloudpickle pickles module-level functions/classes by reference,
    which breaks when the worker can't import the driver's module (a
    test file, a user script run from a checkout).  The reference's
    cloudpickle fork pickles driver code by value unconditionally; here
    we register any module that isn't installed (not under
    site-/dist-packages, not stdlib, not ant_ray_tpu_torch itself) for
    by-value pickling, so classes and functions defined in driver
    scripts serialize self-contained.
    """
    module_name = getattr(obj, "__module__", None)
    if not module_name or module_name in _by_value_modules:
        return
    top = module_name.split(".")[0]
    if top in ("ant_ray_tpu_torch", "__main__", "builtins") or \
            top in sys.stdlib_module_names:
        return  # __main__ is already by-value in cloudpickle
    module = sys.modules.get(module_name)
    file = getattr(module, "__file__", None)
    if module is None or not file:
        return
    norm = file.replace(os.sep, "/")
    if "site-packages" in norm or "dist-packages" in norm:
        return
    if _is_installed_distribution(top):
        # pip install -e / conda source checkouts: importable on workers
        # under their own name — shipping by value would fork the class
        # identity (worker-side isinstance against its own import fails).
        return
    try:
        cloudpickle.register_pickle_by_value(module)
        _by_value_modules.add(module_name)
    except Exception:  # noqa: BLE001 — fall back to by-reference
        pass


# bytes/bytearray above this size are shipped out-of-band (zero-copy on
# the serialize side) instead of being copied into the pickle stream.
_OOB_BYTES_THRESHOLD = 64 * 1024


class _ValuePickler(cloudpickle.Pickler):
    """Hot-path pickler (module-level: defining a class per serialize()
    call costs ~20µs, visible at 10k calls/s)."""

    def reducer_override(self, obj):
        t = type(obj)
        if t is bytes or t is bytearray:
            # Large raw byte blobs go out-of-band: the pickle stream
            # carries only a NEXT_BUFFER marker, buffer_callback gets a
            # zero-copy view of the original object.
            if len(obj) > _OOB_BYTES_THRESHOLD:
                return (t, (pickle.PickleBuffer(obj),))
            return NotImplemented
        torch = _torch_if_loaded()
        if torch is not None and isinstance(obj, torch.Tensor):
            return _reduce_tensor(torch, obj)
        if isinstance(obj, (type, types.FunctionType)):
            _register_driver_module_by_value(obj)
        # Defer to cloudpickle's own reducer_override (it implements
        # local-function/class support there, not in dispatch).
        return super().reducer_override(obj)


# Fast-path eligibility: exact scalar types (subclasses may carry
# reducers), short strings/bytes (large ones benefit from out-of-band
# buffer externalization), and shallow small containers of the same.
# These values cannot contain ObjectRefs, tensors, or anything else
# the custom pickler handles — plain pickle.dumps is byte-compatible
# with what the full pickler would emit and an order of magnitude
# cheaper (no pickler construction, no reducer dispatch, no BytesIO).
_SIMPLE_TYPES = frozenset({int, float, bool, type(None)})
_SIMPLE_SIZED = frozenset({str, bytes})
_SIMPLE_MAX_SIZED = 4096
_SIMPLE_MAX_ITEMS = 8


def _is_simple(value: Any, depth: int = 2) -> bool:
    t = type(value)
    if t in _SIMPLE_TYPES:
        return True
    if t in _SIMPLE_SIZED:
        return len(value) <= _SIMPLE_MAX_SIZED
    if depth:
        if t is tuple or t is list:
            return (len(value) <= _SIMPLE_MAX_ITEMS
                    and all(_is_simple(v, depth - 1) for v in value))
        if t is dict:
            return (len(value) <= _SIMPLE_MAX_ITEMS
                    and all(type(k) is str and _is_simple(v, depth - 1)
                            for k, v in value.items()))
    return False


def serialize(value: Any) -> SerializedObject:
    # Scalar fast path: the overwhelmingly common actor-call reply /
    # small-args shape on the control-plane hot path.
    if _is_simple(value):
        return SerializedObject(
            inband=pickle.dumps(value, protocol=5), buffers=[],
            contained_refs=[])
    buffers: list = []
    contained_refs: list = []

    # Track refs discovered by ObjectRef.__reduce__ during pickling.
    prev = getattr(_thread_local, "ref_sink", None)
    _thread_local.ref_sink = contained_refs

    def buffer_callback(pb: pickle.PickleBuffer) -> bool:
        buffers.append(pb.raw())
        return False  # externalize

    out = io.BytesIO()
    try:
        pickler = _ValuePickler(out, protocol=5,
                                buffer_callback=buffer_callback)
        pickler.dump(value)
    finally:
        _thread_local.ref_sink = prev
    return SerializedObject(
        inband=out.getvalue(), buffers=buffers, contained_refs=contained_refs
    )


def _reduce_tensor(torch, tensor):
    """Reduce a tensor to its value: the bytes of its elements as one
    ``PickleBuffer``, which the pickle-5 machinery externalizes in stream
    order (a separate index-based buffer table would corrupt the
    NEXT_BUFFER consumption order of other buffers)."""
    if tensor.layout != torch.strided:
        raise TypeError(f"cannot serialize a {tensor.layout} tensor; "
                        "only strided (dense) tensors are supported")
    host = tensor.detach().resolve_conj().resolve_neg()
    if host.device.type != "cpu":
        host = host.cpu()     # waits for the card; pageable host memory
    raw = host.contiguous().reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(host.dtype).removeprefix("torch."),
             tuple(host.shape), tensor.device.type))


def _rebuild_tensor(buffer, dtype_name: str, shape: tuple, device_type: str):
    import torch  # noqa: PLC0415

    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a torch dtype: {dtype_name!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the object holds a CUDA tensor ({dtype_name}, shape "
            f"{list(shape)}) and this process has no CUDA device; it is "
            "not moved to the CPU")
    out = torch.empty(shape, dtype=dtype, device=device_type)
    if out.numel():
        # A CPU view of the buffer, read once by the copy: the result owns
        # its memory, so writes to it never reach the buffer (an arena
        # slot).  torch warns that the view is not writable; it is only
        # read.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(buffer, dtype=torch.uint8)
        out.view(-1).view(torch.uint8).copy_(src)
    return out


def deserialize(obj: SerializedObject) -> Any:
    buffers = [memoryview(b) for b in obj.buffers]
    return pickle.loads(obj.inband, buffers=iter(buffers))


class _RefFinder(pickle.Unpickler):
    """Unpickles a payload only to find the ObjectRefs inside it: every
    tensor stays unbuilt (None), so no bytes are copied and no device is
    touched."""

    def __init__(self, file, buffers, found: list):
        super().__init__(file, buffers=buffers)
        self._found = found

    def find_class(self, module, name):
        if module == __name__ and name == "_rebuild_tensor":
            return _unbuilt_tensor
        found = super().find_class(module, name)
        if module == "ant_ray_tpu_torch.object_ref" and \
                name == "_deserialize_ref":
            def collect(*args):
                ref = found(*args)
                self._found.append(ref)
                return ref
            return collect
        return found


def _unbuilt_tensor(*_args):
    return None


def refs_in(payload) -> list:
    """The ObjectRefs inside a serialized payload, found without building
    its tensors: what a proxy pins for a value it forwards untouched
    (util/client/server.py)."""
    obj = SerializedObject.from_payload(payload)
    found: list = []
    _RefFinder(io.BytesIO(obj.inband),
               iter([memoryview(b) for b in obj.buffers]), found).load()
    return found


def record_contained_ref(ref) -> None:
    """Called from ObjectRef.__reduce__ while a serialize() is in flight."""
    sink = getattr(_thread_local, "ref_sink", None)
    if sink is not None:
        sink.append(ref)


def dumps_code(obj: Any) -> bytes:
    """Serialize a function/class definition (cloudpickle)."""
    _register_driver_module_by_value(obj)
    return cloudpickle.dumps(obj)


def loads_code(data: bytes) -> Any:
    return cloudpickle.loads(data)


def serialize_error(exc: BaseException) -> SerializedObject:
    try:
        return serialize(exc)
    except Exception:
        # Unpicklable exception: degrade to a plain TaskError-style message.
        from ant_ray_tpu_torch.exceptions import TaskError  # noqa: PLC0415

        return serialize(TaskError("<unknown>", None, repr(exc)))
