"""Checkpoints: directory-backed handles + pytree save/load + a top-K
retention manager (ref: train/v2/_internal/execution/checkpoint/ +
storage.py): a copy of the JAX package's ``train/checkpoint.py`` whose
orbax pytree format becomes the port's own — one ``torch.save`` file of
the flattened tree with every tensor copied to the host, read back with
``weights_only=True`` and its tensors put on the device the loader
names.  The atomic-save protocol (``.tmp-`` sibling, rename, ``.old-``
adoption) is the reference's, word for word."""

from __future__ import annotations

import io
import logging
import os
import shutil
import tarfile
import tempfile
import uuid
from dataclasses import dataclass

logger = logging.getLogger(__name__)

# Non-final artifacts of the atomic-save / replica-materialize dance;
# restore scans MUST ignore them (and may sweep stale ones).
_TMP_MARKERS = (".tmp-", ".old-")


@dataclass(frozen=True)
class Checkpoint:
    """A handle to a checkpoint directory (ref: ray.train.Checkpoint).

    ``replica``: optional ObjectRef of the packed directory in the
    in-cluster object store (CheckpointConfig.replicate).  When the
    directory path is not visible from the reading process's node (no
    shared storage), ``as_directory``/``to_pytree`` materialize the
    checkpoint from the replica — pulled over the bulk transfer
    channel at object-plane bandwidth."""

    path: str
    replica: "object | None" = None

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))

    def with_replica(self, ref) -> "Checkpoint":
        return Checkpoint(path=self.path, replica=ref)

    def as_directory(self) -> str:
        if os.path.isdir(self.path) or self.replica is None:
            return self.path
        return self._materialize_replica()

    def _materialize_replica(self) -> str:
        """Unpack the object-store replica into a node-local cache dir
        (shared by colocated readers).  Keyed by the replica ref's
        object id, not just the checkpoint path — a later fit reusing
        the same storage_path/name/index must never restore a previous
        run's weights from a stale cache entry."""
        import ant_ray_tpu_torch as art  # noqa: PLC0415

        dest = os.path.join(
            tempfile.gettempdir(), "art_ckpt_replicas",
            f"{self.path.strip(os.sep).replace(os.sep, '_')}"
            f"-{self.replica.hex()[:16]}")
        if os.path.isdir(dest):
            return dest
        data = art.get(self.replica)
        unpack_checkpoint(data, dest)
        logger.info("materialized checkpoint replica for %s (%d bytes)",
                    self.path, len(data))
        return dest

    # ---- pytree convenience

    @classmethod
    def from_pytree(cls, tree, path: str) -> "Checkpoint":
        save_pytree(tree, path)
        return cls(path=os.path.abspath(path))

    def to_pytree(self, abstract_tree=None, device=None):
        return load_pytree(self.as_directory(), abstract_tree,
                           device=device)


#: The file of a pytree checkpoint inside its directory.
PYTREE_FILE = "pytree.pt"


def _write_tree(tree, directory: str) -> None:
    """One ``torch.save`` file of ``tree``: its structure (dict keys
    sorted, lists and tuples in order), and each leaf as a host tensor
    (torch tensors and numpy arrays, with which kind it was) or as the
    plain value it is (int, float, str, bool, None)."""
    import numpy as np  # noqa: PLC0415
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch.util.collective.fusion import flatten_pytree  # noqa: PLC0415

    leaves, treedef = flatten_pytree(tree)
    kinds, stored = [], []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            kinds.append("torch")
            stored.append(_compact(leaf.detach().cpu()))
        elif isinstance(leaf, (np.ndarray, np.generic)):
            kinds.append("numpy")
            stored.append(torch.from_numpy(np.array(leaf)))
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            kinds.append("value")
            stored.append(leaf)
        else:
            raise TypeError(f"cannot checkpoint a {type(leaf).__name__} "
                            "leaf; leaves are tensors, numpy arrays or "
                            "plain values")
    os.makedirs(directory)
    torch.save({"treedef": treedef, "kinds": kinds, "leaves": stored},
               os.path.join(directory, PYTREE_FILE))


def _compact(t):
    """``t`` alone in a storage of its own size: ``torch.save`` writes a
    tensor's whole storage, so a view is copied out first."""
    if t.is_contiguous() and t.storage_offset() == 0 and \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.contiguous().clone()


def save_pytree(tree, path: str) -> None:
    """Atomic save: write to a ``.tmp-`` sibling, then rename
    into place — a crash mid-save can never destroy the previous
    checkpoint at ``path`` (the old destroy-then-save order lost it),
    and a torn write is never visible under the final name.  Restore
    scans ignore ``.tmp-``/``.old-`` leftovers."""
    path = os.path.abspath(path)
    nonce = uuid.uuid4().hex[:8]
    tmp = f"{path}.tmp-{nonce}"
    try:
        _write_tree(tree, tmp)
        if os.path.exists(path):
            # Two renames, no window where neither copy exists: the old
            # dir steps aside (ignored by restores), the complete new
            # one takes the name, then the old is reaped.
            old = f"{path}.old-{nonce}"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def pack_checkpoint_dir(path: str) -> bytes:
    """Checkpoint directory -> one replicable blob (tar, uncompressed —
    checkpoints are mostly incompressible array bytes and the object
    plane moves them at wire speed)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(path, arcname=".")
    return buf.getvalue()


def unpack_checkpoint(data: bytes, dest: str) -> str:
    """Atomically materialize a packed checkpoint at ``dest`` (unpack
    into a tmp sibling, rename; a concurrent reader either sees the
    complete directory or none)."""
    dest = os.path.abspath(dest)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = f"{dest}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        with tarfile.open(fileobj=io.BytesIO(data)) as tar:
            try:
                tar.extractall(tmp, filter="data")
            except TypeError:       # pre-3.12 tarfile: no filter arg
                tar.extractall(tmp)  # noqa: S202 — self-produced blob
        try:
            os.rename(tmp, dest)
        except OSError:
            if not os.path.isdir(dest):   # lost a race to a peer: fine
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dest


def _adopt_orphaned_old(path: str) -> None:
    """Close save_pytree's two-rename crash window: a kill between
    `rename(path, old)` and `rename(tmp, path)` leaves the complete
    previous checkpoint ONLY under the ``.old-`` name — adopt it back
    so the acked steps it represents are not lost."""
    if os.path.exists(path):
        return
    import glob as _glob  # noqa: PLC0415

    orphans = sorted(_glob.glob(path + ".old-*"), key=os.path.getmtime)
    if orphans:
        try:
            os.rename(orphans[-1], path)
            logger.warning("adopted orphaned checkpoint %s -> %s "
                           "(crash mid-swap)", orphans[-1], path)
        except OSError:   # lost a race to a concurrent adopter: fine
            pass


def load_pytree(path: str, abstract_tree=None, device=None):
    """The tree saved at ``path``: torch leaves as tensors on ``device``
    (default: the host), numpy leaves as numpy arrays, plain values as
    they were.  ``abstract_tree``, where given, is a tree of the same
    structure (its leaves' values are not read); a checkpoint of
    another structure raises."""
    import torch  # noqa: PLC0415

    from ant_ray_tpu_torch.util.collective.fusion import (  # noqa: PLC0415
        flatten_pytree,
        unflatten_pytree,
    )

    path = os.path.abspath(path)
    _adopt_orphaned_old(path)
    saved = torch.load(os.path.join(path, PYTREE_FILE), weights_only=True)
    if abstract_tree is not None and \
            flatten_pytree(abstract_tree)[1] != saved["treedef"]:
        raise ValueError(f"checkpoint {path} does not have the structure "
                         "of abstract_tree")
    leaves = []
    for kind, leaf in zip(saved["kinds"], saved["leaves"]):
        if kind == "torch":
            leaves.append(leaf if device is None else leaf.to(device))
        elif kind == "numpy":
            leaves.append(leaf.numpy())
        else:
            leaves.append(leaf)
    return unflatten_pytree(saved["treedef"], leaves)


class CheckpointManager:
    """Controller-side retention of reported checkpoints (top-K by
    recency; ref: CheckpointManager keeps top-K)."""

    # Per-fit token file: <storage>/.run_token names the CURRENT fit;
    # each registered checkpoint carries a copy inside its dir.  A
    # controller-death restore adopts ONLY token-matching checkpoints,
    # so a previous same-named run's leftovers are never resumed from —
    # and nothing is ever deleted up front (a relaunch that crashes
    # before its first checkpoint must not have destroyed the old ones).
    _TOKEN_FILE = ".run_token"

    def __init__(self, storage_path: str, num_to_keep: int | None = None,
                 restore: bool = False, run_token: str | None = None):
        import uuid  # noqa: PLC0415

        self._storage_path = storage_path
        self._num_to_keep = num_to_keep
        self._checkpoints: list[Checkpoint] = []
        os.makedirs(storage_path, exist_ok=True)
        token_path = os.path.join(storage_path, self._TOKEN_FILE)
        # The fit's token comes from the TRAINER when it drives the
        # controller (one token for every incarnation of one fit, so a
        # pre-first-checkpoint controller death can't resurrect a
        # previous run's token); standalone use generates one.
        self._token = run_token or ""
        if restore:
            if not self._token:
                try:
                    with open(token_path) as f:
                        self._token = f.read().strip()
                except OSError:
                    self._token = ""
            # A crash inside save_pytree's two-rename swap can leave
            # the newest complete checkpoint only under its .old- name
            # — rescue those before scanning (see _adopt_orphaned_old).
            for name in os.listdir(storage_path):
                base, sep, _rest = name.partition(".old-")
                if sep and base.startswith("checkpoint_"):
                    _adopt_orphaned_old(os.path.join(storage_path, base))
            # Restore — OPT-IN (a recreated controller after controller
            # death): adopt this fit's checkpoints, identified by token.
            for name in sorted(os.listdir(storage_path)):
                path = os.path.join(storage_path, name)
                if name.startswith("checkpoint_") and os.path.isdir(path):
                    try:
                        int(name.rsplit("_", 1)[1])
                    except (ValueError, IndexError):
                        continue
                    if self._token and self._read_token(path) == \
                            self._token:
                        self._checkpoints.append(
                            Checkpoint.from_directory(path))
        else:
            self._token = self._token or uuid.uuid4().hex
            with open(token_path, "w") as f:
                f.write(self._token)

    @classmethod
    def _read_token(cls, checkpoint_dir: str) -> str | None:
        try:
            with open(os.path.join(checkpoint_dir, cls._TOKEN_FILE)) as f:
                return f.read().strip()
        except OSError:
            return None

    @property
    def latest(self) -> Checkpoint | None:
        return self._checkpoints[-1] if self._checkpoints else None

    @property
    def next_index(self) -> int:
        """First unused checkpoint index: highest existing index ON
        DISK + 1 (adopted or not — a restore that declines foreign
        dirs must not start overwriting them either), monotonic across
        controller incarnations."""
        best = -1
        try:
            for name in os.listdir(self._storage_path):
                if name.startswith("checkpoint_"):
                    try:
                        best = max(best, int(name.rsplit("_", 1)[1]))
                    except (ValueError, IndexError):
                        continue
        except OSError:
            pass
        return best + 1

    def register(self, checkpoint: Checkpoint) -> None:
        try:
            # Stamp the fit's token into the dir (see _TOKEN_FILE note).
            with open(os.path.join(checkpoint.path,
                                   self._TOKEN_FILE), "w") as f:
                f.write(self._token)
        except OSError as e:
            # An unstamped checkpoint is invisible to a controller-
            # death restore — losable progress deserves a breadcrumb.
            import logging  # noqa: PLC0415

            logging.getLogger(__name__).warning(
                "could not stamp run token into %s (%s); this "
                "checkpoint will not be adopted by a restore",
                checkpoint.path, e)
        # Only the LATEST checkpoint keeps an object-store replica:
        # dropping older entries' refs frees their packed blobs, so a
        # keep-all run doesn't pin every checkpoint in store memory
        # (recovery only ever restores the newest).
        for i, stale in enumerate(self._checkpoints):
            if getattr(stale, "replica", None) is not None:
                self._checkpoints[i] = Checkpoint(path=stale.path)
        self._checkpoints.append(checkpoint)
        if self._num_to_keep is not None:
            # Normalized containment check: checkpoint paths are
            # abspathed, so a relative storage_path would never prefix-
            # match (silently disabling retention), and a bare prefix
            # without the trailing separator could cross sibling dirs
            # ("/a/exp10" startswith "/a/exp1").
            root = os.path.abspath(self._storage_path) + os.sep
            while len(self._checkpoints) > self._num_to_keep:
                stale = self._checkpoints.pop(0)
                if stale.path.startswith(root):
                    shutil.rmtree(stale.path, ignore_errors=True)

    def next_checkpoint_dir(self, index: int) -> str:
        return os.path.join(self._storage_path, f"checkpoint_{index:06d}")
