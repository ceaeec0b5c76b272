"""Checkpointing in the JAX package's format: metric-keyed retention, top-k
averaging, resume.

Counterpart of ``speech_anonymization_tpu/train/checkpoint.py``, with the
same behaviour:

  * ``save_and_keep_only(meta, min_keys, max_keys, num_to_keep)``: metric-keyed
    retention (the anonymizer keeps the top 5 by Utility_Retention,
    ACC_external and ACC_dist);
  * ``recover_if_possible``: resume from the newest (or best-keyed) checkpoint;
  * ``find_checkpoints(max_key/min_key)`` and :func:`average_checkpoints`:
    parameter averaging before evaluation;
  * ``maybe_save_interval``: time-based saving (``ckpt_interval_minutes``);
  * ``async_writes``: serialization and disk IO on one background thread,
    FIFO, retention inside its queue; every read path drains it first.

**The format is the JAX package's**, so checkpoints interchange both ways: a
directory ``CKPT+<%Y-%m-%d+%H-%M-%S>+<seq>/`` holding ``{name}.ckpt`` per
recoverable and ``CKPT.yaml`` (a ``# checkpoint meta`` line, then one
``key: <json>`` line per meta entry), written to ``<dir>.tmp`` and renamed
into place. Tree state (:class:`PytreeRecoverable`: parameters, BatchNorm
statistics, the normalizer) is flax msgpack (``utils/msgpack.py``) of the
JAX recipe's trees, with every map's keys sorted as ``jax.device_get`` leaves
them; host objects with ``state_dict`` (the epoch counter, Noam) are JSON.
The snapshot is taken on the caller's thread and copies every tensor: the
port updates parameters in place, and on the CPU ``tensor.numpy()`` shares
their memory, so a view would record a later step's values.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..utils import msgpack

META_FILE = "CKPT.yaml"


class _AsyncWriter:
    """One background writer thread: saves run FIFO, so retention decisions
    always see every earlier save completed. Errors surface on the next
    submit()/wait() call. The thread drops each task once it has run, and
    holds no reference to the checkpointer, so a checkpointer (and the model
    its recoverables reach) is freed when its owner drops it."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # re-raised on the train thread by _raise_pending
                self._err = e
            finally:
                fn = None
                self._q.task_done()

    def submit(self, fn: Callable[[], None]):
        self._raise_pending()
        self._q.put(fn)

    def wait(self):
        self._q.join()
        self._raise_pending()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _write_meta(path: str, meta: Mapping):
    with open(path, "w") as f:
        f.write("# checkpoint meta\n")
        for k, v in meta.items():
            if isinstance(v, (np.floating, np.integer, torch.Tensor)):
                v = v.item()
            f.write(f"{k}: {json.dumps(v)}\n")


def _read_meta(path: str) -> dict:
    meta = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            k, _, v = line.partition(":")
            try:
                meta[k.strip()] = json.loads(v.strip())
            except json.JSONDecodeError:
                meta[k.strip()] = v.strip()
    return meta


def host_tree(tree) -> Any:
    """A copy of ``tree`` in host memory with every map's keys sorted (what
    ``jax.device_get`` gives the JAX package's writer): tensors are detached
    C-contiguous CPU copies, numpy arrays copies."""
    if isinstance(tree, dict):
        return {k: host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def read_tree(path: str) -> Any:
    """A ``.ckpt`` tree file -> its decoded tree (writable numpy leaves)."""
    with open(path, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    return msgpack.from_bytes(data)


def _missing_keys(template, tree, path: str = "") -> list[str]:
    """Keys of ``template``'s maps absent from ``tree`` (what flax's
    ``from_bytes`` refuses)."""
    template = msgpack.to_state_dict(template)
    if not isinstance(template, dict):
        return []
    if not isinstance(tree, dict):
        return [path or "/"]
    out = []
    for k, v in template.items():
        out += [f"{path}/{k}"] if k not in tree else _missing_keys(v, tree[k], f"{path}/{k}")
    return out


class PytreeRecoverable:
    """Tree state (parameters, statistics, ...) through get/set callables:
    ``get()`` gives the tree in the JAX package's layout, ``set(tree)`` takes
    the decoded one (maps of numpy leaves)."""

    def __init__(self, get: Callable[[], Any], set_: Callable[[Any], None]):
        self._get = get
        self._set = set_

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(msgpack.to_bytes(host_tree(self._get())))

    def load(self, path: str):
        tree = read_tree(path)
        missing = _missing_keys(self._get(), tree)
        if missing:
            raise ValueError(f"{path} lacks {missing[:8]}")
        self._set(tree)


class Checkpoint:
    def __init__(self, path: str, meta: Mapping | None = None):
        self.path = path
        # async saves pass the meta (the files may not be on disk yet)
        self.meta = dict(meta) if meta is not None else _read_meta(os.path.join(path, META_FILE))

    @property
    def name(self) -> str:
        return os.path.basename(self.path)


class Checkpointer:
    """``async_writes=True`` moves serialization and disk IO to a background
    thread; the caller's thread only copies the state to host memory. Readers
    never see a partial checkpoint (write to ``.tmp``, then an atomic rename),
    and every read path (find/recover/average) drains the writer first."""

    def __init__(self, checkpoints_dir: str, recoverables: Mapping[str, Any] | None = None,
                 async_writes: bool = False):
        self.checkpoints_dir = checkpoints_dir
        self.recoverables: dict[str, Any] = dict(recoverables or {})
        self._last_save_time = time.time()
        self._reserved: set[str] = set()
        self._writer: _AsyncWriter | None = None
        if async_writes:
            self._writer = _AsyncWriter()
            atexit.register(self._writer.wait)
        os.makedirs(checkpoints_dir, exist_ok=True)

    def wait(self):
        """Drain pending async saves (no-op in sync mode)."""
        if self._writer is not None:
            self._writer.wait()

    def add_recoverable(self, name: str, obj: Any):
        self.recoverables[name] = obj

    # -- save ---------------------------------------------------------------

    def _snapshot(self) -> list[tuple[str, str, Any]]:
        """A consistent host copy of every recoverable, taken on the caller's thread."""
        snap = []
        for rec_name, rec in self.recoverables.items():
            if isinstance(rec, PytreeRecoverable):
                snap.append(("pytree", rec_name, host_tree(rec._get())))
            elif hasattr(rec, "state_dict"):
                snap.append(("json", rec_name, json.dumps(rec.state_dict())))
            else:  # a raw tree
                snap.append(("pytree", rec_name, host_tree(rec)))
        return snap

    @staticmethod
    def _write_snapshot(snap, tmp: str, path: str, meta: Mapping):
        os.makedirs(tmp, exist_ok=True)
        for kind, rec_name, payload in snap:
            fpath = os.path.join(tmp, f"{rec_name}.ckpt")
            if kind == "json":
                with open(fpath, "w") as f:
                    f.write(payload)
            else:
                with open(fpath, "wb") as f:
                    f.write(msgpack.to_bytes(payload))
        _write_meta(os.path.join(tmp, META_FILE), meta)
        if os.path.exists(path):  # an explicit name collision: replace
            shutil.rmtree(path)
        os.replace(tmp, path)

    def save_checkpoint(self, meta: Mapping | None = None, name: str | None = None) -> Checkpoint:
        meta = dict(meta or {})
        meta.setdefault("unixtime", time.time())
        if name is None:
            stamp = time.strftime("%Y-%m-%d+%H-%M-%S")
            seq = 0
            while True:
                name = f"CKPT+{stamp}+{seq:02d}"
                # the reserved set covers async saves not yet on disk
                if name not in self._reserved and not os.path.exists(
                        os.path.join(self.checkpoints_dir, name)):
                    break
                seq += 1
        self._reserved.add(name)
        path = os.path.join(self.checkpoints_dir, name)
        tmp = path + ".tmp"
        snap = self._snapshot()
        if self._writer is not None:
            self._writer.submit(lambda: self._write_snapshot(snap, tmp, path, meta))
        else:
            self._write_snapshot(snap, tmp, path, meta)
        self._last_save_time = time.time()
        return Checkpoint(path, meta)

    def save_and_keep_only(self, meta: Mapping | None = None, min_keys: list[str] | None = None,
                           max_keys: list[str] | None = None, num_to_keep: int = 1) -> Checkpoint:
        ckpt = self.save_checkpoint(meta)
        if self._writer is not None:
            # in the writer's queue, after this save has landed: it sees every
            # earlier save and never races a write (wait() here would deadlock)
            self._writer.submit(lambda: self._apply_retention(min_keys, max_keys, num_to_keep))
        else:
            self._apply_retention(min_keys, max_keys, num_to_keep)
        return ckpt

    def _apply_retention(self, min_keys, max_keys, num_to_keep):
        keep = set()
        for key in max_keys or []:
            keep.update(c.path for c in self._find_checkpoints_nodrain(max_key=key, n=num_to_keep))
        for key in min_keys or []:
            keep.update(c.path for c in self._find_checkpoints_nodrain(min_key=key, n=num_to_keep))
        if not (min_keys or max_keys):
            keep.update(c.path for c in self._find_checkpoints_nodrain(n=num_to_keep))
        for c in self._list_checkpoints_nodrain():
            if c.path not in keep:
                self._reserved.discard(c.name)
                shutil.rmtree(c.path, ignore_errors=True)

    def maybe_save_interval(self, meta: Mapping | None = None, interval_minutes: float = 60.0):
        """Time-based checkpointing (``ckpt_interval_minutes``)."""
        if time.time() - self._last_save_time >= interval_minutes * 60.0:
            return self.save_checkpoint(meta)
        return None

    # -- find / load ---------------------------------------------------------

    def _list_checkpoints_nodrain(self) -> list[Checkpoint]:
        out = []
        for entry in sorted(os.listdir(self.checkpoints_dir)):
            path = os.path.join(self.checkpoints_dir, entry)
            # .tmp directories are writes in flight, never a checkpoint
            if (entry.startswith("CKPT") and not entry.endswith(".tmp") and os.path.isdir(path)
                    and os.path.exists(os.path.join(path, META_FILE))):
                out.append(Checkpoint(path))
        return out

    def list_checkpoints(self) -> list[Checkpoint]:
        self.wait()
        return self._list_checkpoints_nodrain()

    def _find_checkpoints_nodrain(self, max_key: str | None = None, min_key: str | None = None,
                                  n: int | None = None) -> list[Checkpoint]:
        ckpts = self._list_checkpoints_nodrain()
        if max_key:
            ckpts = [c for c in ckpts if max_key in c.meta]
            ckpts.sort(key=lambda c: c.meta[max_key], reverse=True)
        elif min_key:
            ckpts = [c for c in ckpts if min_key in c.meta]
            ckpts.sort(key=lambda c: c.meta[min_key])
        else:
            ckpts.sort(key=lambda c: c.meta.get("unixtime", 0), reverse=True)
        return ckpts[:n] if n else ckpts

    def find_checkpoints(self, max_key: str | None = None, min_key: str | None = None,
                         n: int | None = None) -> list[Checkpoint]:
        self.wait()
        return self._find_checkpoints_nodrain(max_key, min_key, n)

    def find_checkpoint(self, max_key=None, min_key=None) -> Checkpoint | None:
        found = self.find_checkpoints(max_key, min_key, n=1)
        return found[0] if found else None

    def load_checkpoint(self, ckpt: Checkpoint):
        for rec_name, rec in self.recoverables.items():
            fpath = os.path.join(ckpt.path, f"{rec_name}.ckpt")
            if not os.path.exists(fpath):
                continue
            if isinstance(rec, PytreeRecoverable):
                rec.load(fpath)
            elif hasattr(rec, "load_state_dict"):
                with open(fpath) as f:
                    rec.load_state_dict(json.load(f))

    def recover_if_possible(self, max_key=None, min_key=None) -> Checkpoint | None:
        ckpt = self.find_checkpoint(max_key, min_key)
        if ckpt is not None:
            self.load_checkpoint(ckpt)
        return ckpt


def recover_trees(checkpoints_dir: str, names, max_key: str | None = None,
                  min_key: str | None = None) -> dict:
    """The tree files ``names`` of the checkpoint ``find_checkpoint`` picks in
    ``checkpoints_dir`` -> ``{name: tree}``: how the loaders read a directory
    that another run (of either package) wrote."""
    ckpt = Checkpointer(checkpoints_dir).find_checkpoint(max_key, min_key)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoints_dir}")
    return {name: read_tree(os.path.join(ckpt.path, f"{name}.ckpt")) for name in names}


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def average_checkpoints(ckpts: list[Checkpoint], recoverable_name: str, template: Any) -> Any:
    """The mean of a tree recoverable over ``ckpts``: summed in their order,
    then divided by their count, leaf by leaf in the leaves' dtype (the JAX
    package's arithmetic); maps keyed as ``template``'s."""
    if not ckpts:
        raise ValueError("no checkpoints to average")
    template = msgpack.to_state_dict(template)
    total = None
    for c in ckpts:
        path = os.path.join(c.path, f"{recoverable_name}.ckpt")
        tree = read_tree(path)
        missing = _missing_keys(template, tree)
        if missing:
            raise ValueError(f"{path} lacks {missing[:8]}")
        tree = _tree_map(lambda _, x: x, template, tree)
        total = tree if total is None else _tree_map(lambda a, b: a + b, total, tree)
    k = float(len(ckpts))
    # numpy divides a 0-d array by a Python float in float64: divide in the leaf's dtype
    return _tree_map(lambda a: a / (np.asarray(k, a.dtype) if isinstance(a, np.ndarray) else k), total)
