"""Checkpoint manager: async save, atomic publish, retention, restore in place.

A state is a tree of dicts, NamedTuples, tuples and lists whose leaves are
tensors, numpy arrays and host scalars, with ``nn.Module``s standing for
their parameters and buffers by name (the carry's model). Host scalars are
state too: ``OptState.step`` drives the LR schedule and
``PipelinedRehearsalCarry.key`` roots the next draw. A JSON metadata blob
(step, data cursor, ...) rides along.

``save`` copies every leaf to the host on the caller's thread (the port's
steps write their tensors in place, and ``.numpy()`` of a CPU or pinned
tensor shares its memory), then writes on a background thread: the step
directory is written under a ``.tmp`` name and renamed, so a crash mid-save
never corrupts the latest checkpoint. ``restore`` reads the newest readable
checkpoint and copies it into the template's own tensors, which keeps each
tensor's device, dtype and pinning (the kernels refuse a cold tier in
pageable memory). ``reshard_buffer`` redistributes rehearsal records when the
worker count changes (elastic scaling).

A save's write and a restore's load are each a span (``checkpoint_save``,
on the writer thread's track, tid 1, when the save is asynchronous;
``checkpoint_restore``) and an event of the same name (``repro_torch.obs``).
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from numpy.lib import format as npformat

from repro_torch.obs.events import get_event_bus
from repro_torch.obs.trace import get_tracer
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.checkpoint")

# numpy has no bfloat16: such a leaf is stored as its 16-bit view, and its
# dtype is written into meta.json under "dtypes"
_VIEWS = {torch.bfloat16: torch.int16}
_SCALARS = (bool, int, float, np.generic)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _module_leaves(module: torch.nn.Module):
    return itertools.chain(module.named_parameters(), module.named_buffers())


def _leaves(tree, path: Tuple[str, ...] = ()):
    """``(key, leaf)`` pairs of a state tree, in a fixed order."""
    if tree is None:
        return
    if isinstance(tree, torch.nn.Module):
        for name, t in _module_leaves(tree):
            yield "/".join(path + (name,)), t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif isinstance(tree, (torch.Tensor, np.ndarray) + _SCALARS):
        yield "/".join(path), tree
    else:
        raise TypeError(f"a checkpoint cannot hold {type(tree).__name__} at "
                        f"{'/'.join(path) or 'the root'}")


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync_card():
    """Wait for the card: its kernels may still write the tensors (pinned
    host tables included) that a snapshot reads or a restore overwrites."""
    if _card_in_use():
        torch.cuda.synchronize()


def _host_array(shape, dtype: np.dtype, pinned: bool) -> np.ndarray:
    """An uninitialised host array, in pinned memory (the caching host
    allocator's) when ``pinned``: copies between it and the card then run at
    the host link's rate, not at a pageable copy's."""
    if not pinned:
        return np.empty(shape, dtype)
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy().view(dtype).reshape(shape)


def snapshot(state) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of every leaf of ``state``, none aliasing it: a card
    tensor is copied into pinned memory after the card's pending work, a
    host tensor is copied. Returns ``(arrays, dtypes)``, where ``dtypes``
    names the dtype of each leaf stored as a view."""
    _sync_card()
    arrays, dtypes, on_card = {}, {}, False
    for key, leaf in _leaves(state):
        if not isinstance(leaf, torch.Tensor):
            arrays[key] = np.array(leaf)
            continue
        t = leaf.detach()
        if t.dtype in _VIEWS:
            dtypes[key] = str(t.dtype).split(".")[-1]
            t = t.view(_VIEWS[t.dtype])
        if t.device.type == "cpu":
            arrays[key] = np.array(t.numpy())
        else:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            arrays[key], on_card = host.numpy(), True
    if on_card:
        torch.cuda.synchronize()
    return arrays, dtypes


def _write_npz(path: str, arrays: Dict[str, np.ndarray]):
    """``np.savez``'s file (a stored zip of ``.npy`` members), each array
    written from its own memory in one call: no chunked copies holding the
    interpreter lock while the training thread dispatches."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, a in arrays.items():
            a = a if a.flags.c_contiguous else a.copy(order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                npformat.write_array_header_1_0(f, npformat.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _read_npz(path: str, pinned: bool) -> Dict[str, np.ndarray]:
    """Every array of a ``.npz`` (``np.load``'s reading, each member read
    in one call into a host array, pinned when ``pinned``). The zip's CRC
    check still runs; a truncated file raises ``zipfile.BadZipFile`` or
    ``ValueError``."""
    arrays = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                version = npformat.read_magic(f)
                read_header = (npformat.read_array_header_1_0 if version == (1, 0)
                               else npformat.read_array_header_2_0)
                shape, fortran, dtype = read_header(f)
                if fortran or dtype.hasobject:
                    raise ValueError(f"{name}: not a C-ordered array of plain values")
                a = _host_array(shape, dtype, pinned)
                if f.readinto(memoryview(a.reshape(-1)).cast("B")) != a.nbytes:
                    raise ValueError(f"{name}: truncated")
            arrays[name[:-len(".npy")]] = a
    return arrays


def _copy_into(dst: torch.Tensor, arr: np.ndarray, dtype: Optional[str]):
    src = torch.from_numpy(arr)
    dst.copy_(src.view(getattr(torch, dtype)) if dtype is not None else src, non_blocking=True)


def _unflatten(template, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
               strict: bool = True):
    """Copy the checkpoint into ``template``: tensors in place (a module's
    parameters and buffers too), numpy arrays and host scalars returned anew,
    the containers rebuilt around them.

    ``strict=False`` keeps the template's own value for the leaves the
    checkpoint does not carry (and warns once): the escape hatch for
    checkpoints written before a state field existed. Everything else, the
    policy aux (FIFO cursors, GRASP distances) and the tiered stage included,
    comes back as it was saved, never rebuilt from init."""
    missing, wrong = [], []
    for key, leaf in _leaves(template):
        if key not in arrays:
            missing.append(key)
        elif isinstance(leaf, torch.Tensor) and tuple(arrays[key].shape) != tuple(leaf.shape):
            wrong.append(f"{key} {arrays[key].shape} vs {tuple(leaf.shape)}")
    # checked before the first copy, so that a refused restore leaves the
    # template as it was
    if missing and strict:
        raise KeyError(f"checkpoint missing leaf {missing[0]}")
    if wrong:
        raise ValueError(f"checkpoint leaves differ in shape from the template: {wrong[:4]}")

    def build(tree, path: Tuple[str, ...]):
        if tree is None:
            return None
        if isinstance(tree, torch.nn.Module):
            for name, t in _module_leaves(tree):
                key = "/".join(path + (name,))
                if key in arrays:
                    _copy_into(t, arrays[key], dtypes.get(key))
            return tree
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        if _is_namedtuple(tree):
            return type(tree)(*(build(getattr(tree, f), path + (f,)) for f in tree._fields))
        if isinstance(tree, (tuple, list)):
            return type(tree)(build(v, path + (str(i),)) for i, v in enumerate(tree))
        key = "/".join(path)
        if key not in arrays:
            return tree
        arr = arrays[key]
        if isinstance(tree, torch.Tensor):
            _copy_into(tree, arr, dtypes.get(key))
            return tree
        if isinstance(tree, np.ndarray):
            return arr.astype(tree.dtype)
        return type(tree)(arr.item())

    _sync_card()
    with torch.no_grad():
        state = build(template, ())
    _sync_card()  # the copies from pinned memory are asynchronous
    if missing:
        log.warning("checkpoint predates %d state leaf/leaves (kept template init "
                    "values): %s", len(missing), missing[:4])
    return state


class CheckpointManager:
    """Checkpoints under ``directory``: ``step_%010d/`` holding ``state.npz``
    and ``meta.json``, the newest ``keep`` kept. ``last_save`` holds the last
    save's ``bytes``, ``snapshot_seconds`` (the host copies, on the caller's
    thread) and ``write_seconds`` (the writer's)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.last_save: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state, metadata: Optional[Dict] = None):
        """Snapshot ``state`` at ``step``. Returns once the host copies are
        taken (the caller may then write its tensors); the files are written
        on a thread when ``async_save``. A step already published is kept as
        it is (the writer would discard the new copy), so it is not copied
        again."""
        if os.path.exists(self._path(step)):
            return
        t0 = time.perf_counter()
        arrays, dtypes = snapshot(state)
        meta = dict(metadata or {}, step=int(step), time=time.time())
        if dtypes:
            meta["dtypes"] = dtypes
        snap = time.perf_counter() - t0
        self.wait()  # one in-flight save at a time
        self.last_save = {"bytes": float(sum(a.nbytes for a in arrays.values())),
                          "snapshot_seconds": snap}
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(step, arrays, meta))
            self._thread.start()
        else:
            self._write(step, arrays, meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: Dict[str, np.ndarray], meta: Dict):
        t0 = time.perf_counter()
        nbytes = int(sum(a.nbytes for a in arrays.values()))
        with get_tracer().span("checkpoint_save", cat="checkpoint",
                               tid=1 if self.async_save else 0, step=int(step), bytes=nbytes):
            final = self._path(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            _write_npz(os.path.join(tmp, "state.npz"), arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(tmp)
            else:
                os.replace(tmp, final)
            self._gc()
        self.last_save["write_seconds"] = time.perf_counter() - t0
        get_event_bus().publish("checkpoint_save", source="checkpoint", step=int(step),
                                bytes=nbytes, dir=self.dir)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _gc(self):
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        """Steps with both files present: ``meta.json`` alone can appear when
        a rank died between unlink and rename on a non-atomic filesystem."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                d = os.path.join(self.dir, name)
                if (os.path.exists(os.path.join(d, "meta.json"))
                        and os.path.exists(os.path.join(d, "state.npz"))):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                strict: bool = True) -> Tuple[Any, Dict]:
        """Restore into ``template``. Returns ``(state, metadata)``: the
        template's tensors hold the checkpoint's values, and its host scalars
        are replaced.

        With ``step=None`` a checkpoint that fails to load (a truncated
        ``state.npz`` from a rank killed mid-write) is skipped for the next
        older one: the restart path must survive the failures that trigger
        it. An explicit ``step`` raises on corruption. Every array is read
        before the first is copied, so a failed load leaves the template as
        it was."""
        self.wait()
        if step is not None:
            return self._load(template, step, strict)
        candidates = self.list_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        last_err: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._load(template, s, strict)
            except (OSError, ValueError, json.JSONDecodeError, zipfile.BadZipFile) as e:
                log.warning("checkpoint step %d unreadable (%s); trying older", s, e)
                last_err = e
        raise FileNotFoundError(f"no readable checkpoint under {self.dir}") from last_err

    def _load(self, template, step: int, strict: bool) -> Tuple[Any, Dict]:
        path = self._path(step)
        with get_tracer().span("checkpoint_restore", cat="checkpoint", step=int(step)):
            arrays = _read_npz(os.path.join(path, "state.npz"), _card_in_use())
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            state = _unflatten(template, arrays, meta.get("dtypes", {}), strict)
        get_event_bus().publish("checkpoint_restore", source="checkpoint", step=int(step),
                                dir=self.dir)
        return state, meta


# ---------------------------------------------------------------------------
# Elastic re-sharding of the distributed rehearsal buffer (N -> N' workers)
# ---------------------------------------------------------------------------


def bucket_pools(counts: np.ndarray, slots: int, offset: int = 0) -> List[List[int]]:
    """Per bucket, the valid records of N per-worker tables pooled in worker
    order: ``counts`` [N, K]; record ``(w, b, s)`` is row ``offset + (w * K +
    b) * slots + s`` of the N tables concatenated."""
    n, k = counts.shape
    return [[offset + (w * k + b) * slots + s for w in range(n)
             for s in range(int(counts[w, b]))] for b in range(k)]


def deal_index(pools: Sequence[Sequence[int]], n_new: int, slots: int) -> np.ndarray:
    """Deal each bucket's pool round-robin: its j-th record goes to worker
    ``j % n_new``, slot ``j // n_new``; records past the new aggregate
    capacity ``n_new * slots`` are dropped (the pool is already in the
    buffer's random order). Returns the source row of every new slot,
    [n_new, K, slots], -1 where a slot stays empty."""
    index = np.full((n_new, len(pools), slots), -1, np.int64)
    for b, pool in enumerate(pools):
        for j, row in enumerate(pool[: n_new * slots]):
            index[j % n_new, b, j // n_new] = row
    return index


def dealt_counts(index: np.ndarray, device) -> List[torch.Tensor]:
    """Each new worker's i32[K] counts from a ``deal_index`` plan."""
    return [torch.from_numpy((index[w] >= 0).sum(-1).astype(np.int32)).to(device)
            for w in range(index.shape[0])]


def gather_dealt(tables: Sequence[torch.Tensor], index: np.ndarray,
                 like: torch.Tensor) -> List[torch.Tensor]:
    """The new per-worker tables, one per row of ``index`` (from
    ``deal_index``), gathered from the rows of ``tables`` concatenated, with
    zeros in the empty slots. ``like`` is an old table ([K, slots, ...]):
    each result lies on its device, pinned if it is pinned."""
    dev, item = like.device, tuple(like.shape[2:])
    rows = torch.cat([t.reshape((-1,) + item).to(dev) for t in tables]
                     + [torch.zeros((1,) + item, dtype=like.dtype, device=dev)])
    index = torch.from_numpy(np.where(index < 0, rows.shape[0] - 1, index)).to(dev)
    out = []
    for w in range(index.shape[0]):
        t = rows.index_select(0, index[w].reshape(-1)).reshape(tuple(index.shape[1:]) + item)
        out.append(t.pin_memory() if like.is_pinned() else t)
    return out


def reshard_buffer(data: Sequence[Dict[str, Any]], counts: Sequence[torch.Tensor],
                   n_new: int):
    """Redistribute N workers' buffer records across ``n_new`` workers.

    ``data``: the N per-worker record dicts (leaves [K, slots, ...], a field
    may be a dict of leaves); ``counts``: their N i32[K] valid entries. Valid
    records are pooled per bucket and dealt round-robin to the new workers,
    keeping the per-bucket capacity; records past the shrunken aggregate
    capacity are dropped, the paper's random-eviction semantics. Returns
    ``(new_data, new_counts)``, lists of ``n_new``, each leaf where the old
    one lies (pinned if it was)."""
    from repro_torch.buffer.state import first_leaf, tree_map

    counts_np = np.stack([np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
                          for c in counts])
    slots = first_leaf(data[0]).shape[1]
    index = deal_index(bucket_pools(counts_np, slots), n_new, slots)
    per_leaf = tree_map(lambda *leaves: gather_dealt(leaves, index, leaves[0]), *data)
    new_data = [tree_map(lambda dealt, _w=w: dealt[_w], per_leaf) for w in range(n_new)]
    dev = counts[0].device if isinstance(counts[0], torch.Tensor) else torch.device("cpu")
    return new_data, dealt_counts(index, dev)
