"""Checkpoint / resume on torch.distributed.checkpoint (DCP).

The counterpart of `mpi_operator_tpu/train/checkpoint.py` (orbax there),
for the trainers' in-place states. The payload is the reference's:
`step` and the state's own tensors (`checkpoint_payload()`): for the
LM trainer's `LMTrainState` `params` (the flat f32 master buffer) and
`opt` (`mu`, `nu`, `count`), for the image trainer's `TrainState`
`params`, `batch_stats` and `opt.momentum`; the on-device
`nonfinite_streak` is not saved, as in the reference's `_state_payload`.
In a process group only rank 0 writes (every rank's state is the same
data-parallel replica; the reference's orbax save also writes from the
primary host only); every rank restores from the shared directory. A checkpoint is a directory
`<train_dir>/step_<N>` holding DCP's `.metadata` and `__0_<i>.distcp`
files, written by a `FileSystemWriter` with `WRITER_THREADS` threads.

Three things the reference gets from orbax are done here by hand:

- **Commit.** DCP writes straight into its target directory. A save
  writes into a temporary sibling (`step_<N>.tmp-<pid>`) and renames it
  to `step_<N>` once DCP returns (files fsync'd), then fsyncs the
  parent; `checkpoint_steps` and `gc_checkpoints` only ever see
  committed names, and `verify_checkpoint` means: the name
  `step_<digits>`, a directory, `.metadata` present.
- **Snapshot.** The trainer updates its state IN PLACE. A save clones
  the payload in stream order before it returns — on the card a device
  copy (~2.5 ms of HBM traffic for gpt2-medium's 4.25 GB) that the
  writer thread then copies to pinned host memory on its own stream,
  after an event that follows the clone; on the CPU a host copy — so
  the steps that follow cannot reach the bytes being written. At most
  one write is in flight: every save and `wait_for_checkpoints` joins
  the previous one first (and re-raises its error).
- **Restore in place.** The model's parameters are views of
  `state.params`. A restore reads the checkpoint into host buffers
  first (a torn candidate raises before the state is touched), then
  `copy_`s into the existing flat buffer and moments; nothing is
  rebound.

A state split over fsdp x ep x tp (the LM trainer's over a
model-parallel mesh: `state.shard` = (its shard, the count, whether it
writes)) is saved shard by shard: one rank a shard (the one at
coordinate 0 of dcn, dp and sp) writes `shard_<k>/` (DCP, as above)
into a temporary sibling whose name every rank agrees on (a token rank
0 broadcasts at the save), with `layout.json` (the state's
`layout_key`: the fsdp, ep and tp sizes and the parameters) beside
them; shard 0's writer commits the directory once every shard's marker
is there. Every rank restores its own shard, then the state refreshes
what it derives from it (`after_restore`: fsdp's gathered working
copy). `restore_checkpoint` of another layout raises `ReshardRequired`;
`restore_resharded` restores it.

A pipeline state (train/pp_trainer.py) is saved the same way, one shard
a rank of pp x ep x tp, but its payload is keyed by the canonical
parameter names (a block's with the rank's tp and ep coordinates; the
replicated leaves written once, by the first stage), and `layout.json`
records pp, tp, ep and the parameters, not the schedule. A restore reads
each key it holds from whichever shard wrote it (`restore_payload()`),
so a GPipe checkpoint resumes under 1F1B with any interleave, and back.

`restore_resharded` (the reference's resharding reader) restores any
of these checkpoints into any other split: a replica, fsdp x ep x tp,
another world size, another pp size, a pipeline state into a flat one
and back. It rebuilds the saved layout from `layout.json` alone, reads
each saved tensor a rank needs whole (a thread pool overlaps them),
copies its values into host staging buffers shaped like the live state
and drops it (`ReadStats`: bytes read, the peak in flight); then the
staging goes into the state. `maybe_resume(reshard=True)` or
`TPU_RESHARD_RESTORE=1` routes the resume through it.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException

from ..telemetry import span

#: FileSystemWriter threads (DCP's default is 1): one file each
WRITER_THREADS = 4
#: "1"/"true" routes maybe_resume through restore_resharded (with a
#: per-candidate fallback to the plain restore)
ENV_RESHARD_RESTORE = "TPU_RESHARD_RESTORE"
#: restore_resharded's read threads (0/unset: up to 16)
ENV_RESTORE_THREADS = "TPU_RESTORE_THREADS"
_METADATA = ".metadata"
_LAYOUT = "layout.json"
#: seconds shard 0's writer waits for the other shards before it gives up
SHARD_WAIT = 600.0


class ReshardRequired(ValueError):
    """A checkpoint written over another split of the state: restoring it
    needs `restore_resharded` (or TPU_RESHARD_RESTORE=1 under
    maybe_resume)."""

# Per-directory last step THIS process saved. Every rank executes the
# same periodic hooks in the same order, so the value is identical across
# processes by construction — the safe way to decide whether to enter a
# save (gating one on local os.listdir diverges on per-host filesystems).
# Deliberately unbounded: evicting an entry would reintroduce the
# force-rewrite hazard maybe_save exists to avoid.
_LAST_SAVED: Dict[str, int] = {}
_LAST_RESTORE_INFO: Dict[str, Any] = {}
_LAST_SAVE_INFO: Dict[str, Any] = {}


def _state_payload(state) -> Dict[str, torch.Tensor]:
    """The tensors a checkpoint holds, by DCP key: the live tensors of
    `state`, which a restore copies into. Each state names its own
    (`checkpoint_payload()`): the LM state params, opt.mu, opt.nu and
    opt.count; the image state params, batch_stats and opt.momentum."""
    return state.checkpoint_payload()


def _nbytes(payload: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in payload.values())


def _quiet_single_process() -> None:
    # DCP warns on every single-process save/load that it assumes one
    # process; that IS the layout here (one flat state, one writer)
    warnings.filterwarnings(
        "ignore", message="torch.distributed is disabled, unavailable or "
        "uninitialized", category=UserWarning)


class _Writer:
    """The one background writer: a single thread, so at most one write
    is in flight, and pinned host buffers reused across saves (a save
    and a restore both join the previous write before touching them)."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-writer")
        self._future: Optional[Future] = None
        self._host: Dict[str, torch.Tensor] = {}

    def wait(self) -> None:
        future, self._future = self._future, None
        if future is not None:
            future.result()

    def submit(self, fn) -> None:
        self._future = self._pool.submit(fn)

    def host_buffers(self, payload) -> Dict[str, torch.Tensor]:
        """Host tensors shaped like `payload`: pinned and cached when the
        payload is on the card, fresh otherwise."""
        out = {}
        for name, t in payload.items():
            if t.device.type != "cuda":
                out[name] = torch.empty_like(t, device="cpu")
                continue
            got = self._host.get(name)
            if got is None or got.shape != t.shape or got.dtype != t.dtype:
                got = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._host[name] = got
            out[name] = got
        return out


_WRITER: Optional[_Writer] = None
_WRITER_LOCK = threading.Lock()


def _writer() -> _Writer:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = _Writer()
        return _WRITER


def wait_for_checkpoints() -> None:
    """Join the in-flight background write (no-op when none); re-raises
    the write's error."""
    if _WRITER is not None:
        _WRITER.wait()


def _commit(tmp: str, path: str) -> None:
    """Make `tmp` the committed `path`: an existing `path` is renamed
    aside first and deleted after, so a crash leaves either the old or
    the new step_N (or its tmp/old sibling), never a half-written one
    under the committed name."""
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.rename(path, old)
    os.rename(tmp, path)
    fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _write(snapshot, path: str, step: int, event, writer: _Writer) -> None:
    """The writer thread's job: (card) wait for the snapshot's clone,
    copy it to pinned host memory on a side stream; DCP-save the host
    tensors into a tmp sibling; commit."""
    t0 = time.perf_counter()
    if event is not None:
        stream = torch.cuda.Stream(device=_device_of(snapshot))
        stream.wait_event(event)
        host = writer.host_buffers(snapshot)
        with torch.cuda.stream(stream):
            for name, t in snapshot.items():
                host[name].copy_(t, non_blocking=True)
        stream.synchronize()
        snapshot = host
    t_host = time.perf_counter()
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    dcp.save({"step": torch.tensor(step, dtype=torch.int64), **snapshot},
             storage_writer=dcp.FileSystemWriter(
                 tmp, thread_count=WRITER_THREADS),
             no_dist=True)
    _commit(tmp, path)
    _LAST_SAVE_INFO.update(
        path=path, step=step, bytes=_nbytes(snapshot),
        threads=WRITER_THREADS, to_host_seconds=t_host - t0,
        write_seconds=time.perf_counter() - t_host)


def save_checkpoint(directory: str, state, step: Optional[int] = None,
                    block: bool = True) -> str:
    """Write a checkpoint under `directory/step_<n>`; returns the path.
    The state's values are snapshotted (in stream order) before this
    returns, so in-place steps that follow never reach the checkpoint.
    block=False returns right after the snapshot and lets the write
    complete on the writer thread (join it with wait_for_checkpoints —
    or any later save)."""
    step = int(state.step) if step is None else int(step)
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step}")
    if getattr(state, "shard", None) is not None:
        return _save_shard(state, directory, path, step, block)
    if _rank() != 0:                   # rank 0 writes the replica
        _LAST_SAVED[directory] = step
        return path
    _quiet_single_process()
    writer = _writer()
    with span("checkpoint.save"):
        writer.wait()                  # at most one write in flight
        os.makedirs(directory, exist_ok=True)
        with torch.no_grad():
            snapshot = {k: t.clone() for k, t in
                        _state_payload(state).items()}
        event = None
        if state.params.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        _LAST_SAVE_INFO.clear()
        writer.submit(lambda: _write(snapshot, path, step, event, writer))
        _LAST_SAVED[directory] = step
        if block:
            writer.wait()
    return path


def _device_of(payload) -> torch.device:
    return next(iter(payload.values())).device


def _token(group) -> str:
    """A name the group's first rank picks for this save's temporary
    directory, the same on every rank of `group` (None: this process
    alone)."""
    obj = [f"{os.getpid()}-{time.time_ns()}"]
    if group is not None:
        dist.broadcast_object_list(obj, src=dist.get_global_rank(group, 0),
                                   group=group)
    return obj[0]


def _write_shard(snapshot, tmp, path, step, event, writer, shard, layout):
    """The writer thread's job for a shard: its DCP files into
    `tmp/shard_<k>`, then a marker; shard 0 also writes the layout and,
    once every shard's marker is there, commits `tmp` as `path`."""
    k, n = shard
    t0 = time.perf_counter()
    if event is not None:
        stream = torch.cuda.Stream(device=_device_of(snapshot))
        stream.wait_event(event)
        host = writer.host_buffers(snapshot)
        with torch.cuda.stream(stream):
            for name, t in snapshot.items():
                host[name].copy_(t, non_blocking=True)
        stream.synchronize()
        snapshot = host
    t_host = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    dcp.save({"step": torch.tensor(step, dtype=torch.int64), **snapshot},
             storage_writer=dcp.FileSystemWriter(
                 os.path.join(tmp, f"shard_{k}"),
                 thread_count=WRITER_THREADS),
             no_dist=True)
    open(os.path.join(tmp, f"shard_{k}.done"), "w").close()
    if k == 0:
        with open(os.path.join(tmp, _LAYOUT), "w") as f:
            json.dump(layout, f)
        deadline = time.monotonic() + SHARD_WAIT
        while not all(os.path.exists(os.path.join(tmp, f"shard_{j}.done"))
                      for j in range(n)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"checkpoint {path}: the other shards' "
                                   f"writes did not arrive in "
                                   f"{SHARD_WAIT:.0f} s")
            time.sleep(0.05)
        _commit(tmp, path)
    _LAST_SAVE_INFO.update(
        path=path, step=step, bytes=_nbytes(snapshot),
        threads=WRITER_THREADS, to_host_seconds=t_host - t0,
        write_seconds=time.perf_counter() - t_host, shard=k, shards=n)


def _save_shard(state, directory, path, step, block) -> str:
    """save_checkpoint for a state split over shards (module
    docstring). Every rank of the state's mesh calls it (the token is
    collective over `state.group`); the ranks that write their shard
    snapshot it and hand it to their writer."""
    k, n, writes = state.shard
    token = _token(getattr(state, "group", None))
    if writes:
        _quiet_single_process()
        writer = _writer()
        with span("checkpoint.save"):
            writer.wait()
            os.makedirs(directory, exist_ok=True)
            with torch.no_grad():
                snapshot = {key: t.clone() for key, t in
                            _state_payload(state).items()}
            event = None
            if _device_of(snapshot).type == "cuda":
                event = torch.cuda.Event()
                event.record()
            _LAST_SAVE_INFO.clear()
            tmp = f"{path}.tmp-{token}"
            layout = dict(state.layout_key, shards=n)
            writer.submit(lambda: _write_shard(snapshot, tmp, path, step,
                                               event, writer, (k, n),
                                               layout))
            if block:
                writer.wait()
    _LAST_SAVED[directory] = step
    return path


def last_save_info() -> Dict[str, Any]:
    """The newest committed save of this process: `path`, `step`,
    `bytes`, `threads`, `to_host_seconds` (the writer's copy to pinned
    host memory; 0 on the CPU) and `write_seconds` (DCP write and
    commit). Empty while a write is in flight."""
    return dict(_LAST_SAVE_INFO)


def checkpoint_steps(directory: str) -> List[int]:
    """Ascending step numbers of the committed step_N entries under
    `directory` (an in-flight write lives under a tmp name)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[5:]) for name in os.listdir(directory)
                  if name.startswith("step_") and name[5:].isdigit())


def verify_checkpoint(path: str) -> bool:
    """Cheap integrity check on a step_N candidate: a committed name, a
    directory, and DCP's `.metadata` (the file a load cannot start
    without). Corruption inside the data files is caught by the restore
    itself — restore_with_fallback treats a raising restore the same."""
    base = os.path.basename(path)
    if not (base.startswith("step_") and base[5:].isdigit()):
        return False
    if not os.path.isdir(path):
        return False
    names = os.listdir(path)
    if _LAYOUT not in names:
        return _METADATA in names
    try:
        with open(os.path.join(path, _LAYOUT)) as f:
            n = int(json.load(f)["shards"])
    except (OSError, ValueError, KeyError):
        return False
    return all(os.path.exists(os.path.join(path, f"shard_{k}", _METADATA))
               for k in range(n))


def latest_checkpoint(directory: str, verify: bool = True) -> Optional[str]:
    """Newest INTACT step_N path (or None); verify=True skips candidates
    that fail verify_checkpoint, falling back to the previous step."""
    wait_for_checkpoints()
    directory = os.path.abspath(directory)
    for step in reversed(checkpoint_steps(directory)):
        path = os.path.join(directory, f"step_{step}")
        if not verify or verify_checkpoint(path):
            return path
    return None


def restore_checkpoint(directory_or_path: str, state):
    """Restore into `state` in place (its flat params and moments keep
    their storage: the model's parameter views see the values) and set
    its step; returns `state`. Accepts a step_N path or a directory of
    them (takes the latest)."""
    wait_for_checkpoints()
    path = directory_or_path
    if not os.path.basename(os.fspath(path)).startswith("step_"):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
        path = latest
    _quiet_single_process()
    path = os.fspath(path)
    if hasattr(state, "restore_payload"):
        return _restore_named(path, state)
    source = _shard_source(path, state)
    live = _state_payload(state)
    host = _writer().host_buffers(live)
    step = torch.zeros((), dtype=torch.int64)
    dcp.load({"step": step, **host},
             storage_reader=dcp.FileSystemReader(source), no_dist=True)
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(host[name])
    state.step = int(step)
    if hasattr(state, "after_restore"):
        state.after_restore()
    return state


def _saved_layout(path: str, state) -> Optional[dict]:
    """The layout a checkpoint was written over (`layout.json`), checked
    against this state's: None for a replica's checkpoint restored into
    a replica. A checkpoint of another split raises ReshardRequired."""
    shard = getattr(state, "shard", None)
    layout_file = os.path.join(path, _LAYOUT)
    if not os.path.exists(layout_file):
        if shard is None:
            return None
        raise ReshardRequired(
            f"{path} holds one replica of the whole state; this state is "
            f"split over {shard[1]} shards ({state.layout_key['mesh']}): "
            f"restore it with restore_resharded (or "
            f"{ENV_RESHARD_RESTORE}=1)")
    with open(layout_file) as f:
        saved = json.load(f)
    want = dict(getattr(state, "layout_key", None) or {},
                shards=shard[1] if shard else 1)
    if shard is None or saved != json.loads(json.dumps(want)):
        raise ReshardRequired(
            f"{path} was written over {saved.get('mesh')} in "
            f"{saved.get('shards')} shards; this state is "
            f"{want.get('mesh')} in {want['shards']}: restore it with "
            f"restore_resharded (or {ENV_RESHARD_RESTORE}=1)")
    return saved


def _shard_source(path: str, state) -> str:
    """The directory this rank reads: `path` for a replica, its shard's
    for a sharded state."""
    if _saved_layout(path, state) is None:
        return path
    return os.path.join(path, f"shard_{state.shard[0]}")


def _restore_named(path: str, state):
    """restore_checkpoint for a state keyed by canonical names (a pp
    state: `restore_payload()`): each key this rank holds is read from
    whichever shard wrote it, so a checkpoint taken under one pipeline
    schedule restores under another. A checkpoint of another layout (pp,
    tp, ep or the model) raises ReshardRequired."""
    saved = _saved_layout(path, state)
    live = state.restore_payload()
    host = _writer().host_buffers(live)
    step = torch.zeros((), dtype=torch.int64)
    left = set(live)
    for k in range(saved["shards"]):
        source = os.path.join(path, f"shard_{k}")
        reader = dcp.FileSystemReader(source)
        keys = left & set(reader.read_metadata().state_dict_metadata)
        if keys:
            dcp.load({"step": step, **{key: host[key] for key in keys}},
                     storage_reader=reader, no_dist=True)
            left -= keys
    if left:
        raise ValueError(f"{path} lacks {sorted(left)[:4]}...")
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(host[name])
    state.step = int(step)
    return state


# ---------------------------------------------------------------------------
# the resharding restore
# ---------------------------------------------------------------------------

@dataclass
class ReadStats:
    """What one restore_resharded call read. `peak_in_flight_bytes` is
    the memory contract a test pins: the most bytes of saved tensors held
    on this host at once (read and not yet scattered into the state),
    which stays at one saved tensor's bytes with max_workers=1, well under
    `total_bytes` (every tensor the checkpoint holds)."""
    leaves: int = 0
    reads: int = 0
    bytes_read: int = 0
    total_bytes: int = 0
    in_flight_bytes: int = 0
    peak_in_flight_bytes: int = 0
    seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def begin_read(self, nbytes: int) -> None:
        with self._lock:
            self.reads += 1
            self.bytes_read += nbytes
            self.in_flight_bytes += nbytes
            self.peak_in_flight_bytes = max(self.peak_in_flight_bytes,
                                            self.in_flight_bytes)

    def end_read(self, nbytes: int) -> None:
        with self._lock:
            self.in_flight_bytes -= nbytes


#: the saved and live keys of the three flat buffers, by kind
_FLAT_KEYS = {"params": "params", "mu": "opt.mu", "nu": "opt.nu"}


def _grid(sizes: Dict[str, int]):
    """A mesh of these axis sizes without a process group (the mesh a
    checkpoint was written over may no longer exist): its `shape` for
    `param_shardings`, and `coords(k)` of shard k (a shard index is
    row-major over the axes in mesh order, as a mesh rank is)."""
    from ..parallel.mesh import Mesh, MeshConfig
    cfg = MeshConfig(**sizes)
    return Mesh(cfg, range(cfg.num_devices))


def _block(placement, coords, sizes, shape) -> Tuple[tuple, tuple]:
    """(start, size) of the block of the global tensor a rank at
    `coords` holds (`sharding.local_block`'s narrowing, as a box)."""
    from ..parallel.sharding import COMPUTE_AXES
    start, size = [0] * len(shape), list(shape)
    for axis in COMPUTE_AXES:
        d = None if placement is None else placement.split(axis)
        n = int(sizes.get(axis, 1))
        if d is not None and n > 1:
            size[d] //= n
            start[d] += coords[axis] * size[d]
    return tuple(start), tuple(size)


def _boxes(size: tuple, a: int, b: int):
    """[a, b) of a row-major array of shape `size` as contiguous boxes:
    [(flat start, box start, box size)], at most 2 ndim - 1 of them."""
    if a >= b:
        return []
    if not size:
        return [(0, (), ())]
    inner = math.prod(size[1:])
    r0, c0 = divmod(a, inner)
    r1, c1 = divmod(b, inner)
    if r0 == r1:
        return [(r0 * inner + f, (r0,) + st, (1,) + sz)
                for f, st, sz in _boxes(size[1:], c0, c1)]
    out = []
    if c0:
        out += [(r0 * inner + f, (r0,) + st, (1,) + sz)
                for f, st, sz in _boxes(size[1:], c0, inner)]
        r0 += 1
    if r1 > r0:
        out.append((r0 * inner, (r0,) + (0,) * (len(size) - 1),
                    (r1 - r0,) + tuple(size[1:])))
    if c1:
        out += [(r1 * inner + f, (r1,) + st, (1,) + sz)
                for f, st, sz in _boxes(size[1:], 0, c1)]
    return out


@dataclass
class _Piece:
    """Part of one parameter's values in a flat buffer: the box of the
    global tensor it belongs to (start, size), the range [a, b) of that
    box's row-major elements it holds, and where element a sits in the
    buffer (`offset`). A saved piece names its tensor (directory, key);
    a live one its host staging buffer."""
    name: str
    which: str
    start: tuple
    size: tuple
    a: int
    b: int
    offset: int
    where: Any = None


def _flat_pieces(cfg, sizes, coords, which, live=False):
    """(the pieces, the slice length) of an LM flat buffer
    (train/lm_trainer.py) over a mesh of `sizes` (fsdp, ep, tp) at
    `coords`: the buffer laid out by class of parameter, zero-padded to
    split over fsdp, this rank's fsdp slice of it. Of a saved shard (not
    `live`) a parameter replicated over tp or ep is taken only from the
    shard at coordinate 0 there."""
    from ..parallel.sharding import COMPUTE_AXES, param_shardings
    from .lm_trainer import flat_layout, split_class
    mesh = _grid(sizes)
    placements = param_shardings(mesh, cfg)
    order, _ = flat_layout((n, split_class(p, mesh), p.local_shape)
                           for n, p in placements.items())
    n = sum(math.prod(s) for _, s in order)
    F = mesh.shape["fsdp"]
    per = (n + (-n) % F) // F
    lo, hi = coords["fsdp"] * per, (coords["fsdp"] + 1) * per
    out, off = [], 0
    for name, local in order:
        p = placements[name]
        size = math.prod(local)
        a, b = max(off, lo) - off, min(off + size, hi) - off
        keep = live or all(
            coords[ax] == 0 for ax in COMPUTE_AXES
            if p.split(ax) is None or mesh.shape[ax] == 1)
        if a < b and keep:
            start, box = _block(p, coords, mesh.shape, p.shape)
            out.append(_Piece(name, which, start, box, a, b,
                              off + a - lo))
        off += size
    return out, per


def _saved_pieces(path: str, cfg, stats: ReadStats):
    """Every piece of the checkpoint at `path` that a restore may read
    (a replica's, a state split over fsdp x ep x tp, or a pipeline
    state's keyed by canonical names), each naming its (directory, key);
    the layout is rebuilt from `layout.json` alone. Fills
    stats.total_bytes."""
    from ..models.transformer import param_shapes
    from ..parallel.pipeline import block_of
    from ..parallel.sharding import COMPUTE_AXES, param_shardings
    shapes = param_shapes(cfg)
    layout_file = os.path.join(path, _LAYOUT)
    if not os.path.exists(layout_file):
        sources, sizes = [(path, {})], {"fsdp": 1, "ep": 1, "tp": 1}
    else:
        with open(layout_file) as f:
            saved = json.load(f)
        got = {n: tuple(s) for n, s in saved.get("params", [])}
        if got != {n: tuple(s) for n, s in shapes.items()}:
            raise ValueError(f"{path} holds another model's parameters "
                             f"than this state's ({len(got)} vs "
                             f"{len(shapes)} tensors, or their shapes)")
        sizes = dict(saved["mesh"])
        grid = _grid(sizes)
        sources = [(os.path.join(path, f"shard_{k}"), grid.coords(k))
                   for k in range(int(saved["shards"]))]
    pieces = []
    metas = []
    for src, coords in sources:
        meta = dcp.FileSystemReader(src).read_metadata().state_dict_metadata
        metas.append((src, meta))
        for key, m in meta.items():
            if key not in ("step", "opt.count"):
                stats.total_bytes += (math.prod(m.size)
                                      * m.properties.dtype.itemsize)
        if "pp" not in sizes:
            for which, key in _FLAT_KEYS.items():
                if key not in meta:
                    raise ValueError(f"{src} lacks {key!r}")
                got, per = _flat_pieces(cfg, sizes, coords or _grid(
                    sizes).coords(0), which)
                if math.prod(meta[key].size) != per:
                    raise ValueError(
                        f"{src}: {key!r} holds {math.prod(meta[key].size)} "
                        f"values; this model over {sizes} needs {per}")
                for piece in got:
                    piece.where = (src, key)
                pieces += got
            continue
        mesh = _grid(sizes)
        placements = param_shardings(mesh, cfg)
        for key in meta:
            which, _, rest = key.partition("/")
            if which not in _FLAT_KEYS or not rest:
                continue
            name, _, tag = rest.partition("@")
            p = placements[name] if block_of(name) is not None else None
            c = {"tp": 0, "ep": 0}
            if tag:
                t, e = tag.split(".")
                c = {"tp": int(t[2:]), "ep": int(e[2:])}
            if any(c[ax] for ax in COMPUTE_AXES
                   if p is None or p.split(ax) is None
                   or mesh.shape[ax] == 1):
                continue                       # a replica of another copy
            start, box = _block(p, c, mesh.shape, shapes[name])
            if tuple(meta[key].size) != box:
                raise ValueError(f"{src}: {key!r} is {tuple(meta[key].size)}"
                                 f", the layout gives {box}")
            pieces.append(_Piece(name, which, start, box, 0,
                                 math.prod(box), 0, (src, key)))
    return pieces, metas


def _rule_block(rules, which, name, mesh, coords, shape):
    """The (start, size) a restore rule gives one parameter's landing
    block at `coords` of `mesh`, or None when no rule matches: rules are
    ((pattern, ...), spec) pairs windowed over the path (which,
    *name.split(".")), the first hit wins, a None spec replicates, a dim
    its axes do not divide replicates (`parallel/sharding.py
    sharding_for_path`); a dim over several axes is split major to minor
    in the spec's order."""
    from ..parallel.sharding import sharding_for_path
    if not rules:
        return None
    spec = sharding_for_path(mesh, (which,) + tuple(name.split(".")), rules,
                             shape)
    if spec is None:
        return None
    start, size = [0] * len(shape), list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        if axes:
            size[d] //= math.prod(mesh.shape[a] for a in axes)
            start[d] = idx * size[d]
    return tuple(start), tuple(size)


def _live_pieces(state, cfg, rules, mesh):
    """(pieces of what this rank holds, each naming its host staging
    buffer; {live key: (live tensor, staging)}) for
    the LM trainer's state (its masters and moments: its fsdp slice of
    its tp and ep blocks), a pipeline state (`restore_payload()`) or a
    dict {"params/<name>" | "mu/<name>" | "nu/<name>": tensor} (`mesh`
    places its blocks under `rules`; unmatched keys land whole)."""
    from ..models.transformer import param_shapes
    from ..parallel.pipeline import block_of
    from ..parallel.sharding import param_shardings
    shapes = param_shapes(cfg)
    if isinstance(state, dict):
        mesh = mesh if mesh is not None else _grid({})
        coords = mesh.coords()
        pieces, staging = [], {}
        for key, t in state.items():
            which, _, name = key.partition("/")
            if which not in _FLAT_KEYS or name not in shapes:
                raise ValueError(f"{key!r}: a dict target is keyed "
                                 f"params/, mu/ or nu/<parameter name>")
            host = torch.zeros(t.shape, dtype=torch.float32)
            staging[key] = (t, host)
            start, size = _rule_block(rules, which, name, mesh, coords,
                                      shapes[name]) or (
                (0,) * len(shapes[name]), shapes[name])
            if size != tuple(t.shape):
                raise ValueError(f"{key!r} is {tuple(t.shape)}; its block "
                                 f"is {size}")
            pieces.append(_Piece(name, which, start, size, 0,
                                 math.prod(size), 0, host))
        return pieces, staging
    sizes = dict(state.layout_key["mesh"])
    grid = _grid(sizes)
    shard = getattr(state, "shard", None)
    coords = grid.coords(shard[0] if shard else 0)
    pieces, staging = [], {}
    if hasattr(state, "restore_payload"):
        placements = param_shardings(grid, cfg)
        for key, t in state.restore_payload().items():
            which, _, rest = key.partition("/")
            if which not in _FLAT_KEYS:
                staging[key] = (t, None)
                continue
            name = rest.partition("@")[0]
            p = placements[name] if block_of(name) is not None else None
            start, size = _block(p, coords, sizes, shapes[name])
            host = torch.zeros(t.shape, dtype=t.dtype)
            staging[key] = (t, host)
            pieces.append(_Piece(name, which, start, size, 0,
                                 math.prod(size), 0, host))
    else:
        live = state.checkpoint_payload()
        for which, key in _FLAT_KEYS.items():
            host = torch.zeros(live[key].shape, dtype=live[key].dtype)
            staging[key] = (live[key], host)
            got, per = _flat_pieces(cfg, sizes, coords, which, live=True)
            if per != live[key].numel():
                raise ValueError(f"{key}: {live[key].numel()} values, the "
                                 f"layout gives {per}")
            for piece in got:
                piece.where = host
            pieces += got
        staging["opt.count"] = (live["opt.count"], None)
    for piece in pieces:
        got = _rule_block(rules, piece.which, piece.name, grid, coords,
                          shapes[piece.name])
        if got is not None and got[1] != piece.size:
            raise ValueError(
                f"restore rule for {piece.which}/{piece.name} lands a "
                f"{got[1]} block; this state holds {piece.size}")
        if got is not None:
            piece.start = got[0]
    return pieces, staging


def _scatter(src: torch.Tensor, sp: _Piece, dst: _Piece) -> int:
    """Copy what saved piece `sp` (its tensor `src`) holds of live piece
    `dst` into dst's staging buffer; returns the values copied."""
    moved = 0
    for fs, ss, zs in _boxes(sp.size, sp.a, sp.b):
        gs = [a + b for a, b in zip(sp.start, ss)]
        for fd, sd, zd in _boxes(dst.size, dst.a, dst.b):
            gd = [a + b for a, b in zip(dst.start, sd)]
            lo = [max(x, y) for x, y in zip(gs, gd)]
            hi = [min(x + m, y + n) for x, m, y, n in zip(gs, zs, gd, zd)]
            if any(x >= y for x, y in zip(lo, hi)):
                continue
            o = sp.offset + fs - sp.a
            a = src.reshape(-1)[o:o + math.prod(zs)].view(zs)
            o = dst.offset + fd - dst.a
            b = dst.where.reshape(-1)[o:o + math.prod(zd)].view(zd)
            a = a[tuple(slice(x - g, y - g) for x, y, g in zip(lo, hi, gs))]
            b[tuple(slice(x - g, y - g) for x, y, g in zip(lo, hi, gd))
              ].copy_(a)
            moved += a.numel()
    return moved


def _restore_threads(n: int) -> int:
    raw = os.environ.get(ENV_RESTORE_THREADS, "")
    if raw.isdigit() and int(raw) > 0:
        return int(raw)
    return max(1, min(16, n, os.cpu_count() or 4))


def restore_resharded(directory_or_path: str, state, rules=None,
                      max_workers: Optional[int] = None,
                      log: Callable[[str], None] = print,
                      stats: Optional[ReadStats] = None, mesh=None,
                      model_config=None):
    """Restore a checkpoint into `state` whatever split wrote it
    (reshard-on-read): a replica's checkpoint, one split over fsdp x ep
    x tp or a pipeline state's, into the LM trainer's state over any
    fsdp, ep and tp, a pipeline state over any pp, tp and ep, any world
    size. The saved layout is rebuilt from `layout.json` alone (its mesh
    sizes and the parameters), so the mesh that wrote it need not exist.

    Each saved tensor (a shard's buffer, or one canonical key) that holds
    something this rank needs is read whole, its values copied into host
    staging buffers shaped like the state's, and dropped; a thread pool
    (`max_workers`, default TPU_RESTORE_THREADS or up to 16) overlaps the
    reads. Once every value is in, the staging is copied into the live
    state (a torn candidate raises before the state is touched) and the
    state refreshes what it derives (fsdp's gathered working copy).

    `rules` (the reference's regex restore rules) override where a
    parameter lands: ((pattern, ...), spec) pairs over the path (kind,
    *name components), kind "params", "mu" or "nu"; the first hit wins;
    a None spec replicates. A state holds each parameter in its own
    block, so a rule must give that block's shape; a dict target
    {"params/<name>": tensor, ...} of the model `model_config` takes
    any, its blocks placed on `mesh` (unmatched keys land whole).
    `stats` (a ReadStats) records the bytes read and the peak in flight.
    Raises ValueError on another model's checkpoint or a shape that does
    not fit, TypeError on a state it does not restore (the HFTA and
    image trainers': under maybe_resume those take the plain restore).
    Returns `state`."""
    wait_for_checkpoints()
    path = os.fspath(directory_or_path)
    if not os.path.basename(path).startswith("step_"):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
        path = latest
    path = os.path.abspath(path)
    _quiet_single_process()
    stats = stats if stats is not None else ReadStats()
    t0 = time.monotonic()
    if isinstance(state, dict):
        if model_config is None:
            raise ValueError("a dict target needs model_config=")
        cfg = model_config
    else:
        layout = getattr(state, "layout_key", None) or {}
        if "pp" not in layout.get("mesh", {}) and not hasattr(state,
                                                             "masters"):
            raise TypeError(f"restore_resharded restores the LM trainers' "
                             f"states and dicts of parameters, not a "
                             f"{type(state).__name__}")
        cfg = state.model.config
    live, staging = _live_pieces(state, cfg, rules, mesh)
    saved, metas = _saved_pieces(path, cfg, stats)
    stats.leaves = len(staging) + 1
    by_name: Dict[Tuple[str, str], List[_Piece]] = {}
    for piece in live:
        by_name.setdefault((piece.which, piece.name), []).append(piece)
    jobs: Dict[Tuple[str, str], List[_Piece]] = {}
    for piece in saved:
        if (piece.which, piece.name) in by_name:
            jobs.setdefault(piece.where, []).append(piece)
    need = sum(p.b - p.a for p in live)
    moved = [0]
    lock = threading.Lock()

    def read(where, pieces):
        src, key = where
        meta = dict(metas)[src][key]
        t = torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
        nbytes = t.numel() * t.element_size()
        stats.begin_read(nbytes)
        try:
            dcp.load({key: t}, storage_reader=dcp.FileSystemReader(src),
                     no_dist=True)
            n = 0
            for sp in pieces:
                for dst in by_name[(sp.which, sp.name)]:
                    n += _scatter(t, sp, dst)
            with lock:
                moved[0] += n
        finally:
            del t
            stats.end_read(nbytes)

    with ThreadPoolExecutor(max_workers=max_workers or _restore_threads(
            len(jobs)), thread_name_prefix="reshard-restore") as pool:
        for f in [pool.submit(read, where, pieces)
                  for where, pieces in jobs.items()]:
            f.result()
    if moved[0] != need:
        raise ValueError(f"{path} gave {moved[0]} of the {need} values this "
                         f"rank holds")
    first = metas[0][0]
    step = torch.zeros((), dtype=torch.int64)
    count = torch.zeros((), dtype=torch.int32)
    scalars = {"step": step}
    if "opt.count" in metas[0][1]:
        scalars["opt.count"] = count
    dcp.load(scalars, storage_reader=dcp.FileSystemReader(first),
             no_dist=True)
    with torch.no_grad():
        for key, (t, host) in staging.items():
            if host is not None:
                t.copy_(host)
            elif key == "opt.count":
                t.fill_(int(count))
    if not isinstance(state, dict):
        state.step = int(step)
        if hasattr(state, "after_restore"):
            state.after_restore()
    stats.seconds = time.monotonic() - t0
    _LAST_RESTORE_INFO.update(
        path=path, seconds=round(stats.seconds, 3), leaves=stats.leaves,
        resharded=True, step=int(step), bytes_read=stats.bytes_read,
        peak_in_flight_bytes=stats.peak_in_flight_bytes)
    return state


def _resharded_with_fallback(log: Callable[[str], None]):
    """The per-candidate restore of restore_with_fallback under
    TPU_RESHARD_RESTORE (the reference's `_resharded_with_orbax_fallback`):
    the resharding reader first; a genuine mismatch or a missing file
    (ValueError, FileNotFoundError) moves on to the previous step_N, any
    other failure of the reader retries the SAME candidate through the
    plain restore first."""
    def _restore(path: str, state):
        try:
            return restore_resharded(path, state, log=log)
        except (ValueError, FileNotFoundError):
            raise
        except Exception as exc:  # noqa: BLE001 - the reader's surprises
            log(f"WARNING: resharded restore of {path} failed ({exc!r}); "
                f"retrying through the plain restore")
            return restore_checkpoint(path, state)
    return _restore


def restore_with_fallback(train_dir, state, log=print, restore=None
                          ) -> Tuple[Any, Optional[str]]:
    """Newest-first restore with per-candidate fallback: a candidate that
    fails the integrity check OR raises during the restore (bytes
    scribbled inside a committed directory) logs a warning and falls
    back to the previous step_N. Returns (state, restored_path) —
    restored_path is None when nothing restorable exists (state
    untouched). `restore` swaps the per-candidate restore fn."""
    wait_for_checkpoints()
    restore_fn = restore if restore is not None else restore_checkpoint
    directory = os.path.abspath(train_dir)
    for step in reversed(checkpoint_steps(directory)):
        path = os.path.join(directory, f"step_{step}")
        if not verify_checkpoint(path):
            log(f"WARNING: checkpoint {path} failed the integrity check "
                f"(uncommitted or torn write); falling back to the "
                f"previous step")
            continue
        try:
            _LAST_RESTORE_INFO.clear()
            t0 = time.monotonic()
            restored = restore_fn(path, state)
            seconds = time.monotonic() - t0
            payload = _state_payload(restored)
            leaves = 1 + len(payload)                    # + step
            log(f"INFO: restored {path} in {seconds:.2f}s "
                f"({leaves} leaves)")
            read = {k: _LAST_RESTORE_INFO[k] for k in
                    ("bytes_read", "peak_in_flight_bytes")
                    if k in _LAST_RESTORE_INFO}
            resharded = bool(_LAST_RESTORE_INFO.get("resharded"))
            _LAST_RESTORE_INFO.clear()
            _LAST_RESTORE_INFO.update(
                path=path, seconds=round(seconds, 3), leaves=leaves,
                resharded=resharded, bytes=_nbytes(payload), **read)
            return restored, path
        except ReshardRequired:
            raise
        # DCP reports a failed read as CheckpointException, which derives
        # from BaseException, not Exception
        except (Exception, CheckpointException) as exc:  # noqa: BLE001
            log(f"WARNING: checkpoint {path} is corrupt ({exc!r}); "
                f"falling back to the previous step")
    return state, None


def last_restore_info() -> Dict[str, Any]:
    """{"path", "seconds", "leaves", "resharded", "bytes"} of the most
    recent successful restore in this process (empty dict when none);
    a resharded one adds "bytes_read" and "peak_in_flight_bytes"."""
    return dict(_LAST_RESTORE_INFO)


def maybe_resume(train_dir, state, log=print, reshard: Optional[bool] = None):
    """Restore the newest INTACT checkpoint under train_dir into `state`
    (no-op when train_dir is falsy or empty); a corrupted newest step_N
    falls back to the previous one with a logged warning. The single
    resume path the benchmark entry point uses. `reshard` (default: the
    TPU_RESHARD_RESTORE env knob, "1"/"true") routes each candidate
    through restore_resharded, falling back to the plain restore of the
    same candidate when the reader itself fails: what a gang resized
    4 -> 2 needs when its checkpoint was split over a mesh that is
    gone."""
    if reshard is None:
        reshard = os.environ.get(ENV_RESHARD_RESTORE, "").lower() \
            in ("1", "true", "yes")
    if not train_dir:
        return state
    state, path = restore_with_fallback(
        train_dir, state, log,
        restore=_resharded_with_fallback(log) if reshard else None)
    if path is not None:
        log(f"resumed from {path} (step {int(state.step)})")
    return state


def maybe_save(train_dir, state, log=print, block: bool = True):
    """Write a checkpoint when train_dir is set. Skips the write when
    THIS process already saved this step (the periodic hook fired on the
    final step) — rewriting would replace the committed copy for
    nothing. The skip decision uses the in-process _LAST_SAVED record,
    never the filesystem. block=True (the default) returns with the
    write committed — what the emergency path needs; benchmark exits
    pass block=False and join once via wait_for_checkpoints()."""
    if not train_dir:
        return
    step = int(state.step)
    if _LAST_SAVED.get(os.path.abspath(train_dir)) == step:
        if block:
            wait_for_checkpoints()            # join the in-flight write
        log(f"checkpoint for step {step} already written")
        return
    path = save_checkpoint(train_dir, state, block=block)
    log(f"checkpoint written to {path}")


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def gc_checkpoints(train_dir, keep_last: int, log=print) -> List[int]:
    """Delete all but the newest `keep_last` committed step_N directories.
    Only rank 0 deletes (concurrent rmtree of one shared path races).
    Returns the deleted step numbers. The in-flight write is invisible
    here (tmp-named until commit) and the newest committed steps are by
    construction never deleted."""
    if not train_dir or keep_last <= 0:
        return []
    if _rank() != 0:
        return []
    directory = os.path.abspath(train_dir)
    doomed = checkpoint_steps(directory)[:-keep_last]
    for step in doomed:
        shutil.rmtree(os.path.join(directory, f"step_{step}"),
                      ignore_errors=True)
    if doomed:
        log(f"checkpoint gc: removed steps {doomed} "
            f"(keep-last {keep_last})")
    return doomed


def reset_saved_state() -> None:
    """Forget the per-directory last-saved records (joining any in-flight
    write first). For tests and back-to-back in-process runs against a
    reused train_dir."""
    wait_for_checkpoints()
    _LAST_SAVED.clear()


def periodic_saver(train_dir, every: int, log=print, keep_last: int = 0,
                   resilience=None) -> Optional[Callable]:
    """A `hook(state, step)` for training loops: every `every` steps it
    fires a NON-blocking checkpoint (training overlaps the write).
    keep_last > 0 garbage-collects older step_N directories before each
    save. None when disabled.

    `resilience` (a ResilienceContext) gets record_checkpoint(step) on
    the NEXT firing, after the write was joined — the `checkpoint_saved`
    event describes a committed checkpoint, not an in-flight one."""
    if not train_dir or every <= 0:
        return None
    pending: List[int] = []

    def hook(state, step: int) -> None:
        if step % every == 0:
            # join the previous write before gc'ing or dispatching the
            # next: gc must never race a write it cannot see
            wait_for_checkpoints()
            if resilience is not None:
                while pending:
                    resilience.record_checkpoint(pending.pop(0))
            if keep_last > 0:
                gc_checkpoints(train_dir, keep_last, log)
            path = save_checkpoint(train_dir, state, step=step, block=False)
            if resilience is not None:
                pending.append(step)
            log(f"async checkpoint -> {path}")
    return hook


__all__ = ["ENV_RESHARD_RESTORE", "ENV_RESTORE_THREADS", "ReadStats",
           "ReshardRequired", "SHARD_WAIT", "WRITER_THREADS",
           "checkpoint_steps", "restore_resharded",
           "gc_checkpoints", "last_restore_info", "last_save_info",
           "latest_checkpoint", "maybe_resume", "maybe_save",
           "periodic_saver", "reset_saved_state", "restore_checkpoint",
           "restore_with_fallback", "save_checkpoint", "verify_checkpoint",
           "wait_for_checkpoints"]
