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
copy). A checkpoint of another layout raises `ReshardRequired`.

A pipeline state (train/pp_trainer.py) is saved the same way, one shard
a rank of pp x ep x tp, but its payload is keyed by the canonical
parameter names (a block's with the rank's tp and ep coordinates; the
replicated leaves written once, by the first stage), and `layout.json`
records pp, tp, ep and the parameters, not the schedule. A restore reads
each key it holds from whichever shard wrote it (`restore_payload()`),
so a GPipe checkpoint resumes under 1F1B with any interleave, and back.

Not here (ROADMAP step 10e): `restore_resharded`, `ReadStats` and the
`TPU_RESHARD_RESTORE` knob, which raise when asked for.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.api import CheckpointException

from ..telemetry import span

#: FileSystemWriter threads (DCP's default is 1): one file each
WRITER_THREADS = 4
#: the reference's env knob for a resharding restore (not ported yet)
ENV_RESHARD_RESTORE = "TPU_RESHARD_RESTORE"
_METADATA = ".metadata"
_LAYOUT = "layout.json"
#: seconds shard 0's writer waits for the other shards before it gives up
SHARD_WAIT = 600.0


class ReshardRequired(ValueError):
    """A checkpoint written over another split of the state: restoring it
    needs a resharding restore (ROADMAP.md step 10e)."""

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
            f"restoring it needs restore_resharded, ROADMAP.md step 10e")
    with open(layout_file) as f:
        saved = json.load(f)
    want = dict(getattr(state, "layout_key", None) or {},
                shards=shard[1] if shard else 1)
    if shard is None or saved != json.loads(json.dumps(want)):
        raise ReshardRequired(
            f"{path} was written over {saved.get('mesh')} in "
            f"{saved.get('shards')} shards; this state is "
            f"{want.get('mesh')} in {want['shards']}: restoring it needs "
            f"restore_resharded, ROADMAP.md step 10e")
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
            t0 = time.monotonic()
            restored = restore_fn(path, state)
            seconds = time.monotonic() - t0
            payload = _state_payload(restored)
            leaves = 1 + len(payload)                    # + step
            log(f"INFO: restored {path} in {seconds:.2f}s "
                f"({leaves} leaves)")
            _LAST_RESTORE_INFO.clear()
            _LAST_RESTORE_INFO.update(
                path=path, seconds=round(seconds, 3), leaves=leaves,
                resharded=False, bytes=_nbytes(payload))
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
    recent successful restore in this process (empty dict when none)."""
    return dict(_LAST_RESTORE_INFO)


def maybe_resume(train_dir, state, log=print, reshard: Optional[bool] = None):
    """Restore the newest INTACT checkpoint under train_dir into `state`
    (no-op when train_dir is falsy or empty); a corrupted newest step_N
    falls back to the previous one with a logged warning. The single
    resume path the benchmark entry point uses. A resharding restore
    (`reshard=True`, or TPU_RESHARD_RESTORE=1) is not ported: it raises."""
    if reshard is None:
        reshard = os.environ.get(ENV_RESHARD_RESTORE, "").lower() \
            in ("1", "true", "yes")
    if reshard:
        raise ValueError(
            f"reshard restore ({ENV_RESHARD_RESTORE}): not in the port yet "
            f"(restore_resharded is ROADMAP.md Queue 1, step 10e)")
    if not train_dir:
        return state
    state, path = restore_with_fallback(train_dir, state, log)
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


__all__ = ["ENV_RESHARD_RESTORE", "ReshardRequired", "SHARD_WAIT",
           "WRITER_THREADS", "checkpoint_steps",
           "gc_checkpoints", "last_restore_info", "last_save_info",
           "latest_checkpoint", "maybe_resume", "maybe_save",
           "periodic_saver", "reset_saved_state", "restore_checkpoint",
           "restore_with_fallback", "save_checkpoint", "verify_checkpoint",
           "wait_for_checkpoints"]
