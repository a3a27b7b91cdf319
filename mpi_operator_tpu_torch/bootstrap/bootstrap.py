"""Worker/launcher process bootstrap on torch.distributed: the port's copy
of `mpi_operator_tpu/bootstrap/bootstrap.py`.

Every worker runs its own process from the pod command. At startup the
process calls `initialize()`, which
  1. reads the env the controller injected (TPU_COORDINATOR_ADDRESS,
     TPU_NUM_PROCESSES, TPU_WORKER_HOSTNAMES), falling back to the
     ConfigMap mount at /etc/tpu;
  2. derives its rank from the StatefulSet pod hostname's trailing
     ordinal (`<job>-worker-<i>`), times TPU_SLOTS_PER_WORKER plus
     TPU_LOCAL_RANK when `launch.py` forks several ranks a worker;
  3. picks its card, `cuda:{TPU_LOCAL_RANK % cards}`, and joins the
     process group: `torch.distributed.init_process_group` at
     `tcp://{coordinator_address}` with rank = process_id and world
     size = num_processes, over NCCL on the card and gloo with
     `device="cpu"` or where a worker's ranks outnumber its cards (NCCL
     refuses two ranks on one card; gloo all-reduces CUDA tensors).
     MASTER_ADDR,
     MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK are exported for
     torch tools that read them.

The env contract, `process_info`, the readiness gate, the status
channel and `launcher_wait` are the reference's, copied (this package
imports nothing of the JAX one). What differs is the rendezvous:

- the coordinator (rank 0) hosts the TCPStore; every other rank first
  connects a client with a short per-attempt timeout
  (`ATTEMPT_TIMEOUT`, 10 s), so a coordinator that is
  late costs a retry under the reference's bounded backoff
  (TPU_INIT_RETRIES, TPU_INIT_BACKOFF) instead of one long wait inside
  TCPStore's own connect loop; the connected store then gets the
  group's full timeout;
- a rank outside [0, world size) is refused before any connection (a
  torch rendezvous would wait forever), as a ValueError: fatal;
- retry classification keeps the reference's fatal markers and adds
  torch's: ValueError is fatal; DistNetworkError, DistStoreError
  (timeouts) and "connection refused" are retryable.

The `delay-coordinator` fault (TPU_FAULT_INJECT) fails the first N
attempts, each recorded as an `init_retry` event. `hybrid_mesh` lays the
job's mesh (parallel/mesh.py) over the ranks straight from this
topology: the slices on the dcn dim, outermost, as `process_info`
numbers the ranks slice-major.
"""
from __future__ import annotations

import os
import re
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Mapping, Optional

# env names match controller.py:_discovery_env
ENV_COORDINATOR = "TPU_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPU_NUM_PROCESSES"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_WORKER_ID = "TPU_WORKER_ID"            # explicit override only
ENV_SLOTS = "TPU_SLOTS_PER_WORKER"
ENV_LOCAL_RANK = "TPU_LOCAL_RANK"          # set by bootstrap.launch for slots>1
ENV_CONFIG_PATH = "TPU_CONFIG_PATH"
ENV_LAUNCHER = "TPU_LAUNCHER"
ENV_NUM_SLICES = "TPU_NUM_SLICES"
# multi-slice (controller injects per worker GROUP, i.e. per StatefulSet):
# the pod hostname ordinal is slice-LOCAL; the global rank folds in the
# slice id — global worker index = slice_id * workers_per_slice + ordinal
ENV_SLICE_ID = "TPU_SLICE_ID"
ENV_WORKERS_PER_SLICE = "TPU_WORKERS_PER_SLICE"
# TPU-health readiness gate (SURVEY §7 "Readiness vs ICI formation"):
# when the controller injects TPU_READY_FILE, the worker writes the marker
# only after the accelerator runtime proved usable (device_check), and the
# injected readinessProbe checks the file — so the pod's Ready (and hence
# the launcher gate, ref mpi_job_controller.go:503-509) means "chips
# enumerate", not just "container started".
ENV_READY_FILE = "TPU_READY_FILE"
ENV_EXPECTED_CHIPS = "TPU_EXPECTED_CHIPS"
READY_FILE_DEFAULT = "/tmp/tpu-ready"

#: rank-0 serves job status here for the launcher's completion poll
STATUS_PORT = 8477
#: port-only override of STATUS_PORT (gangs sharing one host, tests)
ENV_STATUS_PORT = "TPU_STATUS_PORT"
# launcher gave up on an unreachable rank-0 (infra loss, NOT a workload
# failure); chosen in the 128-255 "retryable" band of the reference's
# v1alpha2 exit-code policy (ref common_types.go:150-155)
LAUNCHER_LOST_EXIT = 213

# Bounded exponential-backoff retry around the process-group rendezvous:
# the coordinator pod being seconds late is the COMMON case at gang
# start (StatefulSet pods come up in any order), and a single un-retried
# connect would turn that race into a crash-loop.
ENV_INIT_RETRIES = "TPU_INIT_RETRIES"      # attempts, default 5
ENV_INIT_BACKOFF = "TPU_INIT_BACKOFF"      # base delay seconds, default 1.0
_INIT_BACKOFF_CAP = 30.0

_ORDINAL_RE = re.compile(r"-(\d+)$")
_SLICE_RE = re.compile(r"-s(\d+)-\d+$")   # <job>-worker-s<k>-<i>


class BootstrapError(RuntimeError):
    pass


@dataclass(frozen=True)
class ProcessInfo:
    """Everything the process-group rendezvous needs, plus topology
    context."""
    coordinator_address: str
    num_processes: int
    process_id: int
    slots_per_worker: int = 1
    num_slices: int = 1
    slice_id: int = 0
    workers_per_slice: int = 0     # 0 = single-slice (all workers)
    is_launcher: bool = False

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def resolve_worker_ordinal(hostname: str) -> int:
    """`<job>-worker-<i>` → i. The hostfile-analogue rank derivation."""
    m = _ORDINAL_RE.search(hostname)
    if m is None:
        raise BootstrapError(
            f"hostname {hostname!r} carries no trailing ordinal; expected a "
            f"StatefulSet pod name like 'job-worker-3'")
    return int(m.group(1))


def _read_config_dir(path: str) -> dict:
    """Fallback discovery from the ConfigMap mount (controller.new_config_map
    keys), for processes exec'd without the env (debug shells)."""
    data = {}
    if not os.path.isdir(path):
        return data
    for key in ("coordinator-address", "num-processes", "slots-per-worker",
                "num-slices", "workers-per-slice"):
        p = os.path.join(path, key)
        if os.path.exists(p):
            with open(p) as f:
                data[key] = f.read().strip()
    return data


def process_info(
    env: Optional[Mapping[str, str]] = None,
    hostname: Optional[str] = None,
) -> ProcessInfo:
    """Pure resolution (no torch.distributed call) — unit-testable."""
    env = dict(os.environ if env is None else env)
    cfg = _read_config_dir(env.get(ENV_CONFIG_PATH, "/etc/tpu"))

    coordinator = env.get(ENV_COORDINATOR) or cfg.get("coordinator-address")
    if not coordinator:
        raise BootstrapError(
            f"{ENV_COORDINATOR} not set and no ConfigMap fallback — was this "
            f"process started by the TPUJob controller?")
    num_processes = int(
        env.get(ENV_NUM_PROCESSES) or cfg.get("num-processes") or 1)
    slots = int(env.get(ENV_SLOTS) or cfg.get("slots-per-worker") or 1)
    num_slices = int(env.get(ENV_NUM_SLICES) or cfg.get("num-slices") or 1)
    is_launcher = env.get(ENV_LAUNCHER) == "1"
    if env.get(ENV_SLICE_ID):        # empty string = unset (YAML artifact)
        slice_id = int(env[ENV_SLICE_ID])
    elif (num_slices > 1 and not is_launcher
          and ENV_WORKER_ID not in env):
        # ConfigMap-fallback processes (debug shells) have no slice env;
        # the slice id is recoverable from the pod name's group token
        # (`<job>-worker-s<k>-<i>`). Defaulting to 0 would collide global
        # ranks across slices and hang the rendezvous. Launchers and
        # explicit-TPU_WORKER_ID processes don't derive from hostnames.
        m = _SLICE_RE.search(hostname or socket.gethostname())
        if m is None:
            raise BootstrapError(
                f"numSlices={num_slices} but neither {ENV_SLICE_ID} nor a "
                f"slice-group hostname (…-s<k>-<i>) identifies this "
                f"process's slice")
        slice_id = int(m.group(1))
    else:
        slice_id = 0
    workers_per_slice = int(
        env.get(ENV_WORKERS_PER_SLICE) or cfg.get("workers-per-slice") or 0)
    if num_slices > 1 and workers_per_slice == 0:
        # derivable: ranks divide evenly over slices (admission enforces it)
        workers_per_slice = num_processes // (slots * num_slices)
    if slice_id >= max(num_slices, 1):
        raise BootstrapError(
            f"{ENV_SLICE_ID}={slice_id} >= num_slices {num_slices}")

    if ENV_WORKER_ID in env:
        pid = int(env[ENV_WORKER_ID])
    elif is_launcher or num_processes == 1:
        # The launcher is NOT a rank (see initialize()); pid 0 here is only
        # its bookkeeping view. Single-process jobs are rank 0 by definition
        # — no ordinal-bearing hostname needed (dev boxes, notebooks).
        pid = 0
    else:
        # Multi-slice: the StatefulSet ordinal is slice-LOCAL (pod
        # `<job>-worker-s<k>-<i>` → i); fold in the slice id so global
        # worker indexes are slice-major — exactly the order the
        # controller publishes worker-hostnames in (the hostfile-analogue
        # topology truth, ref mpi_job_controller.go:857-869).
        ordinal = resolve_worker_ordinal(hostname or socket.gethostname())
        if num_slices > 1:
            ordinal = slice_id * workers_per_slice + ordinal
        # slots>1: bootstrap.launch forks `slots` local processes per worker
        # (the orted replacement) and tags each with TPU_LOCAL_RANK; the
        # global rank interleaves exactly like the reference hostfile's
        # `slots=` lines (ref mpi_job_controller.go:857-869).
        local_rank = int(env.get(ENV_LOCAL_RANK, 0))
        if local_rank >= slots:
            raise BootstrapError(
                f"{ENV_LOCAL_RANK}={local_rank} >= slots_per_worker {slots}")
        pid = ordinal * slots + local_rank
        if pid >= num_processes:
            raise BootstrapError(
                f"derived rank {pid} (worker {ordinal}, local {local_rank}) "
                f">= num_processes {num_processes}")
    return ProcessInfo(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=pid,
        slots_per_worker=slots,
        num_slices=num_slices,
        slice_id=slice_id,
        workers_per_slice=workers_per_slice,
        is_launcher=is_launcher,
    )


def hybrid_mesh(info: Optional[ProcessInfo] = None, **axes):
    """The job's device mesh straight from the bootstrap topology: the
    `dcn` dim gets num_slices (collectives across slices then run over
    dcn, parallel/collectives.py), the ranks of the process group (one
    card each; one process without a group) spread over the given axes,
    by default pure data parallelism, the reference's sole strategy.
    The env-contract path: controller env -> process_info -> mesh."""
    import torch.distributed as dist

    from ..parallel.mesh import MeshConfig, data_parallel_mesh, make_mesh

    info = info if info is not None else process_info()
    if not axes:
        return data_parallel_mesh(info.num_slices)
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    cfg = MeshConfig(dcn=info.num_slices, **axes)
    if cfg.num_devices != n:
        raise BootstrapError(
            f"mesh axes {axes} x num_slices {info.num_slices} = "
            f"{cfg.num_devices} devices, but the job sees {n}")
    return make_mesh(cfg)


def device_check(expected_chips: Optional[int] = None) -> int:
    """Prove the accelerator runtime is usable from THIS process: count
    the CUDA devices it sees and (optionally) check the count against
    what the controller allocated. Raises BootstrapError with an
    actionable message otherwise."""
    import torch

    try:
        n = torch.cuda.device_count()
    except Exception as exc:  # noqa: BLE001 — runtime init failures vary
        raise BootstrapError(
            f"CUDA runtime failed to initialize: {exc}") from exc
    if n == 0:
        raise BootstrapError(
            "the CUDA runtime reports ZERO devices — the GPU stack is sick "
            "or "
            "the pod is missing its GPU resource limit")
    if expected_chips and n != expected_chips:
        raise BootstrapError(
            f"the CUDA runtime enumerates {n} device(s) but the controller "
            f"allocated {expected_chips} to this worker — check node health")
    return n


def mark_ready(path: Optional[str] = None) -> Optional[str]:
    """Write the readiness marker the injected probe checks. No-op (None)
    when no path is configured — dev/test processes outside the operator
    don't leave marker litter."""
    path = path or os.environ.get(ENV_READY_FILE)
    if not path:
        return None
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("ok\n")
    os.replace(tmp, path)      # atomic: the probe never sees a torn write
    return path


#: how long one rendezvous attempt may wait for the coordinator's store
ATTEMPT_TIMEOUT = timedelta(seconds=10)
#: the joined group's timeout (collectives, the init barrier)
GROUP_TIMEOUT = timedelta(minutes=30)
_FATAL_MARKERS = ("process id", "process_id", "num_processes", "mismatch",
                  "already initialized", "duplicate", "invalid")


def _retryable_init_error(exc: BaseException) -> bool:
    """Classify a rendezvous failure: coordinator-not-yet-listening
    (torch's DistNetworkError, a DistStoreError timeout, "connection
    refused") is retryable; an identity mismatch (a rank outside the
    gang, double init) is NOT — retrying a misconfiguration just hides
    the config bug behind a timeout."""
    import torch.distributed as dist

    if isinstance(exc, ValueError):
        return False
    msg = str(exc).lower()
    if isinstance(exc, (dist.DistNetworkError, dist.DistStoreError)) \
            or "connection refused" in msg:
        return True
    return not any(marker in msg for marker in _FATAL_MARKERS)


def local_device(env: Mapping[str, str], cpu: bool = False):
    """This rank's device: the CPU when asked, else `cuda:{local_rank %
    cards}` (several slots on one card share it)."""
    import torch

    if cpu:
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise BootstrapError("no CUDA device is available; pass "
                             "device='cpu' to run the rank on the CPU")
    return torch.device("cuda", int(env.get(ENV_LOCAL_RANK, 0) or 0) % n)


def dist_backend(info: ProcessInfo, cpu: bool = False) -> str:
    """The process group's backend: gloo on the CPU, and on the card
    when this worker's ranks (its slots) outnumber its cards, since NCCL
    refuses two ranks on one card and gloo all-reduces CUDA tensors;
    NCCL otherwise."""
    if cpu:
        return "gloo"
    import torch

    return ("gloo" if info.slots_per_worker > torch.cuda.device_count()
            else "nccl")


def _join_group(info: ProcessInfo, env: Mapping[str, str],
                backend: str) -> None:
    """One rendezvous attempt: rank 0 hosts the TCPStore, the others
    connect to it within the per-attempt timeout; then the group."""
    import torch.distributed as dist

    if not 0 <= info.process_id < info.num_processes:
        raise ValueError(
            f"rank {info.process_id} is outside the gang of "
            f"{info.num_processes} processes")
    host, _, port = info.coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address "
                         f"{info.coordinator_address!r} is not host:port")
    store = dist.TCPStore(host, int(port), info.num_processes,
                          info.process_id == 0,
                          timeout=GROUP_TIMEOUT if info.process_id == 0
                          else ATTEMPT_TIMEOUT)
    store.set_timeout(GROUP_TIMEOUT)
    dist.init_process_group(backend, store=store, rank=info.process_id,
                            world_size=info.num_processes,
                            timeout=GROUP_TIMEOUT)


def _initialize_distributed(info: ProcessInfo,
                            env: Mapping[str, str],
                            log=print,
                            init_fn=None,
                            sleep=None,
                            events=None,
                            backend: str = "gloo") -> None:
    """The rendezvous with bounded exponential backoff.
    TPU_INIT_RETRIES attempts (default 5), TPU_INIT_BACKOFF base delay
    doubling per attempt (default 1s, capped at 30s). A non-retryable
    failure (see _retryable_init_error) raises immediately; exhausting
    the budget raises BootstrapError. `init_fn`/`sleep` are injectable
    for tests. Honors the delay-coordinator fault (TPU_FAULT_INJECT) so
    the retry machinery itself is testable end-to-end. `events` (a
    telemetry EventLog) records one init_retry record per failed
    attempt — each is fsync'd before the backoff sleep, so the log shows
    a flapping coordinator even when a later attempt succeeds."""
    import time as _time

    if init_fn is None:
        def init_fn():
            _join_group(info, env, backend)
    sleep = sleep if sleep is not None else _time.sleep
    attempts = max(1, int(env.get(ENV_INIT_RETRIES) or 5))
    backoff = float(env.get(ENV_INIT_BACKOFF) or 1.0)
    faults = None
    if env.get("TPU_FAULT_INJECT"):
        from ..train.resilience import FaultInjector
        faults = FaultInjector.from_env(env)
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            if faults is not None and faults.fail_init_attempt():
                raise RuntimeError(
                    "fault-inject: coordinator not yet listening "
                    "(delay-coordinator)")
            init_fn()
            return
        except Exception as exc:  # noqa: BLE001 — classified below
            last = exc
            if not _retryable_init_error(exc):
                raise
            if attempt == attempts - 1:
                break
            delay = min(backoff * (2 ** attempt), _INIT_BACKOFF_CAP)
            log(f"torch.distributed rendezvous attempt "
                f"{attempt + 1}/{attempts} failed ({exc}); retrying in "
                f"{delay:.1f}s")
            if events is not None:
                from ..telemetry import events as ev
                events.emit(ev.INIT_RETRY, attempt=attempt + 1,
                            attempts=attempts, error=str(exc),
                            backoff_seconds=delay,
                            process_id=info.process_id)
            sleep(delay)
    raise BootstrapError(
        f"torch.distributed rendezvous failed after {attempts} "
        f"attempt(s): {last}") from last


def initialize(env: Optional[Mapping[str, str]] = None,
               hostname: Optional[str] = None,
               events=None, device=None) -> ProcessInfo:
    """Resolve, pick this rank's device and join the process group.

    `device="cpu"` runs the rank on the CPU (gloo); otherwise the rank's
    card is `cuda:{TPU_LOCAL_RANK % cards}`, made the current device,
    and the group is `dist_backend`'s: NCCL, or gloo where ranks share a
    card. `events` (an optional telemetry EventLog) captures
    the clock anchor and the init_retry records of the backoff loop.

    The LAUNCHER never joins the process group: it has no card and rank
    0 lives on worker-0 (whose hostname the coordinator address points
    at). Like `mpirun` in the reference, the launcher is only the
    completion signal — it observes rank-0's status channel
    (`launcher_wait`) and exits with the job's code. Single-process jobs
    (num_processes == 1) skip the group too.
    """
    info = process_info(env, hostname)
    resolved_env = dict(os.environ if env is None else env)
    cpu = device is not None and str(device) == "cpu"
    if events is not None and not info.is_launcher:
        # clock anchor for the controller-side timeline merge, emitted
        # FIRST so even a bootstrap that never converges leaves it
        import uuid
        from ..telemetry import events as ev
        events.emit(ev.CLOCK_ANCHOR, boot_id=uuid.uuid4().hex[:12],
                    process_id=info.process_id,
                    num_processes=info.num_processes)
    if info.is_launcher:
        return info
    local_rank = int(resolved_env.get(ENV_LOCAL_RANK, 0) or 0)
    dev = local_device(resolved_env, cpu)
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev)
    if info.num_processes > 1:
        host, _, port = info.coordinator_address.rpartition(":")
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port,
                          RANK=str(info.process_id),
                          WORLD_SIZE=str(info.num_processes),
                          LOCAL_RANK=str(local_rank))
        _initialize_distributed(info, resolved_env, events=events,
                                backend=dist_backend(info, cpu))
    gated = (ENV_READY_FILE in resolved_env
             or ENV_EXPECTED_CHIPS in resolved_env)
    if not cpu and (gated or info.num_processes > 1):
        # readiness gate: the pod reads Ready only once its cards
        # enumerate, so the gated launcher never starts against a sick
        # node and the first collective cannot hang until the deadline
        expected = int(resolved_env.get(ENV_EXPECTED_CHIPS, 0) or 0)
        device_check(expected_chips=expected or None)
    ready_path = resolved_env.get(ENV_READY_FILE)
    if ready_path and (gated or info.num_processes > 1):
        mark_ready(ready_path)
    return info


# ---------------------------------------------------------------------------
# Completion channel: rank-0 status server ←poll— launcher
# ---------------------------------------------------------------------------
# Replaces the completion semantics mpirun gave the reference for free (all
# ranks are mpirun's children; it exits when they do — SURVEY §3.3). Here
# ranks are independent pods, so rank-0 exposes a one-line TCP status
# ("running" | "done <exitcode>") and the launcher polls it.
#
# Handshake: the poller's first line is the job token (the TPUJob uid,
# injected by the controller as TPU_JOB_TOKEN into launcher AND workers).
# A mismatching or missing token gets "denied" and does NOT count as the
# launcher having observed completion — a stray cluster connection can't
# consume the done-linger and race the real launcher out of its exit code.

ENV_JOB_TOKEN = "TPU_JOB_TOKEN"


class StatusServer:
    """Tiny TCP status endpoint served by rank-0 next to training."""

    def __init__(self, port: int = STATUS_PORT, token: Optional[str] = None):
        import threading

        self.token = (token if token is not None
                      else os.environ.get(ENV_JOB_TOKEN, ""))
        self._state = "running"
        self._lock = threading.Lock()
        self._served_done = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._serve, name="tpu-status", daemon=True)
        self._thread.start()

    def _authorized(self, conn) -> bool:
        if not self.token:
            return True          # tokenless dev mode: accept everyone
        try:
            conn.settimeout(2.0)
            # errors="replace": binary garbage (TLS probes, port scanners)
            # must compare unequal, not blow up the serving thread
            line = conn.makefile("rb").readline().decode(
                errors="replace").strip()
            return line == self.token
        except OSError:
            return False

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # nothing a single connection does may kill the serving thread
            # or leak its fd — rank-0 going "unreachable" here triggers a
            # spurious gang restart
            try:
                authorized = self._authorized(conn)
                with self._lock:
                    state = self._state if authorized else "denied"
                conn.sendall(state.encode() + b"\n")
                if authorized and state.startswith("done"):
                    self._served_done.set()
            except Exception:  # noqa: BLE001 — stray-client hardening
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def set_done(self, exit_code: int, linger: float = 10.0) -> None:
        """Mark done and give the launcher a chance to observe it before the
        process exits: returns once a poller has read the done state or
        `linger` elapsed."""
        with self._lock:
            self._state = f"done {exit_code}"
        self._served_done.wait(timeout=linger)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def status_port(env: Optional[Mapping[str, str]] = None) -> int:
    """The status channel's port: TPU_STATUS_PORT, else STATUS_PORT."""
    env = os.environ if env is None else env
    return int(env.get(ENV_STATUS_PORT) or STATUS_PORT)


def poll_status(host: str, port: int = STATUS_PORT,
                timeout: float = 2.0,
                token: Optional[str] = None) -> Optional[str]:
    """One status read; None if unreachable. Sends the job-token handshake
    line first (empty token line for tokenless dev servers)."""
    if token is None:
        token = os.environ.get(ENV_JOB_TOKEN, "")
    try:
        with socket.create_connection((host, port), timeout=timeout) as conn:
            conn.sendall(token.encode() + b"\n")
            return conn.makefile().readline().strip()
    except OSError:
        return None


def launcher_wait(info: ProcessInfo, port: int = STATUS_PORT,
                  poll_interval: float = 2.0,
                  startup_timeout: float = 600.0,
                  lost_timeout: float = 120.0,
                  token: Optional[str] = None) -> int:
    """Block until rank-0 reports completion; return its exit code.

    Explicit state machine:

      STARTING ──contact──▶ RUNNING ──outage──▶ LOST ──lost_timeout──▶
      RESTARTING ──fresh startup_timeout expires──▶ LAUNCHER_LOST_EXIT

    STARTING: before first contact, wait up to `startup_timeout` (workers
    are already Ready — the controller gates the launcher on that — so
    rank-0's server appears as soon as its process starts); expiry raises
    BootstrapError. RUNNING: normal polling. LOST: the server went
    unreachable — the worker pod restarted mid-run (kubelet restarts
    workers, ref RestartPolicy Always, mpi_job_controller.go:1021); brief
    outages under `lost_timeout` are tolerated. RESTARTING: the outage
    outlived `lost_timeout`, so treat it as a pod reschedule and allow a
    FRESH `startup_timeout` window for the new pod to come up. ANY
    successful contact returns to RUNNING and fully resets both windows —
    repeated transient outages never accumulate toward the give-up
    deadline. Give-up exit is LAUNCHER_LOST_EXIT (128-255 retryable band)
    so operators can tell infra loss from application failure; job-level
    activeDeadlineSeconds (ref :1221-1222) remains the global stop."""
    import time as _time

    host = info.coordinator_address.split(":")[0]
    state = "STARTING"
    window_expiry = _time.monotonic() + startup_timeout
    while True:
        status = poll_status(host, port, timeout=poll_interval, token=token)
        now = _time.monotonic()
        if status is not None and status.startswith("done"):
            parts = status.split()
            return int(parts[1]) if len(parts) > 1 else 0
        if status is not None:
            # contact (running/denied both prove liveness) → RUNNING, reset
            state = "RUNNING"
        elif state == "STARTING":
            if now > window_expiry:
                raise BootstrapError(
                    f"rank-0 status channel {host}:{port} unreachable for "
                    f"{startup_timeout}s")
        elif state == "RUNNING":
            state = "LOST"
            window_expiry = now + lost_timeout
        elif state == "LOST":
            if now > window_expiry:
                state = "RESTARTING"
                window_expiry = now + startup_timeout
        elif state == "RESTARTING":
            if now > window_expiry:
                return LAUNCHER_LOST_EXIT
        _time.sleep(poll_interval)


__all__ = [
    "BootstrapError", "ProcessInfo", "initialize", "process_info",
    "resolve_worker_ordinal", "device_check", "mark_ready", "local_device",
    "ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_WORKER_HOSTNAMES",
    "ENV_WORKER_ID", "ENV_SLOTS", "ENV_LOCAL_RANK", "ENV_CONFIG_PATH",
    "ENV_LAUNCHER", "ENV_NUM_SLICES", "ENV_JOB_TOKEN", "ENV_READY_FILE",
    "ENV_EXPECTED_CHIPS", "READY_FILE_DEFAULT",
    "ENV_SLICE_ID", "ENV_WORKERS_PER_SLICE", "dist_backend",
    "ATTEMPT_TIMEOUT", "GROUP_TIMEOUT",
    "StatusServer", "poll_status", "launcher_wait",
    "STATUS_PORT", "ENV_STATUS_PORT", "LAUNCHER_LOST_EXIT",
    "ENV_INIT_RETRIES", "ENV_INIT_BACKOFF", "status_port",
]
