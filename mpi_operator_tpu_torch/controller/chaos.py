"""Chaos harness: crash-consistent reconcile + fault-injection soak.

The reconcile loop's central claim — level-triggered, idempotent, safe to
kill at ANY point — is exactly the claim ordinary unit tests never
exercise: they drive `sync_handler` start-to-finish against a healthy API
server. This harness drives whole job lifecycles while

  - the API server injects seeded transient errors, conflicts, stale
    reads, and dropped watch events (cluster/chaos.py FaultingAPIServer),
  - the controller is KILLED at every write boundary (ControllerCrash,
    a BaseException ≈ SIGKILL raised after the write lands but before
    the controller sees the response) and replaced with a fresh process
    image (new informers, new workqueue, no in-memory state),

then asserts the ORACLE property: the chaos run converges to the same
terminal conditions, the same restart count, and the same owned-resource
set as the identical lifecycle run uninterrupted against a healthy
server — with zero leaked resources after teardown and zero wedged
workqueue keys.

The ClusterSim half plays kubelet + batch-Job controller: it writes pod
readiness and launcher completion directly to the INNER server (the
cluster's own state changes are not subject to faults aimed at the
controller's client).

On top of the control-plane soak, the DATA-plane soak (same module,
same CLI) injects faults into the collector's per-pod scrapes
(telemetry/chaos.py ScrapeFaultInjector) and drives the verdicts that
depend on observed progress rather than API state:

  - partial partition: one rank hard-dark while the rest keep
    reporting — a DegradedGang condition, NEVER a restart (zero false
    positives under pure scrape flakiness);
  - wedged serving gang: a Running serving job whose retired-token
    frontier freezes is caught by the SAME progress lease that catches
    training stalls, within progressDeadlineSeconds;
  - request timeouts: an in-process paged engine retires every
    past-deadline request with zero leaked slots and zero leaked KV
    pages (PageAllocator.check() clean).

Run the standalone soak::

    python -m mpi_operator_tpu_torch.controller.chaos --seed 42 --lifecycles 25

On failure the reproducer seed is printed; rerunning with that seed
replays the identical fault sequence.

The PyTorch port's copy of mpi_operator_tpu/controller/chaos.py, over
the port's own cluster/chaos.py, cluster/apiserver.py, controller and
collector; it imports neither torch nor jax at module load. The
lifecycles keep the reference's `tpus` sizing (the port keeps TPU mode),
so a seed drives the lifecycles the reference drives; "train-gpu" and
"restart-gpu" run the train and restart lifecycles a second time as
nvidia.com/gpu jobs (processingUnits) under the operator's GPU defaults.
The four engine legs (request timeouts, router failover, trace
completeness, live-scale engines) import torch lazily and build the
port's gpt2-test CausalLM from a seeded torch.Generator on `device`,
the CUDA card unless the caller names another; without a card they
raise. The CLI runs them when this process can import torch
(`--device`, default cuda) and reports them skipped in an operator
image without it.
"""
from __future__ import annotations

import json
import random
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..api import types as api
from ..api.types import (
    COND_RUNNING, COND_SUCCEEDED, Container, ObjectMeta,
    PodTemplateSpec, ServingSLO, ServingSpec, TPUJob, TPUJobSpec,
)
from ..cluster.apiserver import ApiError, InMemoryAPIServer
from ..cluster.chaos import ControllerCrash, FaultingAPIServer
from ..cluster.workqueue import RateLimitingQueue
from ..telemetry import events as tev
from ..telemetry.chaos import ScrapeFaultInjector, ScrapeFaultRule
from ..telemetry.collector import JobObservatory, resize_ledger
from .controller import (
    ANNOTATION_TEMPLATE_HASH, LAUNCHER_SUFFIX, ControllerConfig,
    TPUJobController,
)
from .packing import COND_PACKED

#: every kind the controller materializes — enumerated for owned-resource
#: accounting (leak detection scans each kind's store)
OWNED_KINDS = (
    "ConfigMap", "Service", "ServiceAccount", "Role", "RoleBinding",
    "StatefulSet", "Job", "PodDisruptionBudget", "Pod",
)

#: the acceptance-bar fault mix: >=10% transient on every mutating verb,
#: conflicts on TPUJob status updates, stale reads, dropped watch events
DEFAULT_RULES = (
    "mutate/*=0.10:transient",
    "update-status/TPUJob=0.25:conflict",
    "get/*=0.05:stale",
    "watch/*=0.02:drop",
)

#: lifecycle mix the soak cycles through (create, restart, resize, pack,
#: disagg split, teardown — teardown ends every lifecycle)
LIFECYCLES = ("train", "restart", "resize", "pack", "serving")

#: the train and restart lifecycles again as nvidia.com/gpu jobs under
#: the operator's GPU defaults (processingUnits 16: 2 workers x 8 cards)
GPU_LIFECYCLES = ("train-gpu", "restart-gpu")

#: the data-plane fault mix: rank 0 HARD-dark (the partial partition the
#: degraded leg asserts on) while the surviving rank is merely flaky —
#: stale replays and slow links that must neither advance nor freeze the
#: frontier for long enough to matter
DEFAULT_SCRAPE_RULES = (
    "0/fail=1",
    "1/stale-replay=0.2",
    "1/delay=0.1",
)


class ConvergenceError(AssertionError):
    """A lifecycle failed to converge (or converged to the wrong state)
    under chaos. Carries the reproducer seed."""

    def __init__(self, message: str, seed: int):
        super().__init__(f"{message} (reproduce with seed={seed})")
        self.seed = seed


class ChaosHarness:
    """One chaos (or oracle) universe: inner store + faulting wrapper +
    a controller that can be killed and rebuilt at will.

    With ``crash_every_write=True`` every controller incarnation is armed
    to die the instant its next non-Event write lands, so every write
    boundary in every sync path gets a kill/replay — the strongest
    crash-consistency schedule expressible against a synchronous store.
    """

    def __init__(self, rules: Sequence = (), seed: int = 0,
                 crash_every_write: bool = False,
                 config: Optional[ControllerConfig] = None,
                 scrape_faults: Sequence = ()):
        self.inner = InMemoryAPIServer()
        self.api = FaultingAPIServer(self.inner, rules=rules, seed=seed)
        self.seed = seed
        self.crash_every_write = crash_every_write
        self.config = config or ControllerConfig()
        self.ns = self.config.namespace or "default"
        self.controller_restarts = 0
        # data-plane fault rules (telemetry/chaos.py syntax); the
        # injector itself is built when an observatory is attached
        self.scrape_rules: Tuple[ScrapeFaultRule, ...] = tuple(
            r if isinstance(r, ScrapeFaultRule) else ScrapeFaultRule.parse(r)
            for r in scrape_faults)
        self.scrape_injector: Optional[ScrapeFaultInjector] = None
        self.controller: Optional[TPUJobController] = None
        self._build_controller()

    def attach_observatory(self, obs: JobObservatory) -> None:
        """Wire an observatory into the CURRENT controller incarnation,
        threading the harness's scrape-fault injector into its fetches.
        The injector is harness-lifetime (like the FaultingAPIServer):
        a controller restart gets a fresh process image but the network
        it scrapes through keeps its faults."""
        if self.scrape_rules and self.scrape_injector is None:
            self.scrape_injector = ScrapeFaultInjector(self.scrape_rules,
                                                       seed=self.seed)
        obs.scrape_injector = self.scrape_injector
        self.controller.observatory = obs

    # -- controller lifecycle ------------------------------------------------

    def _build_controller(self) -> None:
        self.controller = TPUJobController(self.api, config=self.config)
        # chaos timing: keep client-go backoff SEMANTICS (exponential,
        # forgettable) but compress the clock so a fault storm doesn't
        # stall the soak's wall time
        self.controller.queue = RateLimitingQueue(base_delay=0.001,
                                                  max_delay=0.05)
        try:
            self.controller.factory.start_all()
        except ApiError:
            # injected transient on the initial list: the informer cache
            # starts empty/partial; the next resync() re-lists
            pass
        self.resync()

    def kill_controller(self) -> None:
        """The process died: its watch connections, informer caches, and
        workqueue die with it. A fresh incarnation re-lists and resyncs."""
        self.controller_restarts += 1
        self.inner.drop_watchers()
        self._build_controller()

    def resync(self) -> None:
        """Periodic resync (client-go resyncPeriod): full re-list of every
        informer cache — the recovery path for dropped watch events —
        then re-enqueue every live job."""
        try:
            self.controller.factory.start_all()
        except ApiError:
            pass
        for job in self.inner.list(api.KIND):
            self.controller.enqueue_tpu_job(job)

    # -- drive loop ----------------------------------------------------------

    def drive(self, max_items: int = 2000) -> None:
        """Process queued work until quiescent (empty queue, nothing
        waiting), surviving injected crashes by rebuilding the controller.
        Bounded so a pathological requeue storm terminates the call; the
        caller's drive_until applies the real convergence deadline."""
        for _ in range(max_items):
            if self.crash_every_write:
                self.api.arm_crash(after_writes=1)
            try:
                processed = self.controller.process_next_work_item(
                    timeout=0.02)
            except ControllerCrash:
                self.kill_controller()
                continue
            if not processed and len(self.controller.queue) == 0:
                break
        self.api.disarm_crash()

    def drive_until(self, predicate: Callable[[], bool], desc: str,
                    rounds: int = 60) -> None:
        """Drive + resync until `predicate` holds; every failure names the
        reproducer seed."""
        for i in range(rounds):
            self.drive()
            if predicate():
                return
            # resync heals dropped watch events (re-list) and re-enqueues;
            # without it a dropped event could stall the predicate forever
            self.resync()
        raise ConvergenceError(f"did not converge: {desc}", self.seed)

    # -- user actions (writes go through the INNER server: the user's
    #    kubectl is not the controller's faulted client) ----------------------

    def create_job(self, name: str, tpus: int = 8, **spec_kw) -> TPUJob:
        job = TPUJob(
            metadata=ObjectMeta(name=name, namespace=self.ns),
            spec=TPUJobSpec(
                tpus=tpus,
                template=PodTemplateSpec(containers=[
                    Container(name="train", image="tpu-bench:latest")]),
                **spec_kw,
            ),
        )
        return self.inner.create(job)

    def create_gpu_job(self, name: str, processing_units: int = 16,
                       **spec_kw) -> TPUJob:
        """A GPU job as a user of the port submits it: processingUnits
        cards, the per-worker count and resource type left to the
        operator's defaults (nvidia.com/gpu, 8 a worker)."""
        job = TPUJob(
            metadata=ObjectMeta(name=name, namespace=self.ns),
            spec=TPUJobSpec(
                processing_units=processing_units,
                template=PodTemplateSpec(containers=[
                    Container(name="train",
                              image="tpu-bench-torch:latest")]),
                **spec_kw,
            ),
        )
        return self.inner.create(job)

    def edit_spec(self, name: str, **changes) -> TPUJob:
        job = self.inner.get(api.KIND, self.ns, name)
        for field_name, value in changes.items():
            setattr(job.spec, field_name, value)
        return self.inner.update(job)

    # -- cluster simulation (kubelet / batch-Job controller) -----------------

    def worker_sets(self, name: str) -> List:
        uid = self.inner.get(api.KIND, self.ns, name).metadata.uid
        return [
            s for s in self.inner.list("StatefulSet", namespace=self.ns)
            if any(r.controller and r.uid == uid
                   for r in s.metadata.owner_references)
        ]

    def make_workers_ready(self, name: str) -> None:
        for sts in self.worker_sets(name):
            sts.status.ready_replicas = sts.spec.replicas
            sts.status.replicas = sts.spec.replicas
            self.inner.update(sts)

    def launcher(self, name: str):
        return self.inner.try_get("Job", self.ns, name + LAUNCHER_SUFFIX)

    def set_launcher_active(self, name: str) -> None:
        launcher = self.inner.get("Job", self.ns, name + LAUNCHER_SUFFIX)
        launcher.status.active = 1
        self.inner.update(launcher)

    def finish_launcher(self, name: str, exit_code: int = 0) -> None:
        launcher = self.inner.get("Job", self.ns, name + LAUNCHER_SUFFIX)
        launcher.status.active = 0
        if exit_code == 0:
            launcher.status.succeeded = 1
        else:
            launcher.status.failed = 1
            launcher.status.exit_code = exit_code
        self.inner.update(launcher)

    # -- observation ---------------------------------------------------------

    def job(self, name: str) -> TPUJob:
        return self.inner.get(api.KIND, self.ns, name)

    def cond(self, name: str, cond_type: str) -> Optional[str]:
        cond = self.job(name).status.get_condition(cond_type)
        return None if cond is None else cond.status

    def owned(self, uid: str) -> List[Tuple[str, str]]:
        """Every live object whose controller ownerReference is `uid` —
        the resource set the oracle compares and teardown must empty."""
        out = []
        for kind in OWNED_KINDS:
            for obj in self.inner.list(kind, namespace=self.ns):
                if any(r.controller and r.uid == uid
                       for r in obj.metadata.owner_references):
                    out.append((kind, obj.metadata.name))
        return sorted(out)

    def snapshot_job(self, name: str) -> Dict:
        """The oracle-comparable fingerprint of a converged job; `limits`
        (each worker set's container limits) holds a GPU lifecycle to
        nvidia.com/gpu workers."""
        job = self.job(name)
        return {
            "conditions": {c.type: (c.status, c.reason)
                           for c in job.status.conditions},
            "restart_count": job.status.restart_count,
            "resources": self.owned(job.metadata.uid),
            "limits": sorted(
                sorted(s.spec.template.main_container().limits.items())
                for s in self.worker_sets(name)),
        }

    def queue_wedged(self) -> Dict:
        """Nonempty fields here after convergence = a wedged key: stuck
        in-flight, or permanently rate-limited with no forget."""
        snap = self.controller.queue.snapshot()
        return {k: v for k, v in snap.items() if v and k != "dirty"}

    def teardown(self, name: str) -> List[Tuple[str, str]]:
        """User deletes the job; cluster GC cascades; controller observes.
        Returns whatever is STILL owned by the dead uid afterwards — the
        leak set, [] on a clean teardown. A second GC pass runs after the
        controller quiesces: a sync replaying against a stale cache may
        legitimately recreate a dependent for a moment (real GC reaps
        those orphans the same way), but nothing may survive the final
        pass + resync."""
        uid = self.job(name).metadata.uid
        self.inner.delete(api.KIND, self.ns, name)
        self.inner.cascade_delete(uid)
        self.drive()
        self.resync()
        self.drive()
        self.inner.cascade_delete(uid)
        self.resync()
        self.drive()
        return self.owned(uid)


# ---------------------------------------------------------------------------
# lifecycle scenarios — each drives ONE job (or pack pair) birth-to-teardown
# and returns {job_name: snapshot} for oracle comparison. Identical code
# runs against the chaos harness and the pristine oracle harness.
# ---------------------------------------------------------------------------

def _run_to_running(h: ChaosHarness, name: str) -> None:
    h.drive_until(lambda: h.worker_sets(name), f"{name}: worker sts")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None, f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, COND_RUNNING) == "True",
                  f"{name}: Running")


def _finish_and_snapshot(h: ChaosHarness, name: str) -> Dict:
    h.finish_launcher(name)
    h.drive_until(lambda: h.cond(name, COND_SUCCEEDED) == "True",
                  f"{name}: Succeeded")
    snap = h.snapshot_job(name)
    snap["leaked"] = h.teardown(name)
    return snap


def scenario_train(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_job(name)
    _run_to_running(h, name)
    return {name: _finish_and_snapshot(h, name)}


def scenario_restart(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_job(name, restart_policy="OnFailure")
    _run_to_running(h, name)
    h.finish_launcher(name, exit_code=137)      # the gang dies

    def restarted() -> bool:
        launcher = h.launcher(name)
        return (h.job(name).status.restart_count >= 1
                and launcher is not None and not launcher.failed())

    h.drive_until(restarted, f"{name}: gang restart")
    h.set_launcher_active(name)
    return {name: _finish_and_snapshot(h, name)}


def scenario_train_gpu(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_gpu_job(name)
    _run_to_running(h, name)
    return {name: _finish_and_snapshot(h, name)}


def scenario_restart_gpu(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_gpu_job(name, restart_policy="OnFailure")
    _run_to_running(h, name)
    h.finish_launcher(name, exit_code=137)      # the gang dies

    def restarted() -> bool:
        launcher = h.launcher(name)
        return (h.job(name).status.restart_count >= 1
                and launcher is not None and not launcher.failed())

    h.drive_until(restarted, f"{name}: gang restart")
    h.set_launcher_active(name)
    return {name: _finish_and_snapshot(h, name)}


def scenario_resize(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_job(name, tpus=8)                   # 2 workers
    _run_to_running(h, name)
    h.edit_spec(name, resize=4)                  # -> 1 worker

    def resized() -> bool:
        sets = h.worker_sets(name)
        return bool(sets) and all(s.spec.replicas == 1 for s in sets)

    h.drive_until(resized, f"{name}: resize to 1 worker")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None,
                  f"{name}: post-resize launcher")
    h.set_launcher_active(name)
    return {name: _finish_and_snapshot(h, name)}


def scenario_pack(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    first, second = name + "-a", name + "-b"
    group = name + "-grp"
    h.create_job(first, pack_group=group)
    h.create_job(second, pack_group=group)
    h.drive_until(
        lambda: (h.cond(first, COND_PACKED) == "True"
                 and h.cond(second, COND_PACKED) == "True"),
        f"{name}: pack membership")
    leaders = [n for n in (first, second)
               if h.job(n).status.get_condition(COND_PACKED).reason
               == "PackLeader"]
    if len(leaders) != 1:
        raise ConvergenceError(f"{name}: expected one pack leader, "
                               f"got {leaders}", h.seed)
    leader = leaders[0]
    member = second if leader == first else first
    _run_to_running(h, leader)
    out = {leader: _finish_and_snapshot(h, leader)}
    member_snap = h.snapshot_job(member)
    member_snap["leaked"] = h.teardown(member)
    out[member] = member_snap
    return out


def scenario_serving(h: ChaosHarness, name: str) -> Dict[str, Dict]:
    h.create_job(name, tpus=8,
                 serving=ServingSpec(prefill_replicas=1, decode_replicas=1))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    _run_to_running(h, name)
    return {name: _finish_and_snapshot(h, name)}


SCENARIOS: Dict[str, Callable[[ChaosHarness, str], Dict[str, Dict]]] = {
    "train": scenario_train,
    "restart": scenario_restart,
    "resize": scenario_resize,
    "pack": scenario_pack,
    "serving": scenario_serving,
    "train-gpu": scenario_train_gpu,
    "restart-gpu": scenario_restart_gpu,
}


# ---------------------------------------------------------------------------
# oracle comparison + soak
# ---------------------------------------------------------------------------

def oracle_snapshots(kind: str, name: str) -> Dict[str, Dict]:
    """The uninterrupted run: same scenario, healthy server, no crashes."""
    return SCENARIOS[kind](ChaosHarness(), name)


def _normalize(snaps: Dict[str, Dict], prefix: str) -> Dict:
    """Strip the per-lifecycle name prefix so chaos and oracle runs with
    different job names compare equal."""
    out = {}
    for job_name, snap in snaps.items():
        out[job_name.replace(prefix, "<job>", 1)] = {
            **snap,
            "resources": [(k, n.replace(prefix, "<job>", 1))
                          for k, n in snap["resources"]],
        }
    return out


def soak(seed: int = 0, lifecycles: int = 25,
         rules: Sequence = DEFAULT_RULES,
         crash_every_write: bool = True,
         kinds: Sequence[str] = LIFECYCLES) -> Dict:
    """Drive `lifecycles` mixed job lifecycles (cycling through `kinds`)
    under the full fault + crash schedule; every lifecycle must match
    its oracle, leak nothing, and leave no wedged workqueue key. Returns
    the soak report; raises ConvergenceError (with the reproducer seed)
    on any violation."""
    chaos = ChaosHarness(rules=rules, seed=seed,
                         crash_every_write=crash_every_write)
    oracles: Dict[str, Dict] = {}
    completed = []
    for i in range(lifecycles):
        kind = kinds[i % len(kinds)]
        name = f"soak{i}-{kind}"
        snaps = SCENARIOS[kind](chaos, name)
        got = _normalize(snaps, name)
        if kind not in oracles:
            oracles[kind] = _normalize(
                oracle_snapshots(kind, f"oracle-{kind}"), f"oracle-{kind}")
        want = oracles[kind]
        if got != want:
            raise ConvergenceError(
                f"lifecycle {i} ({kind}) diverged from oracle:\n"
                f"  chaos:  {json.dumps(got, sort_keys=True)}\n"
                f"  oracle: {json.dumps(want, sort_keys=True)}", seed)
        leaked = {n: s["leaked"] for n, s in snaps.items() if s["leaked"]}
        if leaked:
            raise ConvergenceError(
                f"lifecycle {i} ({kind}) leaked resources: {leaked}", seed)
        wedged = chaos.queue_wedged()
        if wedged:
            raise ConvergenceError(
                f"lifecycle {i} ({kind}) left wedged workqueue keys: "
                f"{wedged}", seed)
        completed.append(name)
    faults = {f"{verb}:{error}": n
              for (verb, error), n in sorted(chaos.api.faults_injected.items())}
    return {
        "seed": seed,
        "lifecycles": lifecycles,
        "completed": len(completed),
        "faults_injected": faults,
        "total_faults": chaos.api.fault_count(),
        "crashes": chaos.api.crashes,
        "controller_restarts": chaos.controller_restarts,
        "writes": chaos.api.writes,
    }


# ---------------------------------------------------------------------------
# data-plane soak: scrape faults, the serving progress lease, request
# timeouts. These legs are NOT oracle-diffed — their whole point is
# conditions (DegradedGang) the healthy universe never grows — so each
# asserts its contract explicitly and raises ConvergenceError (with the
# reproducer seed) on violation.
# ---------------------------------------------------------------------------

def _observed_harness(seed: int, fetch: Callable[[str], str],
                      scrape_faults: Sequence = (),
                      serving_rate_floor: Optional[float] = None,
                      config: Optional[ControllerConfig] = None):
    """A harness + fake-clock observatory wired for data-plane legs:
    scrapes go through `fetch` (and the harness's injector, when rules
    are given), time is the returned clock dict — no wall-clock
    dependence, so a (seed, rules) pair replays exactly."""
    h = ChaosHarness(config=config or ControllerConfig(
                         worker_metrics_port=9100),
                     seed=seed, scrape_faults=scrape_faults)
    clock = {"now": 1000.0}
    obs = JobObservatory(events_dir=tempfile.mkdtemp(prefix="dp-chaos-"),
                         clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0,
                         serving_rate_floor=serving_rate_floor)
    h.attach_observatory(obs)
    return h, obs, clock


def data_plane_degraded(seed: int = 0,
                        scrape_faults: Sequence = DEFAULT_SCRAPE_RULES,
                        ) -> Dict:
    """Partial partition under pure scrape flakiness: rank 0 dark for
    two deadline-widths of wall clock while rank 1's step frontier keeps
    advancing. The gang must be marked DegradedGang — and NEVER
    restarted or declared stuck — then heal to PartitionHealed the
    moment every rank scrapes again."""
    step = {"v": 5}

    def fetch(url):
        if url.endswith("/metrics"):
            return f"tpu_worker_step {step['v']}\n"
        raise IOError("no events endpoint in this universe")

    h, obs, clock = _observed_harness(seed, fetch,
                                      scrape_faults=scrape_faults)
    name = "dp-degraded"
    h.create_job(name, restart_policy="OnFailure",
                 progress_deadline_seconds=60)
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    sync()
    h.resync()
    h.make_workers_ready(name)
    sync()
    h.resync()
    h.set_launcher_active(name)
    h.resync()
    sync()
    h.resync()
    saw_degraded = False
    for _ in range(12):                     # 120s > 2x the 60s deadline
        clock["now"] += 10
        step["v"] += 1
        sync()
        h.resync()
        job = h.job(name)
        cond = job.status.get_condition(api.COND_DEGRADED_GANG)
        saw_degraded = saw_degraded or (cond is not None
                                        and cond.status == "True")
        if job.status.restart_count:
            raise ConvergenceError(
                "degraded leg: scrape flakiness alone restarted the gang "
                "(a false-positive stuck verdict)", seed)
        stuck = job.status.get_condition(api.COND_STUCK)
        if stuck is not None and stuck.status == "True":
            raise ConvergenceError(
                "degraded leg: partially observable gang declared stuck "
                "while its frontier was advancing", seed)
    if not saw_degraded:
        raise ConvergenceError(
            "degraded leg: rank 0 dark for 120s never produced a "
            "DegradedGang condition", seed)
    faults = h.scrape_injector.fault_count() if h.scrape_injector else 0
    # heal: the partition lifts; the condition must retire, not linger
    obs.scrape_injector = None
    clock["now"] += 10
    step["v"] += 1
    sync()
    h.resync()
    cond = h.job(name).status.get_condition(api.COND_DEGRADED_GANG)
    if cond is None or cond.status != "False" \
            or cond.reason != "PartitionHealed":
        raise ConvergenceError(
            f"degraded leg: heal did not retire the condition (got "
            f"{cond and (cond.status, cond.reason)})", seed)
    degraded = [r for r in obs.merged_records(name)
                if r["event"] == "gang_degraded"]
    opened = [r for r in degraded if not r.get("healed")]
    healed = [r for r in degraded if r.get("healed")]
    if not opened or len(healed) != 1:
        raise ConvergenceError(
            f"degraded leg: expected one closed degraded window in the "
            f"timeline, got {len(opened)} open / {len(healed)} healed",
            seed)
    return {
        "degraded_windows": len(healed),
        "scrape_faults_injected": faults,
        "false_positive_restarts": h.job(name).status.restart_count,
    }


def data_plane_serving_lease(seed: int = 0) -> Dict:
    """The serving progress lease end to end: a Running serving gang
    whose retired-request/token frontier advances is left alone for two
    deadline-widths; the moment the frontier freezes it is declared
    stuck — via the token counters, within progressDeadlineSeconds —
    and restarted through the ordinary restart-policy path."""
    frontier = {"requests": 0, "tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total {frontier['requests']}\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint in this universe")

    h, obs, clock = _observed_harness(seed, fetch)
    name = "dp-serving"
    deadline = 60
    h.create_job(name, tpus=8, restart_policy="OnFailure",
                 progress_deadline_seconds=deadline,
                 serving=ServingSpec(prefill_replicas=1, decode_replicas=1))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None, f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, COND_RUNNING) == "True",
                  f"{name}: Running")
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    for _ in range(8):                      # 120s of live traffic
        clock["now"] += 15
        frontier["requests"] += 2
        frontier["tokens"] += 40
        sync()
        h.resync()
    job = h.job(name)
    if job.status.restart_count or \
            job.status.get_condition(api.COND_STUCK) is not None:
        raise ConvergenceError(
            "serving leg: an advancing token frontier tripped the "
            "progress lease", seed)
    # the engine wedges: requests stop retiring, the frontier freezes
    clock["now"] += deadline + 10
    sync()
    h.resync()
    job = h.job(name)
    stuck = job.status.get_condition(api.COND_STUCK)
    if stuck is None or stuck.status != "True":
        raise ConvergenceError(
            "serving leg: frozen token frontier not declared stuck "
            "within progressDeadlineSeconds", seed)
    if job.status.restart_count != 1:
        raise ConvergenceError(
            f"serving leg: expected exactly one restart of the wedged "
            f"gang, got {job.status.restart_count}", seed)
    stuck_recs = [r for r in obs.merged_records(name)
                  if r["event"] == "gang_stuck"]
    if not stuck_recs:
        raise ConvergenceError(
            "serving leg: stuck verdict left no gang_stuck timeline "
            "record", seed)
    return {"serving_stalls_detected": len(stuck_recs),
            "serving_false_positives": 0}


def data_plane_tpot_slope(seed: int = 0) -> Dict:
    """The TPOT-slope upgrade of the serving lease: an engine whose
    token frontier still CREEPS (a couple of tokens per scrape — the
    wall-clock lease alone would renew forever, one token at a time)
    but whose rate collapsed below the floor must go stuck within the
    ordinary progressDeadlineSeconds and restart exactly once; healthy-
    rate traffic first must not trip anything."""
    frontier = {"requests": 0, "tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total {frontier['requests']}\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint in this universe")

    # floor: 1 observed token/sec. Healthy traffic below runs ~2.8/s;
    # the degraded phase creeps at ~0.13/s — above and below with a
    # decade of margin, so scrape-cadence jitter cannot flip the verdict
    h, obs, clock = _observed_harness(seed, fetch, serving_rate_floor=1.0)
    name = "dp-tpot-slope"
    deadline = 60
    h.create_job(name, tpus=8, restart_policy="OnFailure",
                 progress_deadline_seconds=deadline,
                 serving=ServingSpec(prefill_replicas=1, decode_replicas=1))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None, f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, COND_RUNNING) == "True",
                  f"{name}: Running")
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    for _ in range(8):                      # 120s of healthy-rate traffic
        clock["now"] += 15
        frontier["requests"] += 2
        frontier["tokens"] += 40
        sync()
        h.resync()
    job = h.job(name)
    if job.status.restart_count or \
            job.status.get_condition(api.COND_STUCK) is not None:
        raise ConvergenceError(
            "tpot-slope leg: healthy-rate traffic tripped the slope "
            "check (false positive)", seed)
    # the engine degrades: the frontier keeps creeping — every scrape
    # still advances it, so the WALL-CLOCK lease alone would renew
    # forever — but far below the rate floor
    for _ in range(10):                     # 150s >> the 60s deadline
        clock["now"] += 15
        frontier["tokens"] += 2
        sync()
        h.resync()
        if h.job(name).status.restart_count:
            break
    job = h.job(name)
    stuck = job.status.get_condition(api.COND_STUCK)
    if stuck is None or stuck.status != "True":
        raise ConvergenceError(
            "tpot-slope leg: creeping-but-collapsed token frontier "
            "never declared stuck (the wall-clock lease renewed on a "
            "trickle)", seed)
    if job.status.restart_count != 1:
        raise ConvergenceError(
            f"tpot-slope leg: expected exactly one restart of the "
            f"degraded gang, got {job.status.restart_count}", seed)
    stuck_recs = [r for r in obs.merged_records(name)
                  if r["event"] == "gang_stuck"]
    if not stuck_recs:
        raise ConvergenceError(
            "tpot-slope leg: stuck verdict left no gang_stuck timeline "
            "record", seed)
    return {"tpot_slope_stalls_detected": len(stuck_recs),
            "tpot_slope_false_positives": 0}


def _test_lm(seed: int, device: str):
    """The engine legs' model: the port's gpt2-test CausalLM (f32, vocab
    64, max_len 64, dense attention, as the reference's legs) with
    weights drawn from a torch.Generator seeded with `seed` on
    `device` (create_lm)."""
    import torch

    from ..models import create_lm

    return create_lm("gpt2-test", device=device, seed=seed,
                     dtype=torch.float32, vocab_size=64, max_len=64,
                     attention="dense")


def data_plane_request_timeouts(seed: int = 0,
                                device: str = "cuda") -> Dict:
    """Engine-side lease enforcement: every request admitted with an
    already-expired deadline (request_timeout=0, the degenerate worst
    case) must retire with finish_reason "timeout" leaking NO slots and
    NO KV pages — and the engine must still serve afterwards. Imports
    torch lazily so the control-plane soak stays light; runs on
    `device` (the CUDA card by default; raises without one)."""
    from ..serve import EngineConfig, Request, ServingEngine

    model = _test_lm(seed, device)
    engine = ServingEngine(model, EngineConfig(
        slots=2, chunk_buckets=(4, 8), paged=True, page_size=8,
        rng_seed=seed, request_timeout=0.0), device=device)
    reqs = [Request(i, [1 + (i % 5)] * 6, 16) for i in range(5)]
    results = engine.run(reqs)
    timeouts = sum(1 for r in results.values()
                   if r.finish_reason == "timeout")
    if timeouts != len(reqs):
        raise ConvergenceError(
            f"timeout leg: {len(reqs)} expired requests, only {timeouts} "
            f"retired as timeouts", seed)
    engine.page_allocator.check()           # raises on refcount damage
    leaked_pages = engine.page_allocator.in_use
    leaked_slots = engine.config.slots - len(engine.slots.free)
    if leaked_pages or leaked_slots:
        raise ConvergenceError(
            f"timeout leg: leaked {leaked_pages} pages / {leaked_slots} "
            f"slots after request timeouts", seed)
    # lift the timeout: the same engine (same slots, same pool) must
    # complete a fresh request normally — the reclaim was real
    engine.config.request_timeout = None
    after = engine.run([Request(99, [2, 3, 4, 5], 4)])
    if after[99].finish_reason not in ("eos", "length"):
        raise ConvergenceError(
            f"timeout leg: post-timeout request finished "
            f"{after[99].finish_reason!r}, engine did not recover", seed)
    return {"request_timeouts": timeouts,
            "leaked_pages": leaked_pages,
            "leaked_slots": leaked_slots}


def data_plane_scrape_bursts(seed: int = 0) -> Dict:
    """Time-varying scrape faults vs the serving progress lease: a
    Running serving gang with a healthy token frontier rides an
    oscillating fault schedule (`*/fail=1.0:burst:6/0.3` — total scrape
    blackout for 2 fetches out of every 6, per rank). Every storm is
    shorter than progressDeadlineSeconds, so across many bursts the
    lease must neither trip (zero false-positive restarts, no stuck
    verdict) nor disarm: after the storms, a genuinely frozen frontier
    must still be declared stuck within one deadline — the re-arm path
    worked every calm window."""
    frontier = {"requests": 0, "tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total {frontier['requests']}\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint in this universe")

    # rate 1.0 inside the burst window makes the storm schedule exact:
    # 2 dark fetches (30s of clock) then 4 clean, per rank, repeating
    h, obs, clock = _observed_harness(
        seed, fetch, scrape_faults=("*/fail=1.0:burst:6/0.3",))
    name = "dp-bursts"
    deadline = 60
    h.create_job(name, tpus=8, restart_policy="OnFailure",
                 progress_deadline_seconds=deadline,
                 serving=ServingSpec(prefill_replicas=1, decode_replicas=1))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None, f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, COND_RUNNING) == "True",
                  f"{name}: Running")
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    for _ in range(24):                     # 360s: ~4 full burst periods
        clock["now"] += 15
        frontier["requests"] += 2
        frontier["tokens"] += 40
        sync()
        h.resync()
        job = h.job(name)
        if job.status.restart_count:
            raise ConvergenceError(
                "burst leg: oscillating scrape faults over a live "
                "frontier restarted the gang (false positive)", seed)
        stuck = job.status.get_condition(api.COND_STUCK)
        if stuck is not None and stuck.status == "True":
            raise ConvergenceError(
                "burst leg: live frontier declared stuck during a "
                "scrape-fault burst", seed)
    inj = h.scrape_injector
    windows = inj.burst_windows_hit() if inj else 0
    faults = inj.fault_count("fail") if inj else 0
    if windows < 2 or not faults:
        raise ConvergenceError(
            f"burst leg: fault schedule never oscillated "
            f"({faults} faults across {windows} burst windows)", seed)
    # the storms are over; now the engine genuinely wedges — the lease
    # must have re-armed through every calm window and still fire
    obs.scrape_injector = None
    clock["now"] += deadline + 10
    sync()
    h.resync()
    job = h.job(name)
    stuck = job.status.get_condition(api.COND_STUCK)
    if stuck is None or stuck.status != "True" \
            or job.status.restart_count != 1:
        raise ConvergenceError(
            "burst leg: post-burst frozen frontier not declared stuck — "
            "the bursts disarmed the lease", seed)
    return {"burst_windows_hit": windows,
            "burst_faults_injected": faults,
            "burst_false_positive_restarts": 0,
            "burst_real_stall_detected": 1}


def data_plane_router_failover(seed: int = 0,
                               device: str = "cuda") -> Dict:
    """Front-door failover: two in-process engine replicas behind the
    Router, one killed mid-trace (its tick starts raising). The router
    must mark it dead, resubmit its in-flight requests to the survivor,
    and converge with ZERO lost requests — every request's tokens
    bitwise-identical to a single-engine greedy oracle (greedy decode is
    replica-independent, so a replayed request is indistinguishable).
    Imports torch lazily like the request-timeout leg."""
    from ..serve import (EngineConfig, Request, Router, RouterConfig,
                         ServingEngine)

    model = _test_lm(seed, device)

    def mk():
        return ServingEngine(model, EngineConfig(
            slots=2, chunk_buckets=(4, 8), paged=True, page_size=8,
            rng_seed=seed), device=device)

    rng = random.Random(seed)
    reqs = [Request(i, [1 + rng.randrange(60) for _ in range(4 + i % 5)],
                    max_new_tokens=5, arrival=0.0) for i in range(6)]
    oracle = {}
    for r in reqs:
        oracle[r.id] = mk().run(
            [Request(r.id, r.prompt, r.max_new_tokens)])[r.id].tokens

    router = Router([mk(), mk()], RouterConfig(max_inflight=8))
    ticks = {"n": 0}
    victim = router.replicas[0].engine
    real_tick = victim.tick

    def dying_tick():
        ticks["n"] += 1
        if ticks["n"] > 3:
            raise IOError(f"injected: replica 0 died (seed={seed})")
        return real_tick()

    victim.tick = dying_tick
    results = router.run([Request(r.id, r.prompt, r.max_new_tokens,
                                  arrival=r.arrival) for r in reqs])
    lost = [r.id for r in reqs if r.id not in results
            or results[r.id].finish_reason == "shed"]
    if lost:
        raise ConvergenceError(
            f"router leg: requests {lost} lost in failover", seed)
    wrong = [r.id for r in reqs if results[r.id].tokens != oracle[r.id]]
    if wrong:
        raise ConvergenceError(
            f"router leg: failover replay diverged from the greedy "
            f"oracle for requests {wrong}", seed)
    if router.dead_replicas() != [0]:
        raise ConvergenceError(
            f"router leg: expected replica 0 dead, got "
            f"{router.dead_replicas()}", seed)
    if not router.resubmitted_total:
        raise ConvergenceError(
            "router leg: replica died mid-trace but nothing was "
            "resubmitted — the kill landed after the work", seed)
    return {"router_failover_lost": 0,
            "router_resubmitted": router.resubmitted_total,
            "router_dead_replicas": 1}


def data_plane_trace_complete(seed: int = 0,
                              device: str = "cuda") -> Dict:
    """Trace-completeness invariants under adversity: the router fleet
    from the failover leg, but traced (Tracer, sample=1.0) and sized so
    the front door ALSO sheds (max_inflight=2, six simultaneous
    arrivals), with replica 0 killed mid-trace. The span log must then
    satisfy, with no survivors' help:

      * every request that entered the router has EXACTLY ONE root span
        with a terminal status — ok / timeout / shed / failover — even
        the ones replayed across the replica death (the tracer's
        registry hands the replay the same open root, so dedup is by
        construction, and build_trees double-checks by (trace, span));
      * zero orphan spans: the killed replica's session span was
        abandoned, not leaked, and no hop points at a vanished root;
      * hop durations tile the root — abandon closes the open hop at
        the failover instant and the replay's queue-wait reopens there,
        so the sum-vs-root gap stays within rounding even for traces
        that crossed the dead replica.
    """
    from ..serve import (EngineConfig, Request, Router, RouterConfig,
                         ServingEngine)
    from ..telemetry.trace import (REQUEST_ROOT, Tracer, build_trees,
                                   orphan_spans, trace_sum_gap)

    model = _test_lm(seed, device)

    def mk():
        return ServingEngine(model, EngineConfig(
            slots=2, chunk_buckets=(4, 8), paged=True, page_size=8,
            rng_seed=seed), device=device)

    rng = random.Random(seed)
    reqs = [Request(i, [1 + rng.randrange(60) for _ in range(4 + i % 5)],
                    max_new_tokens=5, arrival=0.0) for i in range(6)]
    tracer = Tracer(sample=1.0)
    router = Router([mk(), mk()], RouterConfig(max_inflight=2),
                    tracer=tracer)
    ticks = {"n": 0}
    victim = router.replicas[0].engine
    real_tick = victim.tick

    def dying_tick():
        ticks["n"] += 1
        if ticks["n"] > 3:
            raise IOError(f"injected: replica 0 died (seed={seed})")
        return real_tick()

    victim.tick = dying_tick
    results = router.run([Request(r.id, r.prompt, r.max_new_tokens,
                                  arrival=r.arrival) for r in reqs])
    if not router.resubmitted_total:
        raise ConvergenceError(
            "trace leg: replica died mid-trace but nothing was "
            "resubmitted — the kill landed after the work", seed)
    if tracer.open_requests():
        raise ConvergenceError(
            f"trace leg: request traces left open after the run: "
            f"{tracer.open_requests()}", seed)
    spans = list(tracer.ring)
    trees = build_trees(spans)
    orphans = orphan_spans(spans)
    if orphans:
        raise ConvergenceError(
            f"trace leg: {len(orphans)} orphan span(s) after the "
            f"replica kill: {[s['name'] for s in orphans]}", seed)
    terminal = {"ok", "timeout", "shed", "failover"}
    shed_roots = 0
    max_gap = 0.0
    for r in reqs:
        tree = trees.get(r.id)
        root = tree["root"] if tree else None
        if root is None:
            raise ConvergenceError(
                f"trace leg: request {r.id} has no root span", seed)
        n_roots = sum(1 for s in spans
                      if s["trace"] == r.id and s["name"] == REQUEST_ROOT)
        if n_roots != 1:
            raise ConvergenceError(
                f"trace leg: request {r.id} has {n_roots} root spans "
                f"(failover replay dedup broken)", seed)
        if root["status"] not in terminal:
            raise ConvergenceError(
                f"trace leg: request {r.id} root status "
                f"{root['status']!r} is not terminal", seed)
        want = ("shed" if results[r.id].finish_reason == "shed" else "ok")
        if root["status"] != want:
            raise ConvergenceError(
                f"trace leg: request {r.id} finished "
                f"{results[r.id].finish_reason!r} but its root says "
                f"{root['status']!r}", seed)
        shed_roots += root["status"] == "shed"
        gap = trace_sum_gap(tree)
        if gap is not None and root["seconds"] > 0:
            max_gap = max(max_gap, gap)
            if gap > max(0.005, 0.02 * root["seconds"]):
                raise ConvergenceError(
                    f"trace leg: request {r.id} hops sum "
                    f"{gap:.6f}s away from its root duration "
                    f"({root['seconds']:.6f}s) — the hop chain tore",
                    seed)
    failover_roots = sum(
        1 for t in trees.values()
        if t["root"] is not None and any(
            e.get("name") == "failover"
            for e in t["root"].get("events", [])))
    if not failover_roots:
        raise ConvergenceError(
            "trace leg: resubmits happened but no root carries a "
            "failover event", seed)
    return {"trace_complete_requests": len(reqs),
            "trace_complete_orphans": 0,
            "trace_complete_shed_roots": shed_roots,
            "trace_complete_failover_roots": failover_roots,
            "trace_complete_max_gap_seconds": round(max_gap, 6)}


def data_plane_live_scale(seed: int = 0) -> Dict:
    """Live decode-pool scaling, control plane, under the nastiest
    schedule the marker protocol must survive: an SLO breach drives the
    +1 decode step and a later clear drives the -1, under ``burst:``
    scrape faults, with the controller KILLED at the scalingReplica
    marker BOTH times — the marker status write has landed but the
    StatefulSet update it guards has not. The replay must finish each
    step as a LIVE step: decode replicas land, the launcher Job
    survives untouched (same uid), both pools keep their template
    hashes, restart_count stays 0, zero gang_resize ledger entries —
    and exactly ONE live_scale record lands per marker token (the
    note_live_scale dedupe: no double-attach on replay)."""
    qd = {"v": 0.0}

    def fetch(url):
        if url.endswith("/metrics"):
            return f"tpu_worker_queue_depth {qd['v']}\n"
        raise IOError("no events endpoint in this universe")

    # rank 0 always scrapes (the breach signal must persist through the
    # storm); rank 1 goes hard-dark in bursts
    h, obs, clock = _observed_harness(
        seed, fetch, scrape_faults=("1/fail=1:burst:4/0.5",))
    pin = lambda: setattr(h.controller, "now",  # noqa: E731
                          lambda: clock["now"])
    pin()
    name = "dp-live-scale"
    h.create_job(name, tpus=8, serving=ServingSpec(
        prefill_replicas=1, decode_replicas=1,
        slo=ServingSLO(queue_depth=4.0, breach_seconds=30.0,
                       clear_seconds=30.0, cooldown_floor_seconds=0.0,
                       max_decode_replicas=4)))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None,
                  f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, "Running") == "True",
                  f"{name}: Running")
    launcher_uid = h.launcher(name).metadata.uid
    hashes_before = {
        s.metadata.name: s.metadata.annotations[ANNOTATION_TEMPLATE_HASH]
        for s in h.worker_sets(name)}

    # kill the controller the instant it issues the decode StatefulSet
    # update the marker guards (the marker write itself has landed)
    crash = {"arm_replicas": None, "count": 0}
    orig_update = h.api.update

    def update_with_marker_crash(obj, **kw):
        if (getattr(obj, "kind", None) == "StatefulSet"
                and obj.metadata.name.endswith("-decode")
                and crash["arm_replicas"] is not None
                and obj.spec.replicas == crash["arm_replicas"]):
            crash["arm_replicas"] = None
            crash["count"] += 1
            raise ControllerCrash(
                f"injected: died at the scalingReplica marker "
                f"(seed={seed})")
        return orig_update(obj, **kw)

    h.api.update = update_with_marker_crash

    def sync_surviving_crash():
        try:
            h.controller.sync_handler(f"{h.ns}/{name}")
        except ControllerCrash:
            h.kill_controller()
            h.attach_observatory(obs)
            pin()
        h.resync()

    def decode_sts():
        return next(s for s in h.worker_sets(name)
                    if s.metadata.name.endswith("-decode"))

    def step_to(replicas: int, label: str) -> None:
        crash["arm_replicas"] = replicas
        for _ in range(10):
            clock["now"] += 15
            sync_surviving_crash()
            # the resized pool's pods come up (or go away) out-of-band;
            # scrapes only track a ready fleet
            h.make_workers_ready(name)
            job = h.job(name)
            if (decode_sts().spec.replicas == replicas
                    and job.status.scaling_replica is None):
                return
        raise ConvergenceError(
            f"live-scale leg: decode pool never reached {replicas} "
            f"replicas with a clean marker ({label})", seed)

    qd["v"] = 9.0                       # breach: queue_depth 9 > 4
    step_to(2, "scale-out")
    qd["v"] = 0.0                       # clear: back inside SLO
    step_to(1, "scale-in")

    if crash["count"] != 2:
        raise ConvergenceError(
            f"live-scale leg: expected a marker crash per step, got "
            f"{crash['count']}", seed)
    job = h.job(name)
    if job.status.restart_count:
        raise ConvergenceError(
            "live-scale leg: a live scale step counted a gang restart",
            seed)
    if h.launcher(name).metadata.uid != launcher_uid:
        raise ConvergenceError(
            "live-scale leg: the launcher Job was recreated — a live "
            "step cold-restarted the fleet", seed)
    hashes_after = {
        s.metadata.name: s.metadata.annotations[ANNOTATION_TEMPLATE_HASH]
        for s in h.worker_sets(name)}
    if hashes_after != hashes_before:
        raise ConvergenceError(
            f"live-scale leg: template hashes drifted across a "
            f"replica-count-only step ({hashes_before} -> "
            f"{hashes_after})", seed)
    records = [r for r in obs.merged_records(name)
               if r["event"] == tev.LIVE_SCALE]
    tokens = [r.get("token") for r in records]
    if len(records) != 2 or len(set(tokens)) != 2:
        raise ConvergenceError(
            f"live-scale leg: expected one deduped live_scale record "
            f"per step, got tokens {tokens} (double-attach on replay?)",
            seed)
    ledger = resize_ledger(obs.merged_records(name))
    gang = [r for r in ledger if r.get("kind") != tev.LIVE_SCALE]
    if gang:
        raise ConvergenceError(
            f"live-scale leg: {len(gang)} gang_resize ledger entries "
            f"from autoscaler-driven steps", seed)
    faults = h.scrape_injector.fault_count() if h.scrape_injector else 0
    if not faults:
        raise ConvergenceError(
            "live-scale leg: the burst schedule never injected — the "
            "storm was not exercised", seed)
    return {
        "live_scale_out_replicas": 2,
        "live_scale_in_replicas": decode_sts().spec.replicas,
        "live_scale_ledger_records": len(records),
        "live_scale_double_records": len(records) - len(set(tokens)),
        "live_scale_gang_entries": len(gang),
        "live_scale_marker_crashes": crash["count"],
        "live_scale_burst_faults": faults,
    }


def data_plane_live_scale_engines(seed: int = 0,
                                  device: str = "cuda") -> Dict:
    """Live decode-pool scaling, data plane: a real-engine router runs
    a trace through BOTH live steps — a pre-warmed attach (+1, warmed
    out-of-band so the pin never lands on the trace clock) and a
    graceful detach (-1, queued requests failed over to survivors,
    residents finishing in place, pages/slots verified reclaimed).
    Gates: zero lost, zero shed, every request's tokens
    bitwise-identical to the single-engine greedy oracle, zero leaked
    pages. Imports torch lazily like the router-failover leg."""
    from ..serve import (EngineConfig, Request, Router, RouterConfig,
                         ServingEngine)

    model = _test_lm(seed, device)

    def mk():
        return ServingEngine(model, EngineConfig(
            slots=2, chunk_buckets=(4, 8), paged=True, page_size=8,
            rng_seed=seed), device=device)

    rng = random.Random(seed)
    reqs = [Request(i, [1 + rng.randrange(60) for _ in range(4 + i % 5)],
                    max_new_tokens=5, arrival=0.002 * i)
            for i in range(8)]
    oracle = {}
    for r in reqs:
        oracle[r.id] = mk().run(
            [Request(r.id, r.prompt, r.max_new_tokens)])[r.id].tokens

    # the +1 engine is built AND warmed out-of-band — that is live
    # scaling's whole point; only the measured warmup cost rides along
    newcomer = mk()
    warm_t0 = time.perf_counter()
    newcomer.run([Request(10_000, [1, 2, 3, 4], max_new_tokens=2)])
    warmup = time.perf_counter() - warm_t0

    router = Router([mk(), mk()], RouterConfig(max_inflight=8))
    router.schedule_attach(0.004, newcomer, warmup_seconds=warmup)
    router.schedule_detach(0.01, 0)
    results = router.run([Request(r.id, r.prompt, r.max_new_tokens,
                                  arrival=r.arrival) for r in reqs])
    lost = [r.id for r in reqs if r.id not in results
            or results[r.id].finish_reason == "shed"]
    if lost:
        raise ConvergenceError(
            f"live-scale engine leg: requests {lost} lost across the "
            f"scale steps", seed)
    wrong = [r.id for r in reqs if results[r.id].tokens != oracle[r.id]]
    if wrong:
        raise ConvergenceError(
            f"live-scale engine leg: tokens diverged from the greedy "
            f"oracle for requests {wrong}", seed)
    if router.detached_replicas() != [0] or router.dead_replicas():
        raise ConvergenceError(
            f"live-scale engine leg: expected a clean detach of replica "
            f"0, got detached={router.detached_replicas()} "
            f"dead={router.dead_replicas()}", seed)
    actions = [e["action"] for e in router.live_scale_log]
    if actions != ["attach", "detach"]:
        raise ConvergenceError(
            f"live-scale engine leg: expected [attach, detach] steps, "
            f"got {actions}", seed)
    leaked = 0
    for rep in router.replicas:
        alloc = rep.engine.page_allocator
        alloc.check()
        leaked += alloc.in_use
    if leaked:
        raise ConvergenceError(
            f"live-scale engine leg: {leaked} KV pages still pinned "
            f"after the trace", seed)
    return {"live_scale_lost": 0,
            "live_scale_shed": router.shed_count(),
            "live_scale_token_mismatches": 0,
            "live_scale_leaked_pages": leaked,
            "live_scale_attaches": 1,
            "live_scale_detaches": 1}


def data_plane_soak(seed: int = 0,
                    scrape_faults: Sequence = DEFAULT_SCRAPE_RULES,
                    engine_leg: bool = True,
                    device: str = "cuda") -> Dict:
    """All data-plane legs; one merged report. `engine_leg=False` skips
    the torch-importing request-timeout, router-failover, trace and
    live-scale engine legs (unit tests cover them in-process; the
    out-of-process soak runs everything); `device` is where those legs'
    engines run."""
    report: Dict = {}
    report.update(data_plane_degraded(seed, scrape_faults))
    report.update(data_plane_serving_lease(seed))
    report.update(data_plane_tpot_slope(seed))
    report.update(data_plane_scrape_bursts(seed))
    report.update(data_plane_live_scale(seed))
    if engine_leg:
        report.update(data_plane_request_timeouts(seed, device))
        report.update(data_plane_router_failover(seed, device))
        report.update(data_plane_trace_complete(seed, device))
        report.update(data_plane_live_scale_engines(seed, device))
    return report


# ---------------------------------------------------------------------------
# scheduler soak: fleet-scheduler lifecycles (preempt-to-admit, grow-back,
# anti-thrash refusal, degraded-rank migration) under the same fault +
# crash-at-every-write schedule. Like the data-plane legs these are not
# oracle-diffed — the queue/preempt conditions only exist in a contended
# universe — so each asserts its contract explicitly.
# ---------------------------------------------------------------------------

def scheduler_rebalance(seed: int = 0, rules: Sequence = DEFAULT_RULES,
                        crash_every_write: bool = True) -> Dict:
    """The full preempt-to-admit / grow-back lifecycle with the
    controller killed at every write boundary: a priority-1 job lands on
    a full pool, the priority-0 elastic gang shrinks 8 -> 4 chips
    through the ordinary drain/resize protocol (never a counted
    restart), the high-priority job runs to completion, and the victim
    grows back to its entitlement — zero double-shrinks, zero lost
    admissions, zero leaks, zero wedged keys. The cooldown floor is 0
    here: controller kills replace the clock-bearing process, so the
    hysteresis brake is exercised by scheduler_thrash instead."""
    h = ChaosHarness(rules=rules, seed=seed,
                     crash_every_write=crash_every_write,
                     config=ControllerConfig(
                         sched_pool_chips=8,
                         sched_cooldown_floor_seconds=0.0))
    h.create_job("lo", tpus=8, priority=0, elastic=True, min_tpus=2)
    _run_to_running(h, "lo")
    h.create_job("hi", tpus=4, priority=1)
    h.drive_until(
        lambda: (h.job("lo").status.sched_tpus == 4
                 and h.cond("hi", api.COND_QUEUED) == "False"),
        "scheduler: preempt-to-admit")
    if h.job("lo").status.sched_tpus != 4:
        raise ConvergenceError(
            f"scheduler leg: victim double-shrunk to "
            f"{h.job('lo').status.sched_tpus}", seed)
    if h.job("lo").status.restart_count:
        raise ConvergenceError(
            "scheduler leg: preemption burned the victim's restart "
            "budget", seed)
    h.drive_until(
        lambda: (h.worker_sets("lo")
                 and all(s.spec.replicas == 1 for s in h.worker_sets("lo"))),
        "scheduler: victim shrink materialized")
    h.make_workers_ready("lo")
    _run_to_running(h, "hi")
    h.finish_launcher("hi")
    h.drive_until(lambda: h.cond("hi", COND_SUCCEEDED) == "True",
                  "scheduler: hi Succeeded")
    h.drive_until(
        lambda: (h.job("lo").status.sched_tpus is None
                 and h.cond("lo", api.COND_PREEMPTED) == "False"),
        "scheduler: grow-back")
    h.drive_until(
        lambda: (h.worker_sets("lo")
                 and all(s.spec.replicas == 2 for s in h.worker_sets("lo"))),
        "scheduler: victim restored to entitlement")
    h.make_workers_ready("lo")
    h.drive_until(lambda: h.launcher("lo") is not None,
                  "scheduler: victim launcher recreated")
    h.set_launcher_active("lo")
    h.finish_launcher("lo")
    h.drive_until(lambda: h.cond("lo", COND_SUCCEEDED) == "True",
                  "scheduler: lo Succeeded")
    if h.job("lo").status.restart_count:
        raise ConvergenceError(
            "scheduler leg: rebalancing counted gang restarts", seed)
    for name in ("hi", "lo"):
        leaked = h.teardown(name)
        if leaked:
            raise ConvergenceError(
                f"scheduler leg: {name} leaked {leaked}", seed)
    wedged = h.queue_wedged()
    if wedged:
        raise ConvergenceError(
            f"scheduler leg: wedged workqueue keys: {wedged}", seed)
    return {
        "sched_preempts": 1,
        "sched_grow_backs": 1,
        "sched_admissions_lost": 0,
        "sched_double_shrinks": 0,
        "sched_restarts_burned": 0,
        "sched_leaked": 0,
    }


def scheduler_thrash(seed: int = 0) -> Dict:
    """The anti-thrash pin: with a cost floor far above any accrued
    queue wait, the scheduler must REFUSE to preempt — the pending job
    stays Queued, the victim keeps its chips, and the refusal is an
    explicit sched_skip timeline record carrying the predicted cost vs
    the reclaimable wait (the postmortem's evidence that the gate, not
    an accident, held the action back)."""
    h = ChaosHarness(seed=seed, config=ControllerConfig(
        sched_pool_chips=8, sched_cooldown_floor_seconds=3600.0))
    obs = JobObservatory(events_dir=tempfile.mkdtemp(prefix="sched-chaos-"),
                         scrape_interval=0.0)
    h.attach_observatory(obs)
    sync = lambda n: h.controller.sync_handler(f"{h.ns}/{n}")  # noqa: E731
    h.create_job("lo", tpus=8, priority=0, elastic=True, min_tpus=2)
    sync("lo")
    h.resync()
    h.make_workers_ready("lo")
    sync("lo")
    h.set_launcher_active("lo")
    h.resync()
    sync("lo")
    h.create_job("hi", tpus=4, priority=1)
    for _ in range(4):
        sync("hi")
        sync("lo")
    if h.job("lo").status.sched_tpus is not None:
        raise ConvergenceError(
            "thrash leg: the gate approved a preemption whose predicted "
            "cost exceeds the reclaimable queue wait", seed)
    if h.cond("hi", api.COND_QUEUED) != "True":
        raise ConvergenceError(
            "thrash leg: refused admission did not stay Queued", seed)
    skips = [r for r in obs.merged_records("hi")
             if r["event"] == "sched_skip"]
    if not skips:
        raise ConvergenceError(
            "thrash leg: refusal left no sched_skip timeline record",
            seed)
    rec = skips[-1]
    if not (rec.get("predicted_cost_seconds", 0)
            > rec.get("reclaim_seconds", 0) + 1):
        raise ConvergenceError(
            f"thrash leg: sched_skip record does not show predicted "
            f"cost above reclaimable wait: {rec}", seed)
    return {"sched_skips_recorded": len(skips),
            "sched_thrash_resizes": 0}


def scheduler_migration(seed: int = 0,
                        scrape_faults: Sequence = DEFAULT_SCRAPE_RULES,
                        ) -> Dict:
    """Degraded-rank migration: rank 0 hard-dark while rank 1's frontier
    advances. The dark pod must be migrated AT MOST ONCE per degraded
    window (the status marker survives replayed syncs) and counted as
    migration_count — NEVER as a gang restart; the advancing remainder
    must never be restarted."""
    step = {"v": 5}

    def fetch(url):
        if url.endswith("/metrics"):
            return f"tpu_worker_step {step['v']}\n"
        raise IOError("no events endpoint in this universe")

    h, obs, clock = _observed_harness(
        seed, fetch, scrape_faults=scrape_faults,
        config=ControllerConfig(worker_metrics_port=9100,
                                sched_cooldown_floor_seconds=0.0))
    name = "sched-migrate"
    h.create_job(name, restart_policy="OnFailure")
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    sync()
    h.resync()
    h.make_workers_ready(name)
    sync()
    h.resync()
    h.set_launcher_active(name)
    h.resync()
    sync()
    h.resync()
    for _ in range(8):
        clock["now"] += 10
        step["v"] += 1
        sync()
        h.resync()
        job = h.job(name)
        if job.status.restart_count:
            raise ConvergenceError(
                "migration leg: a partial partition with an advancing "
                "frontier restarted the gang", seed)
        if job.status.migration_count > 1:
            raise ConvergenceError(
                f"migration leg: {job.status.migration_count} migrations "
                f"in one degraded window (at most one allowed)", seed)
    job = h.job(name)
    if job.status.migration_count != 1:
        raise ConvergenceError(
            f"migration leg: expected exactly one migration, got "
            f"{job.status.migration_count}", seed)
    if not job.status.migrated_window:
        raise ConvergenceError(
            "migration leg: migration landed without its window marker "
            "(a replayed sync would migrate again)", seed)
    migrations = [r for r in obs.merged_records(name)
                  if r["event"] == "sched_migrate"]
    if len(migrations) != 1:
        raise ConvergenceError(
            f"migration leg: expected one sched_migrate timeline record, "
            f"got {len(migrations)}", seed)
    return {"sched_migrations": 1,
            "sched_migration_restarts": 0,
            "sched_migrations_per_window_max": 1}


def scheduler_soak(seed: int = 0, rules: Sequence = DEFAULT_RULES,
                   crash_every_write: bool = True) -> Dict:
    """All scheduler legs; one merged report (the soak report's
    "scheduler" section)."""
    report: Dict = {}
    report.update(scheduler_rebalance(seed, rules, crash_every_write))
    report.update(scheduler_thrash(seed))
    report.update(scheduler_migration(seed))
    return report


def engine_legs_importable() -> bool:
    """Whether this process can build the engine legs' models: the
    operator's image holds no torch, and its soak skips those legs (and
    says so in the report) rather than failing on the import."""
    import importlib.util
    try:
        return importlib.util.find_spec("torch") is not None
    except (ImportError, ValueError):
        return False


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import logging
    import sys

    # injected faults are logged as sync errors by design; the soak's
    # verdict is the JSON report, not the per-retry noise
    logging.getLogger("tpujob-controller").setLevel(logging.CRITICAL)

    parser = argparse.ArgumentParser(
        description="chaos soak: fault-injected, crash-interrupted job "
                    "lifecycles vs. the uninterrupted oracle")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lifecycles", type=int, default=25)
    parser.add_argument("--rule", action="append", default=None,
                        metavar="VERB/KIND=RATE:ERROR",
                        help="fault rule (repeatable); default: "
                             + " ".join(DEFAULT_RULES))
    parser.add_argument("--no-crash", action="store_true",
                        help="faults only, no kill at write boundaries")
    parser.add_argument("--scrape-faults", action="append", default=None,
                        metavar="RANK/KIND=RATE",
                        help="data-plane scrape fault rule (repeatable); "
                             "default: " + " ".join(DEFAULT_SCRAPE_RULES))
    parser.add_argument("--no-data-plane", action="store_true",
                        help="control-plane soak only (skip scrape-fault, "
                             "serving-lease, and request-timeout legs)")
    parser.add_argument("--no-scheduler", action="store_true",
                        help="skip the fleet-scheduler legs (preempt-to-"
                             "admit, grow-back, anti-thrash, migration)")
    parser.add_argument("--device", default="cuda",
                        help="where the data-plane engine legs run (default "
                             "the CUDA card; 'cpu' asks for the CPU). They "
                             "run when this process can import torch and "
                             "are reported skipped where it cannot")
    opts = parser.parse_args(argv)
    rules = opts.rule if opts.rule is not None else DEFAULT_RULES
    scrape_rules = (opts.scrape_faults if opts.scrape_faults is not None
                    else DEFAULT_SCRAPE_RULES)
    try:
        report = soak(seed=opts.seed, lifecycles=opts.lifecycles,
                      rules=rules, crash_every_write=not opts.no_crash)
        # the GPU lifecycles, each twice, after the reference's mix
        report["gpu"] = soak(
            seed=opts.seed, lifecycles=2 * len(GPU_LIFECYCLES),
            rules=rules, crash_every_write=not opts.no_crash,
            kinds=GPU_LIFECYCLES)
        if not opts.no_scheduler:
            report["scheduler"] = scheduler_soak(
                seed=opts.seed, rules=rules,
                crash_every_write=not opts.no_crash)
        if not opts.no_data_plane:
            engines = engine_legs_importable()
            report["data_plane"] = data_plane_soak(
                seed=opts.seed, scrape_faults=scrape_rules,
                engine_leg=engines, device=opts.device)
            report["engine_legs"] = (
                {"device": str(opts.device)} if engines else
                "skipped: this process cannot import torch")
    except ConvergenceError as exc:
        print(f"CHAOS SOAK FAILED: {exc}", file=sys.stderr)
        print(f"reproduce: python -m mpi_operator_tpu_torch.controller.chaos "
              f"--seed {opts.seed} --lifecycles {opts.lifecycles}",
              file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
