"""Operator process entry point — `python -m mpi_operator_tpu_torch`.

ref: cmd/mpi-operator/main.go:42-115. Flags mirror the reference's
(--gpus-per-node → --tpus-per-worker etc.). Default mode converges a REAL
cluster: `--kube-config`/`--master` (or the in-cluster service-account
mount) select the `KubeAPIServer` backend — a zero-dependency typed REST
client (cluster/kubeclient.py), the analogue of the reference's clientsets
(main.go:42-96). `--demo` instead runs the full reconcile lifecycle against
the in-memory API server so the operator is drivable end-to-end on a laptop.

The PyTorch port's copy of mpi_operator_tpu/__main__.py, in GPU mode: the
defaults are `--processing-resource-type nvidia.com/gpu` and
`--processing-units-per-worker 8` (the reference's --gpus-per-node 8)
and `--demo` submits a GPU job. `--worker-metrics-port` and
`--events-dir` turn on the job observatory (telemetry/collector.py): the
controller scrapes each worker's /metrics + /events every
`--scrape-interval` seconds and writes each job's merged timeline, which
`python -m mpi_operator_tpu_torch.postmortem` renders. The operator
process imports neither torch nor jax.
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time

from .api.types import RESOURCE_CPU, RESOURCE_GPU, RESOURCE_TPU, new_tpu_job
from .cluster.apiserver import InMemoryAPIServer
from .controller import ControllerConfig, TPUJobController


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi-operator-tpu",
        description="allreduce-training operator for GPU and TPU workers "
                    "(TPUJob controller)",
    )
    # ref main.go:98-115
    p.add_argument("--kube-config", default="",
                   help="path to a kubeconfig (out-of-cluster operation); "
                        "omit both this and --master to use the in-cluster "
                        "service-account config")
    p.add_argument("--master", default="",
                   help="Kubernetes API server address (overrides kubeconfig)")
    p.add_argument("--tpus-per-worker", type=int, default=4,
                   help="cluster-level default chips per worker of the "
                        "tpus sizing mode (v5e host granularity is 4)")
    p.add_argument("--processing-units-per-worker", type=int, default=8,
                   help="cluster-level default units per worker of the "
                        "processingUnits sizing mode (ref --gpus-per-node "
                        "8: an 8-card node)")
    p.add_argument("--processing-resource-type", default=RESOURCE_GPU,
                   choices=[RESOURCE_GPU, RESOURCE_CPU, RESOURCE_TPU])
    p.add_argument("--namespace", default=None,
                   help="restrict the operator to one namespace "
                        "(ref main.go:63-71)")
    p.add_argument("--enable-gang-scheduling", action="store_true")
    p.add_argument("--discovery-image", default=None,
                   help="optional init-container image "
                        "(ref --kubectl-delivery-image; usually unneeded)")
    p.add_argument("--discovery-timeout", type=int, default=300,
                   help="seconds the discovery init step waits for worker "
                        "DNS before failing (large multi-slice jobs on "
                        "slow DNS may need more)")
    p.add_argument("--threadiness", type=int, default=2)
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics (Prometheus) and /healthz on this "
                        "port (0 = disabled; the shipped Deployment sets "
                        "8080 and probes /healthz)")
    p.add_argument("--worker-metrics-port", type=int, default=0,
                   help="scrape each worker pod's /metrics + /events on "
                        "this port and re-export federated tpu_job_* "
                        "series on --metrics-port (0 = disabled); also "
                        "injects TPU_METRICS_PORT into worker env so the "
                        "benchmarks serve it without per-job flags")
    p.add_argument("--events-dir", default=None,
                   help="directory for the controller's own event log and "
                        "per-job merged timeline.jsonl files (feeds "
                        "python -m mpi_operator_tpu_torch.postmortem)")
    p.add_argument("--scrape-interval", type=float, default=10.0,
                   help="seconds between worker /metrics federation "
                        "scrapes per job")
    p.add_argument("--demo", action="store_true",
                   help="run against the in-memory API server with a sample "
                        "GPU TPUJob and simulated kubelet")
    return p


def run_demo(controller: TPUJobController, api: InMemoryAPIServer) -> int:
    """Submit a sample job and play kubelet: mark workers ready, complete the
    launcher — the end-to-end lifecycle of SURVEY §3.3 in one process."""
    log = logging.getLogger("demo")
    job = new_tpu_job("demo", processing_units=16,
                      processing_units_per_worker=8,
                      processing_resource_type=RESOURCE_GPU)
    job.spec.template.main_container().image = "tpu-bench-torch:latest"
    api.create(job)
    log.info("submitted TPUJob demo (%s: 2 workers x 8)", RESOURCE_GPU)

    def wait(pred, desc, timeout=10.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            obj = pred()
            if obj:
                log.info("observed: %s", desc)
                return obj
            time.sleep(0.05)
        raise TimeoutError(desc)

    sts = wait(lambda: api.try_get("StatefulSet", "default", "demo-worker"),
               "worker StatefulSet created")
    sts.status.ready_replicas = sts.spec.replicas
    api.update(sts)
    launcher = wait(lambda: api.try_get("Job", "default", "demo-launcher"),
                    "launcher Job created after workers ready")
    launcher.status.succeeded = 1
    launcher.status.completion_time = time.time()
    api.update(launcher)
    wait(lambda: api.get("TPUJob", "default", "demo").status.is_done(),
         "TPUJob Succeeded")
    wait(lambda: api.get("StatefulSet", "default",
                         "demo-worker").spec.replicas == 0,
         "workers scaled down")
    log.info("demo lifecycle complete")
    return 0


def demo_observatory(config: ControllerConfig):
    """The job observatory of a --demo run, when the flags ask for one.
    The demo's simulated kubelet starts no worker process, so no pod
    serves /metrics: every scrape fails as a dark pod's would, without
    looking up the pod's DNS name (there is no cluster to ask)."""
    if not (config.events_dir or config.worker_metrics_port):
        return None
    from .telemetry.collector import JobObservatory

    def no_pod(url: str) -> str:
        raise OSError(f"--demo runs no worker process to serve {url}")

    return JobObservatory(events_dir=config.events_dir,
                          scrape_interval=config.scrape_interval,
                          serving_rate_floor=config.serving_rate_floor,
                          fetch=no_pod)


def main(argv=None, stop_event=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    config = ControllerConfig(
        tpus_per_worker=args.tpus_per_worker,
        processing_units_per_worker=args.processing_units_per_worker,
        processing_resource_type=args.processing_resource_type,
        enable_gang_scheduling=args.enable_gang_scheduling,
        namespace=args.namespace,
        discovery_image=args.discovery_image,
        discovery_timeout_seconds=args.discovery_timeout,
        worker_metrics_port=args.worker_metrics_port or None,
        events_dir=args.events_dir,
        scrape_interval=args.scrape_interval,
    )

    stop = stop_event or threading.Event()
    if stop_event is None:                                 # ref main.go:46
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())

    def start_metrics(controller):
        if args.metrics_port <= 0:
            return None
        from .controller.metrics import MetricsServer
        server = MetricsServer(controller, port=args.metrics_port)
        logging.getLogger("main").info(
            "metrics/healthz on :%d", server.port)
        return server

    if args.demo:
        api = InMemoryAPIServer()
        controller = TPUJobController(api, config=config,
                                      observatory=demo_observatory(config))
        metrics = None
        try:
            # bind before run(): the probe target must exist while caches
            # sync, and a bind failure must still tear the queue down
            metrics = start_metrics(controller)
            controller.run(threadiness=args.threadiness, stop_event=stop)
            return run_demo(controller, api)
        finally:
            stop.set()
            controller.queue.shut_down()
            if metrics:
                metrics.close()

    # Real-cluster mode (ref main.go:42-96): kubeconfig / --master /
    # in-cluster, then run until signaled.
    from .cluster.kubeclient import KubeAPIServer, KubeConfig, KubeConfigError
    try:
        kube_config = KubeConfig.load(kubeconfig=args.kube_config,
                                      master=args.master)
    except (KubeConfigError, OSError) as exc:
        print(f"error building kube client config: {exc}", file=sys.stderr)
        return 2
    # scope follows --namespace exactly, as the reference does (main.go:63-71
    # WithNamespace only when the flag is set): the shipped RBAC
    # (deploy/2-rbac.yaml) is cluster-wide, so an unflagged operator must
    # watch all namespaces, not silently self-scope to its own
    api = KubeAPIServer(kube_config)
    controller = TPUJobController(api, config=config)
    logging.getLogger("main").info(
        "starting TPUJob controller against %s (namespace=%s)",
        kube_config.server, config.namespace or "<all>")
    metrics = None
    try:
        metrics = start_metrics(controller)     # bind before cache sync
        controller.run(threadiness=args.threadiness, stop_event=stop)
        stop.wait()                                        # run until signal
    finally:
        stop.set()
        api.stop()
        controller.queue.shut_down()
        if metrics:
            metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
