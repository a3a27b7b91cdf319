"""Per-worker process launcher — the `orted` replacement for slots>1 (the
port's copy of `mpi_operator_tpu/bootstrap/launch.py`).

In the reference, `mpirun` reaches into each worker pod via the kubexec rsh
agent and spawns one `orted`, which forks `slots` ranks (reference hostfile
`slots=` lines, pkg/controllers/mpi_job_controller.go:857-869). TPU-native
workers run their own processes, so when a TPUJob sets slotsPerWorker > 1
the pod command wraps the training command with this module:

    python -m mpi_operator_tpu_torch.bootstrap.launch -- python train.py ...

It forks `TPU_SLOTS_PER_WORKER` copies of the command, tagging each with
TPU_LOCAL_RANK=0..slots-1 (bootstrap.process_info turns that into the
global rank `ordinal*slots + local`), waits for all, and exits with the
first non-zero status — the same all-or-nothing semantics mpirun gave.

On GPU nodes slots is the number of cards a worker drives, one rank a
card (bootstrap.initialize picks `cuda:{TPU_LOCAL_RANK % cards}`); with
slots=1 this module is not needed at all.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import List, Optional

from .bootstrap import ENV_LOCAL_RANK, ENV_SLOTS


def launch(command: List[str], slots: Optional[int] = None) -> int:
    slots = slots or int(os.environ.get(ENV_SLOTS, "1"))
    if slots == 1:
        return subprocess.call(command)

    procs: List[subprocess.Popen] = []
    for local_rank in range(slots):
        env = dict(os.environ)
        env[ENV_LOCAL_RANK] = str(local_rank)
        procs.append(subprocess.Popen(command, env=env))

    exit_code = 0
    try:
        import time

        remaining = list(procs)
        while remaining:
            done = [p for p in remaining if p.poll() is not None]
            for p in done:
                remaining.remove(p)
                if p.returncode != 0 and exit_code == 0:
                    exit_code = p.returncode
                    # one rank died → tear down the local gang, like mpirun
                    for q in remaining:
                        q.send_signal(signal.SIGTERM)
            if remaining:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return exit_code


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("usage: python -m mpi_operator_tpu_torch.bootstrap.launch -- "
              "<command> [args...]", file=sys.stderr)
        return 2
    return launch(argv)


if __name__ == "__main__":
    sys.exit(main())
