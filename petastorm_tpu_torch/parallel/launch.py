"""Start one local process per rank, as ``torchrun --nproc-per-node N`` does.

``run_ranks(cmd, n, timeout, log_prefix)`` starts ``n`` copies of ``cmd`` with
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost
port) and the repository root on ``PYTHONPATH``, so a worker initializes its
group with ``init_process_group(backend, init_method="env://")``.  Rank ``r``
writes its output to ``{log_prefix}.{r}.log``.  All ranks share one deadline;
a rank still running at it is killed, and so is every rank once one fails.
The port's selfcheck, its multi-process tests and ``chip_smoke.py`` launch
their ranks through it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Dict, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def log_path(log_prefix: str, rank: int) -> str:
    return f"{log_prefix}.{rank}.log"


def run_ranks(cmd: Sequence[str], n: int, timeout: float, log_prefix: str,
              env: Optional[Dict[str, str]] = None) -> Optional[str]:
    """Run ``cmd`` as ranks 0..n-1 of one job; None when every rank exited 0
    within ``timeout`` seconds, else what went wrong and every rank's log
    tail.  ``env`` adds variables to every rank's environment."""
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            rank_env = dict(os.environ, **(env or {}), RANK=str(rank), WORLD_SIZE=str(n),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                            PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
            with open(log_path(log_prefix, rank), "w") as log:
                procs.append(subprocess.Popen(list(cmd), env=rank_env, stdout=log,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failure = None
        pending = dict(enumerate(procs))
        while pending and failure is None:
            for rank, proc in list(pending.items()):
                code = proc.poll()
                if code is not None:
                    del pending[rank]
                    if code != 0:
                        failure = f"rank {rank} exited with code {code}"
                        break
            if failure is None and pending:
                if time.monotonic() > deadline:
                    failure = f"rank {min(pending)} timed out after {timeout:.0f} s"
                else:
                    time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failure is None:
        return None
    tails = []
    for rank in range(n):
        with open(log_path(log_prefix, rank), errors="replace") as f:
            tails.append(f"--- rank {rank}:\n" + f.read()[-3000:])
    return f"{' '.join(cmd[1:4])}: {failure}\n" + "\n".join(tails)
