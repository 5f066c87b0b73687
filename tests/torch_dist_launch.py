"""Start a group of gloo ranks on the CPU for the port's multi-process
tests, as torchrun would: one process per rank with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set,
each pinned to one torch thread. A test file runs its own ranks by
starting itself as a script (its ``__main__`` block), once per file, and
reads back what each rank wrote."""

from __future__ import annotations

import os
import socket
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for one rank, one torch thread."""
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]))
    return env


def start(cmd: list[str], world: int, out: Path, tag: str) -> list[subprocess.Popen]:
    """``cmd`` once per rank, each rank's output in ``out/<tag>.<rank>.log``."""
    port = free_port()
    procs = []
    for r in range(world):
        log = open(out / f"{tag}.{r}.log", "w")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=rank_env(r, world, port),
                                      stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait(procs: list[subprocess.Popen], timeout: float, out: Path, tag: str) -> list[int]:
    """Every rank's exit code; kills the group and fails with the logs if
    one has not exited within ``timeout`` seconds."""
    try:
        return [p.wait(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        logs = "\n".join((out / f"{tag}.{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        raise AssertionError(f"{tag}: a rank did not exit within {timeout} s:\n{logs}")
