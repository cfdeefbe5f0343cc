"""Run a process group of the port on the CPU for a test: `world` Python
processes over gloo on 127.0.0.1, each `python -c CODE MODE RANK WORLD PORT
DIR`, each under the same time limit, so that a deadlock fails the test
instead of hanging it (as tests/test_torch_distributed.py runs its two)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# the head of every worker: its arguments, one torch thread, the rank
HEAD = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
mode, rank, world, port, tmp = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
os.environ["RANK"] = str(rank)
url = f"tcp://127.0.0.1:{port}"
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(code, mode, world, tmp):
    """Start the group -> its processes (pass them to `wait`)."""
    port = str(free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "PROCESS_ID", "JAX_PROCESS_ID", "WORLD_SIZE",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, "-c", HEAD + code, mode, str(r), str(world), port,
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(REPO), env=env) for r in range(world)]


def wait(procs, mode, timeout=150):
    """The group's outputs; fails on a nonzero exit, a missing
    `WORKER DONE rank=r` line or a process past `timeout` seconds (every
    one killed then)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail(f"{mode}: the {len(procs)} processes outlasted "
                    f"{timeout}s (deadlock?):\n" + "\n=== next rank ===\n"
                    .join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r}:\n{out[-4000:]}"
        assert f"WORKER DONE rank={r}" in out, out[-4000:]
    return outs


def run(code, mode, world, tmp, timeout=150):
    return wait(start(code, mode, world, tmp), mode, timeout)
