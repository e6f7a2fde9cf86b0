"""The rank launcher of a cell with ``world`` > 1: one process a rank, one
card a rank.

The ranks meet in a ``torch.distributed`` TCP store that rank 0 serves on
a free port of this machine (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``: what the program's
``launch.train.build_world`` reads).  Nothing is written to a fixed path,
and no tensor passes between ranks on the host.  The launcher waits for
every rank; if one fails, it ends the others.
"""
from __future__ import annotations

import os
import socket
import subprocess
from typing import Dict, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, argv: Sequence[str], env: Dict[str, str], timeout: float = 1500.0) -> int:
    """Run ``argv`` as ``world`` ranks; returns the worst exit code."""
    port = free_port()
    procs: List[subprocess.Popen] = []
    for rank in range(world):
        e = dict(os.environ, **env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(list(argv), env=e))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
            if codes[-1] != 0:
                break
    except subprocess.TimeoutExpired:
        codes.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(codes, key=abs) if codes else 1
