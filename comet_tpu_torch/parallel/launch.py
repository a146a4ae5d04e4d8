"""Local ranks as processes: a free port for the rendezvous, and the
launcher that starts one process per rank and waits for all of them."""

from __future__ import annotations

import socket
import subprocess
import time
from typing import Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_local_ranks(commands: Sequence[Sequence[str]], timeout_s: Optional[float] = None,
                    cwd: Optional[str] = None) -> None:
    """Start one process per command (rank i runs ``commands[i]``, in this
    process's environment, from ``cwd``) and wait for all. A rank that exits
    nonzero, or a run past ``timeout_s``, stops every other rank and
    raises."""
    procs = [subprocess.Popen(list(cmd), cwd=cwd) for cmd in commands]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, rc) for i, rc in enumerate(codes) if rc not in (None, 0)]
            if failed:
                raise RuntimeError(f"run_local_ranks: rank {failed[0][0]} exited with code "
                                   f"{failed[0][1]}")
            if all(rc == 0 for rc in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"run_local_ranks: the ranks ran past {timeout_s} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
