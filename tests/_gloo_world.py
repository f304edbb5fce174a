"""Start a world of gloo ranks as processes on the CPU, for the tests of
the split serving paths.

`spawn(child, world, d)` runs `python <child> <rank> <world> <d>` for
every rank at once with `src/` on the path and one intra-op thread, each
logging to <d>/<prefix><r>.log and killed at its timeout; the child opens
its group from a `FileStore` in <d> and writes <d>/<prefix><r>.npz.
Raises with the ranks' log tails if one failed; returns each rank's
arrays.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def spawn(child: Path, world: int, d: Path, timeout: int = 240,
          prefix: str = "rank") -> list[dict]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    logs = [open(d / f"{prefix}{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(child), str(r), str(world), str(d)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r}:\n" + (d / f"{prefix}{r}.log").read_text()[-3000:]
                          for r in range(world))
        raise AssertionError(f"{child.name} world {world}: exit codes "
                             f"{[p.returncode for p in procs]}\n{tails}")
    return [dict(np.load(d / f"{prefix}{r}.npz")) for r in range(world)]
