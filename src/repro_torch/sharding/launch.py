"""Run a function on every rank of a fresh process group, one process per
rank: ``spawn("pkg.module:function", world_size, backend="gloo")``.

Each rank is a new Python process (``python -m
repro_torch.sharding.launch``) that joins a group over a ``FileStore`` in a
directory of its own (no TCP port to collide with another run), wraps it in
a ``RankMesh`` and calls ``function(mesh, **args)``. What the function
returns (anything ``pickle`` takes) comes back to the caller, by rank.

No rank can hang its peers: the group has a timeout, a rank that raises
prints its traceback and exits non-zero, and the caller then kills the
other ranks at once and raises with the failed rank's output. Every run has
a timeout of its own too, after which every rank is killed.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankFailed(RuntimeError):
    """A rank raised, died or outlived the run's timeout."""


def spawn(target: str, world_size: int, *, backend: str = "gloo", args: Optional[Dict[str, Any]] = None,
          timeout: float = 600.0, workdir: Optional[str] = None, env: Optional[Dict[str, str]] = None,
          pythonpath: tuple = ()) -> List[Any]:
    """Run ``target`` ("module:function") on ``world_size`` ranks over a
    ``backend`` group; returns the ranks' results in rank order. ``args``
    are the function's keywords; ``pythonpath`` adds directories the
    target's module is found in; ``env`` adds environment variables."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="ranks_")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.pkl"), "wb") as f:
        pickle.dump(args or {}, f)
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = os.pathsep.join([_SRC, *pythonpath, *filter(None, [child_env.get("PYTHONPATH")])])
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs, logs = [], []
    for rank in range(world_size):
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.sharding.launch", "--target", target, "--rank", str(rank),
             "--world-size", str(world_size), "--backend", backend, "--workdir", workdir,
             "--timeout", str(timeout)],
            stdout=log, stderr=subprocess.STDOUT, env=child_env))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = (bad[0], f"exited with code {procs[bad[0]].returncode}")
                break
            if time.monotonic() > deadline:
                failed = (next(r for r, p in enumerate(procs) if p.poll() is None), f"outlived {timeout:.0f} s")
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], f"exited with code {procs[bad[0]].returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    if failed is not None:
        rank, why = failed
        raise RankFailed(f"rank {rank} of {world_size} ({target}) {why}; its output:\n{outputs[rank][-6000:]}")
    results = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"result{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    if own:
        for name in os.listdir(workdir):
            os.remove(os.path.join(workdir, name))
        os.rmdir(workdir)
    return results


def _child(a) -> None:
    import torch.distributed as dist

    from repro_torch.sharding.mesh import RankMesh

    with open(os.path.join(a.workdir, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    module, name = a.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    store = dist.FileStore(os.path.join(a.workdir, "store"), a.world_size)
    dist.init_process_group(a.backend, store=store, rank=a.rank, world_size=a.world_size,
                            timeout=datetime.timedelta(seconds=a.timeout))
    try:
        result = fn(RankMesh(), **kwargs)
        with open(os.path.join(a.workdir, f"result{a.rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--workdir", required=True)
    p.add_argument("--timeout", type=float, default=600.0)
    _child(p.parse_args())


if __name__ == "__main__":
    main()
