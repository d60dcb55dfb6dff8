"""Helpers of the port's multi-rank tests (``tests/test_torch_sharded_*.py``):
the JAX reference runs in one subprocess on forced host devices (two by
default), the port in as many gloo ranks started by
``repro_torch.sharding.launch.spawn``, and the two sides meet through npz
files in the test's ``tmp_path``."""

import os
import subprocess
import sys
import textwrap

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
SRC = os.path.join(ROOT, "src")


def run_jax(code: str, *argv: str, timeout: float = 600, devices: int = 2) -> str:
    """Run ``code`` (with ``argv``) in a subprocess whose JAX sees
    ``devices`` CPU devices; returns its stdout, raising with its output if
    it fails."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, TESTS]))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *argv], capture_output=True, text=True,
                       env=env, timeout=timeout)
    if r.returncode:
        raise AssertionError(f"the JAX reference failed:\n{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    return r.stdout


def run_ranks(target: str, workdir, timeout: float = 600, world_size: int = 2, **args):
    """``target`` ("module:function", a module of ``tests/``) on
    ``world_size`` gloo ranks over the CPU (two by default); returns every
    rank's result."""
    from repro_torch.sharding.launch import spawn

    return spawn(target, world_size, backend="gloo", args=args, timeout=timeout, workdir=str(workdir),
                 env={"OMP_NUM_THREADS": "1"}, pythonpath=(TESTS,))


def flatten(tree, prefix: str = ""):
    """A nested dict of arrays (a resident INT4 leaf as its three arrays)
    -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif all(hasattr(v, a) for a in ("packed", "scales", "zeros")):
            for a in ("packed", "scales", "zeros"):
                out[f"{key}#{a}"] = np.asarray(getattr(v, a))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat):
    """The inverse of ``flatten`` (dense leaves only)."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    return tree


def save_tree(path, tree) -> None:
    np.savez(path, **flatten(tree))


def load_tree(path):
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})
