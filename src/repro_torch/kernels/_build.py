"""Build the hand-written Hopper kernels and load them with ``ctypes``.

The CUDA sources under ``csrc/`` have a plain C interface: every entry
takes raw device pointers, sizes and the CUDA stream, launches on that
stream and returns ``cudaGetLastError()``. They are compiled at first use
with ``nvcc`` for ``sm_90a`` into one shared library under
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. Each source compiles in its own ``nvcc`` process, all
started together, and the objects are linked into the library under a
temporary name that is then renamed into place: two processes building at
once (pytest workers on one card) each finish with a complete library.

Nothing here runs at import time. A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "errors.cu",
    "flash_attention.cu",
    "paged_attention.cu",
    "prefix_paged_attention.cu",
    "grouped_matmul.cu",
    "int4_dequant.cu",
)
HEADERS = ("common.cuh", "decode.cuh", "sm90.cuh")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# Kernel launches by kernel name: each wrapper adds one where it launches
# its kernel on the card, and nowhere else (plain CPU calls do not count).
# The async INT4 restore launches from a worker thread, so every update
# goes through ``count_launch``.
LAUNCH_COUNTS: collections.Counter = collections.Counter()
# The same launches by (kernel name, variant) for the kernels whose launch
# plan picks a variant: flash and grouped matmul (``wgmma`` or ``simt``),
# paged and prefix-paged attention (``split`` or ``simt``).
VARIANT_COUNTS: collections.Counter = collections.Counter()
# The same launches by (kernel name, shape), the shape as each wrapper
# gives it: flash (B, S, Hq, Hkv, hd, window, softcap), the paged and
# prefix kernels (B, C, Hq, Hkv, hd), grouped matmul (E, C, K, N), dequant
# (G, group size, output dtype name).
SHAPE_COUNTS: collections.Counter = collections.Counter()
# Which branch each seam call took (``op.hopper`` / ``op.ref``), kept here
# beside the launch counts so that a step capture can record all three
# (``repro_torch.kernels.ops`` re-exports it).
DISPATCH_COUNTS: collections.Counter = collections.Counter()
# The dry run's tally (``repro_torch.launch.dryrun``): a wrapper handed
# fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) builds
# and launches nothing; it returns fake outputs and adds its call, its
# FLOPs and the HBM bytes its kernel moves here, by kernel name.
TRACED_CALLS: collections.Counter = collections.Counter()
TRACED_FLOPS: collections.Counter = collections.Counter()
TRACED_BYTES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()
_capturing = threading.local()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


@dataclasses.dataclass
class Counts:
    """Launch, variant, shape and dispatch counts that a CUDA-graph capture
    would have made; each replay of the graph adds them to the global
    counters."""

    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    variants: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    dispatch: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def add_to_globals(self) -> None:
        with _count_lock:
            LAUNCH_COUNTS.update(self.launches)
            VARIANT_COUNTS.update(self.variants)
            SHAPE_COUNTS.update(self.shapes)
            DISPATCH_COUNTS.update(self.dispatch)


@contextlib.contextmanager
def recording():
    """Suspend counting on the calling thread only, and yield the ``Counts``
    its calls would have made. A step capture runs inside it: the kernels
    it records run only when the graph is replayed. Other threads (the
    async INT4 restore's worker) keep counting as they launch."""
    counts = Counts()
    outer = getattr(_capturing, "counts", None)
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = outer


def count_launch(kernel: str, variant: Optional[str] = None, shape: Optional[tuple] = None) -> None:
    """Add one launch of ``kernel`` to ``LAUNCH_COUNTS``, where a launch
    plan chose a ``variant`` to ``VARIANT_COUNTS``, and at its ``shape`` to
    ``SHAPE_COUNTS`` (thread-safe); under ``recording()`` to that thread's
    ``Counts`` instead."""
    counts = getattr(_capturing, "counts", None)
    if counts is None:
        with _count_lock:
            _add(LAUNCH_COUNTS, VARIANT_COUNTS, SHAPE_COUNTS, kernel, variant, shape)
        return
    _add(counts.launches, counts.variants, counts.shapes, kernel, variant, shape)


def _add(launches, variants, shapes, kernel: str, variant, shape) -> None:
    launches[kernel] += 1
    if variant is not None:
        variants[(kernel, variant)] += 1
    if shape is not None:
        shapes[(kernel, shape)] += 1


def count_dispatch(branch: str) -> None:
    """Add one call of the seam branch ``branch`` to ``DISPATCH_COUNTS``
    (thread-safe); under ``recording()`` to that thread's ``Counts``."""
    counts = getattr(_capturing, "counts", None)
    if counts is not None:
        counts.dispatch[branch] += 1
        return
    with _count_lock:
        DISPATCH_COUNTS[branch] += 1


def reset_launch_counts() -> None:
    """Zero ``LAUNCH_COUNTS``, ``VARIANT_COUNTS``, ``SHAPE_COUNTS``,
    ``DISPATCH_COUNTS`` and the dry run's ``TRACED_*`` tally."""
    with _count_lock:
        for counts in (LAUNCH_COUNTS, VARIANT_COUNTS, SHAPE_COUNTS, DISPATCH_COUNTS, TRACED_CALLS, TRACED_FLOPS,
                       TRACED_BYTES):
            counts.clear()


def faking() -> bool:
    """Whether a ``FakeTensorMode`` is active: the dry run traces the
    card's path on fake CUDA tensors, its target the H100 by definition."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: a shape and a dtype, no data to
    compute on."""
    return isinstance(t, FakeTensor)


def count_traced(kernel: str, shape: tuple, flops: int, nbytes: int) -> None:
    """Record one call of ``kernel`` on fake tensors: its ``shape`` in
    ``SHAPE_COUNTS`` (the key its launch would have), its call, ``flops``
    and HBM ``nbytes`` in the ``TRACED_*`` tally. Nothing was launched, so
    ``LAUNCH_COUNTS`` is left alone."""
    with _count_lock:
        SHAPE_COUNTS[(kernel, shape)] += 1
        TRACED_CALLS[kernel] += 1
        TRACED_FLOPS[kernel] += flops
        TRACED_BYTES[kernel] += nbytes


def build_dir() -> Path:
    """``build/repro_torch/`` at the root of the checkout."""
    return CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (cuda_home, "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME and /usr/local/cuda): "
        "the repro_torch Hopper kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the path.

    The compiler's ``-Xptxas -v`` report (registers, shared memory and
    spills of every kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=out.parent))
    try:
        objs: List[Path] = []
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
            procs.append(
                (name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            )
        log = []
        failed = []
        for name, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = tmp / out.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(lib_tmp)]
        res = subprocess.run(link + [str(o) for o in objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (tmp / (out.stem + ".log")).write_text("\n".join(log))
        os.replace(tmp / (out.stem + ".log"), out.parent / (out.stem + ".log"))
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I]
    + [_L] * 12
    + [_I, _I, _F, _F]
    + [_I] * 6
    + [_P],
    "paged_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P]
    + [_I] * 9
    + [_F, _F, _I, _I, _I, _P, _P],
    "grouped_matmul_launch": [_P, _P, _P] + [_I] * 5 + [_I] * 7 + [_P],
    "prefix_paged_attention_launch": [_P] * 10 + [_I] * 9 + [_F, _F, _I, _I, _I, _P, _P],
    "int4_dequant_launch": [_P, _P, _P, _P, _I, _L, _I, _P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch entry returned a CUDA error, a failed tensor-map
    encode (1000 + CUresult) or a refused launch plan (2000)."""
    if status != 0:
        msg = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: error {status} ({msg})")


# Shared memory one block may use on an H100 (227 KB of the SM's 256 KB).
SMEM_MAX = 232_448
VARIANTS = ("wgmma", "simt")


def check_plan(kernel: str, variant: str, smem_bytes: int, n: Optional[int] = None,
               variants: Tuple[str, ...] = VARIANTS) -> None:
    """Raise ValueError for a launch plan no kernel takes: a variant not in
    ``variants``, more than ``SMEM_MAX`` bytes of shared memory, or (where
    given) a wgmma width ``n`` that is not a multiple of 8 in 8..256."""
    if variant not in variants:
        raise ValueError(f"{kernel}: unknown variant {variant!r}, expected one of {variants}")
    if not 0 <= smem_bytes <= SMEM_MAX:
        raise ValueError(f"{kernel}: plan needs {smem_bytes} B of shared memory, a block has at most {SMEM_MAX}")
    if n is not None and not (8 <= n <= 256 and n % 8 == 0):
        raise ValueError(f"{kernel}: plan width N={n} is not a multiple of 8 in 8..256")


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(dtype) -> int:
    """The C entries' element-type code: 0 float32, 1 bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the Hopper kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
