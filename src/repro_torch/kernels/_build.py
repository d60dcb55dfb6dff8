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
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("errors.cu", "flash_attention.cu", "paged_attention.cu", "grouped_matmul.cu")
HEADERS = ("common.cuh",)
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
LAUNCH_COUNTS: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


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
    + [_I, _I, _F, _F, _P],
    "paged_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P]
    + [_I] * 9
    + [_F, _F, _P],
    "grouped_matmul_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
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
    """Raise if a launch entry returned a CUDA error."""
    if status != 0:
        msg = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status} ({msg})")


def dtype_code(dtype) -> int:
    """The C entries' element-type code: 0 float32, 1 bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise ValueError(f"the Hopper kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
