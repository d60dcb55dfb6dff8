"""Tuning runs of the two tensor-core kernels on one H100.

Run from the root of a checkout on a machine with one CUDA sm_90 card:
``PYTHONPATH=src python3 -m repro_torch.kernels.sweep``. It prints JSON
lines:

- ``gmm``: the bf16 grouped matmul at the main path's shapes (DeepSeekMoE-16B,
  E = 64, wi 2048 x 1408 and wo 1408 x 2048, C = 8, 16, 64) under launch
  plans of 64 or 128 f columns per item and 2 to 8 ring stages, each timed
  as device ms per call (CUDA events around a CUDA graph of 20 calls) beside
  ``torch.bmm`` timed the same way, with the byte bound and the largest
  error of any plan against the plain version;
- ``flash_phases``: where a block of the bf16 flash kernel spends its time,
  at B=4 S=128 and B=1 S=2048 (16 heads of 128): an instrumented copy of
  ``csrc/flash_attention.cu`` (built under ``build/kernel_sweep/``, never
  used elsewhere) writes each block's ``%globaltimer`` after each step of
  its first two key tiles, and the line gives the mean microseconds from
  the kernel's first block start to each step.

Then the card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

PHASES = ["start", "init", "q", "k0", "S0", "softmax0", "v0", "pv0", "k1", "S1", "softmax1", "v1", "pv1", "end"]

# (anchor in csrc/flash_attention.cu, the same text with a timestamp added)
_PROBES = [
    ("  using L = FaLayout<HD>;\n  constexpr float LOG2E", "  using L = FaLayout<HD>;\n  TR(0);\n  constexpr float LOG2E"),
    ("  __syncthreads();\n\n  if (warp == 4) {", "  __syncthreads();\n  TR(1);\n\n  if (warp == 4) {"),
    ("  mbar_wait(q_full, 0);\n", "  mbar_wait(q_full, 0);\n  TR(2);\n"),
    ("    mbar_wait(&k_full[s], parity);\n", "    mbar_wait(&k_full[s], parity);\n    if (i < 2) TR(3 + 5 * i);\n"),
    ("    wgmma_wait<0>();\n    fence_operands(sc);\n", "    wgmma_wait<0>();\n    fence_operands(sc);\n    if (i < 2) TR(4 + 5 * i);\n"),
    ("    mbar_wait(&v_full[s], parity);\n",
     "    if (i < 2) TR(5 + 5 * i);\n    mbar_wait(&v_full[s], parity);\n    if (i < 2) TR(6 + 5 * i);\n"),
    ("    mbar_arrive(&empty[s]);\n  }\n", "    mbar_arrive(&empty[s]);\n    if (i < 2) TR(7 + 5 * i);\n  }\n"),
    ("    }\n  }\n}\n\ntemplate <int HD>\nint launch_flash_wgmma_hd", "    }\n  }\n  TR(13);\n}\n\ntemplate <int HD>\nint launch_flash_wgmma_hd"),
]
_TRACE_HEADER = """
__device__ long long g_trace[4096 * 16];
__device__ __forceinline__ long long trace_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TR(ev)                                                                              \\
  do {                                                                                      \\
    if (threadIdx.x == 0) {                                                                 \\
      const int bl = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);        \\
      if (bl < 4096) g_trace[bl * 16 + (ev)] = trace_now();                                 \\
    }                                                                                       \\
  } while (0)
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the memory rate or
    bf16 operations at the tensor-core rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def graph_ms(torch, fn, reps: int = 20, replays: int = 3) -> float:
    """Mean device time per call of ``fn`` captured ``reps`` times into one
    CUDA graph, from CUDA events around ``replays`` replays."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


def sweep_gmm(torch, gm) -> None:
    import numpy as np

    rng = np.random.default_rng(0)
    for C in (8, 16, 64):
        for k_in, n_out in ((2048, 1408), (1408, 2048)):
            lhs = torch.from_numpy(rng.standard_normal((64, C, k_in)).astype(np.float32)).to("cuda", torch.bfloat16)
            rhs = torch.from_numpy(rng.standard_normal((64, k_in, n_out)).astype(np.float32) * k_in**-0.5).to(
                "cuda", torch.bfloat16)
            n = next(w for w in gm.WGMMA_N if w >= C)
            want = gm.grouped_matmul_plain(lhs, rhs).float()
            res = {"shape": f"E=64 C={C} {k_in}x{n_out}", "bmm_ms": graph_ms(torch, lambda: torch.bmm(lhs, rhs)),
                   "bound_ms": bound_ms(2 * (64 * C * k_in + 64 * k_in * n_out + 64 * C * n_out), 2 * 64 * C * k_in * n_out)}
            for bm, stages in ((64, 3), (64, 4), (64, 8), (128, 2), (128, 3), (128, 4), (128, 6), (128, 8)):
                plan = gm.wgmma_plan(64, C, k_in, n_out, n, bm, stages, 132)
                gm.check_plan(plan)
                out = torch.empty((64, C, n_out), dtype=torch.bfloat16, device="cuda")
                res[f"bm{bm}_stages{plan.stages}_ms"] = graph_ms(
                    torch, lambda: gm._launch(lhs.data_ptr(), rhs.data_ptr(), out, plan))
                res["max_abs_err"] = max(res.get("max_abs_err", 0.0), (out.float() - want).abs().max().item())
            res["bmm_ms_again"] = graph_ms(torch, lambda: torch.bmm(lhs, rhs))
            emit({"gmm": res})


def trace_flash(torch, fa, _build) -> None:
    import numpy as np

    src = (_build.CSRC / "flash_attention.cu").read_text()
    src = src.replace('#include "sm90.cuh"\n', '#include "sm90.cuh"\n' + _TRACE_HEADER, 1)
    for anchor, probed in _PROBES:
        if anchor not in src:
            raise RuntimeError(f"sweep: probe anchor not found in flash_attention.cu: {anchor!r}")
        src = src.replace(anchor, probed, 1)
    src += ('\nextern "C" int fa_trace_read(long long* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(long long) * 4096 * 16);\n}\n")
    out_dir = _build.build_dir().parent / "kernel_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_trace.cu").write_text(src)
    lib_path = out_dir / "libflash_trace.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-I", str(_build.CSRC), str(out_dir / "flash_trace.cu"),
           str(_build.CSRC / "errors.cu"), "-o", str(lib_path)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"sweep: nvcc failed:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.flash_attention_launch
    fn.argtypes = _build._SIGNATURES["flash_attention_launch"]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    for B, S in ((4, 128), (1, 2048)):
        q, k, v = (torch.from_numpy(rng.standard_normal((B, S, 16, 128)).astype(np.float32)).to("cuda", torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        o = torch.empty((B, S, 16, 128), dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        plan = fa.flash_plan(B, 16, S, 128, torch.bfloat16, True)
        strides = [x for t in (q, k, v, o) for x in t.stride()[:3]]
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, 16, 16, S, S, 128, *strides, 1, 0, 0.0,
                128**-0.5, 1, plan.block_q, plan.block_k, plan.stages, plan.grid[0], plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream]
        for _ in range(5):  # the last launch's timestamps are read
            status = fn(*args)
            if status:
                raise RuntimeError(f"sweep: traced flash launch failed: {status}")
        torch.cuda.synchronize()
        err = (o.float() - fa.flash_attention_plain(q, k, v).float()).abs().max().item()
        buf = (ctypes.c_longlong * (4096 * 16))()
        if lib.fa_trace_read(buf):
            raise RuntimeError("sweep: reading the trace failed")
        a = np.frombuffer(buf, dtype=np.int64).reshape(4096, 16)[: plan.items, : len(PHASES)].astype(np.float64)
        a[a == 0] = np.nan
        rel = (a - np.nanmin(a[:, 0])) / 1e3
        emit({"flash_phases": {
            "shape": f"B={B} S={S} H=16 hd=128 bf16 causal", "blocks": plan.items, "max_abs_err": err,
            "span_us": float(np.nanmax(rel[:, -1])),
            "mean_us_since_first_start": {n: float(np.nanmean(rel[:, i])) for i, n in enumerate(PHASES)},
        }})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm

    _build.library()
    sweep_gmm(torch, gm)
    trace_flash(torch, fa, _build)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
