"""Grouped (per-expert) matmul: the expert FFN kernel.

``grouped_matmul`` launches the hand-written Hopper kernel in
``csrc/grouped_matmul.cu`` (the port of ``repro/kernels/grouped_matmul.py``)
on a CUDA tensor, and on a CPU tensor, and only there, runs its plain
PyTorch version ``grouped_matmul_plain``.

On the card the launch follows a ``GmmPlan`` made here, before the launch,
from the dtype and the shapes alone: variant ``wgmma`` (bfloat16 operands
that a TMA tensor map can describe: d and f multiples of 8, both operands
16-byte aligned) or ``simt`` (float32, and the other bfloat16 shapes). Each
launch adds one to ``_build.LAUNCH_COUNTS["grouped_matmul"]`` and one to
``_build.VARIANT_COUNTS[("grouped_matmul", variant)]``. On fake tensors
(the dry run) it returns a fake output and tallies ``work``; nothing is
built or launched.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from . import _build

_INT_MAX = 2**31 - 1

# wgmma variant: 64 or 128 f columns (one or two wgmma M tiles) x 64 deep
# per stage, one pass of N capacity rows, N one of the kernel's
# instantiated widths. 128 columns with 3 or 4 stages in flight measured
# fastest on the main path's shapes (``repro_torch.kernels.sweep``,
# PERF.md); f <= 64 takes one M tile.
WGMMA_N = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)
WGMMA_BM = (64, 128)
WG_BK, WG_STAGES = 64, 4
# simt variant: 128 f columns, 32 deep, 8/16/32/64 rows per pass
SIMT_BM, SIMT_BK, SIMT_ROWS = 128, 32, (8, 16, 32, 64)


@dataclasses.dataclass(frozen=True)
class GmmPlan:
    """How one grouped-matmul call launches.

    ``variant`` ``wgmma``: a persistent 1-D grid of ``grid[0]`` blocks; work
    item i is row pass ``i % passes`` of f tile ``(i // passes) % f_tiles``
    of expert ``i // (passes * f_tiles)``, and block b takes items b,
    b + grid[0], ... (the kernel's order, mirrored by ``block_items``).
    ``simt``: a grid of f tiles x E; each block walks its ``passes``.
    """

    variant: str
    E: int
    C: int
    d: int
    f: int
    bm: int  # f columns per tile
    bk: int  # contraction depth per stage
    n: int  # capacity rows per pass (the wgmma N)
    passes: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int

    @property
    def f_tiles(self) -> int:
        return -(-self.f // self.bm)

    @property
    def items(self) -> int:
        return self.E * self.f_tiles * self.passes

    def block_items(self, block: int) -> List[Tuple[int, int, int]]:
        """The (expert, f tile, row pass) items block ``block`` computes."""
        if self.variant == "wgmma":
            ft_p = self.f_tiles * self.passes
            return [(i // ft_p, (i // self.passes) % self.f_tiles, i % self.passes)
                    for i in range(block, self.items, self.grid[0])]
        ft, e = block % self.grid[0], block // self.grid[0]
        return [(e, ft, p) for p in range(self.passes)]


def wgmma_stage_bytes(n: int, bm: int) -> int:
    """One ring stage: a 64-deep weight tile of bm columns and an n x 64 lhs
    tile, bf16."""
    return 2 * WG_BK * (bm + n)


def check_plan(plan: GmmPlan) -> None:
    """Raise ValueError for a plan the kernel does not take."""
    _build.check_plan("grouped_matmul", plan.variant, plan.smem_bytes, plan.n)
    if plan.variant == "wgmma":
        need = 1024 + plan.stages * (wgmma_stage_bytes(plan.n, plan.bm) + 16)
        if plan.n not in WGMMA_N or plan.bm not in WGMMA_BM or plan.bk != WG_BK:
            raise ValueError(f"grouped_matmul: no wgmma kernel for N={plan.n}, tile {plan.bm}x{plan.bk}")
        if plan.stages < 2 or plan.smem_bytes < need:
            raise ValueError(f"grouped_matmul: {plan.stages} stages need {need} B, plan gives {plan.smem_bytes}")
        if plan.grid[1] != 1 or not 1 <= plan.grid[0] <= plan.items:
            raise ValueError(f"grouped_matmul: persistent grid {plan.grid} for {plan.items} items")
    else:
        if plan.n not in SIMT_ROWS or (plan.bm, plan.bk) != (SIMT_BM, SIMT_BK) or plan.smem_bytes:
            raise ValueError(f"grouped_matmul: no simt kernel for N={plan.n}, tile {plan.bm}x{plan.bk}")
        if plan.grid != (plan.f_tiles, plan.E) or plan.E > 65535:
            raise ValueError(f"grouped_matmul: simt grid {plan.grid} for {plan.f_tiles} f tiles x E={plan.E}")
    if plan.passes * plan.n < plan.C:
        raise ValueError(f"grouped_matmul: {plan.passes} passes of {plan.n} rows do not cover C={plan.C}")


def wgmma_plan(E: int, C: int, d: int, f: int, n: int, bm: int, max_stages: int, num_sms: int) -> GmmPlan:
    """A wgmma plan with N = n, bm f columns per item and as many stages (up
    to ``max_stages``) as shared memory holds; one persistent block per SM."""
    passes = -(-C // n)
    stage = wgmma_stage_bytes(n, bm) + 16  # the tiles and the stage's two mbarriers
    stages = min(max_stages, (_build.SMEM_MAX - 1024) // stage)
    items = E * -(-f // bm) * passes
    return GmmPlan("wgmma", E, C, d, f, bm, WG_BK, n, passes, stages, (min(items, num_sms), 1), 1024 + stages * stage)


@functools.lru_cache(maxsize=1024)
def gmm_plan(E: int, C: int, d: int, f: int, dtype: torch.dtype, aligned: bool = True, num_sms: int = 132) -> GmmPlan:
    """The launch plan for (E, C, d) x (E, d, f) in ``dtype`` on a card with
    ``num_sms`` SMs; ``aligned``: both operands start 16-byte aligned."""
    if min(E, C, d, f) < 1:
        raise ValueError(f"grouped_matmul: no plan for an empty product E={E} C={C} d={d} f={f}")
    if dtype == torch.bfloat16 and aligned and d % 8 == 0 and f % 8 == 0:
        n = next(w for w in WGMMA_N if w >= min(-(-C // 8) * 8, WGMMA_N[-1]))
        plan = wgmma_plan(E, C, d, f, n, 128 if f > 64 else 64, WG_STAGES, num_sms)
    else:
        n = next(r for r in SIMT_ROWS if r >= min(C, SIMT_ROWS[-1]))
        plan = GmmPlan("simt", E, C, d, f, SIMT_BM, SIMT_BK, n, -(-C // n), 1, (-(-f // SIMT_BM), E), 0)
    check_plan(plan)
    return plan


def work(E: int, C: int, d: int, f: int, element_size: int) -> Tuple[int, int]:
    """(FLOPs, HBM bytes) of one (E, C, d) x (E, d, f) call: both operands
    read once, the output written once."""
    return 2 * E * C * d * f, element_size * (E * C * d + E * d * f + E * C * f)


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f): float32 products and sums, output
    in the lhs dtype (the kernel's arithmetic)."""
    return torch.bmm(lhs.float(), rhs.float()).to(lhs.dtype)


def _check(lhs: torch.Tensor, rhs: torch.Tensor) -> None:
    if lhs.ndim != 3 or rhs.ndim != 3:
        raise ValueError(f"grouped_matmul takes (E, C, d) x (E, d, f), got {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    if lhs.shape[0] != rhs.shape[0] or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul shapes do not chain: {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    if lhs.dtype != rhs.dtype:
        raise ValueError(f"grouped_matmul needs one dtype, got {lhs.dtype} and {rhs.dtype}")
    _build.dtype_code(lhs.dtype)
    if lhs.device != rhs.device:
        raise ValueError(f"grouped_matmul operands on {lhs.device} and {rhs.device}")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_matmul needs contiguous operands")
    if max(lhs.numel(), rhs.numel(), lhs.shape[0] * lhs.shape[1] * rhs.shape[2]) > _INT_MAX:
        raise ValueError("grouped_matmul operand too large for 32-bit sizes")
    if lhs.shape[0] > 65535:
        raise ValueError(f"grouped_matmul launches one block row per expert: E={lhs.shape[0]} > 65535")


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f) with float32 accumulation."""
    _check(lhs, rhs)
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs)
    E, C, d = lhs.shape
    f = rhs.shape[2]
    out = torch.empty((E, C, f), dtype=lhs.dtype, device=lhs.device)
    if _build.is_fake(lhs):
        _build.count_traced("grouped_matmul", (E, C, d, f), *work(E, C, d, f, lhs.element_size()))
        return out
    if out.numel() == 0:
        return out
    lp, rp = lhs.data_ptr(), rhs.data_ptr()
    plan = gmm_plan(E, C, d, f, lhs.dtype, (lp | rp) % 16 == 0, _build.num_sms(lhs.device.index or 0))
    return _launch(lp, rp, out, plan)


def _launch(lp: int, rp: int, out: torch.Tensor, plan: GmmPlan) -> torch.Tensor:
    """Launch the kernel by ``plan`` on the checked CUDA operands at ``lp``
    (lhs) and ``rp`` (rhs) into ``out``; count it."""
    lib = _build.library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        status = lib.grouped_matmul_launch(
            lp, rp, out.data_ptr(), _build.dtype_code(out.dtype), plan.E, plan.C, plan.d, plan.f,
            int(plan.variant == "wgmma"), plan.bm, plan.bk, plan.n, plan.stages, plan.grid[0], plan.smem_bytes,
            stream,
        )
    _build.check(status, "grouped_matmul")
    _build.count_launch("grouped_matmul", plan.variant, (plan.E, plan.C, plan.d, plan.f))
    return out
