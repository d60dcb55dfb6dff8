"""Fused paged append + decode attention: the decode kernel.

``paged_attention`` launches the hand-written Hopper kernel in
``csrc/paged_attention.cu`` (the port of
``repro/kernels/paged_attention.py::paged_attention``) on CUDA tensors, and
on CPU tensors, and only there, runs its plain PyTorch version
``paged_attention_plain``. The pages are updated in place (the TPU kernel
aliased its page outputs to its page inputs for the same effect).

The block-table ids are the caller's contract: each must name a page of
the pool. The serving path builds them itself (an identity table for a
contiguous cache), so the wrapper does not read them back from the card.

On the card the launch follows a ``DecodePlan`` made here, before the
launch, from the shapes, the dtype and the operands' alignment alone
(``decode_plan``; the prefix kernel's wrapper uses it too): variant
``split`` (bfloat16, a head dim the split kernels are built for
(``SPLIT_HDS``: the multiples of 16 up to 128, and 256), 16-byte aligned
operands:
the key walk split over blocks in 64-key splits, tensor-core products, a
float32 workspace of per-split partials merged by a combine kernel in the
same call) or ``simt`` (float32, and the other bfloat16 cases). Each call
adds one to ``_build.LAUNCH_COUNTS["paged_attention"]`` and one to
``_build.VARIANT_COUNTS[("paged_attention", variant)]``, whether its
variant launches one kernel or two. On fake tensors (the dry run) it
returns a fake output, the pages as they are (a fake tensor holds no
values to write), and tallies ``work``; nothing is built or launched.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .flash_attention import simt_smem_bytes
from .ref import NEG_INF, softcap_ref

HD_MAX = 256
SPLIT_HDS = (16, 32, 48, 64, 80, 96, 112, 128, 256)  # the split kernels' instances (REPRO_DEC_HD_SWITCH)
VARIANTS = ("split", "simt")
SPLIT_KEYS = 64  # keys per split (dec::SPLIT in csrc/decode.cuh)
SPLIT_ROWS = 16  # query rows per tile: the M of mma.m16n8k16 (dec::ROWS)
SIMT_ROWS = 64  # query rows per block of the simt bodies (ATT_ROWS in csrc/common.cuh)
PFX_SIMT_INTS = 5 * SIMT_ROWS + 3  # the simt prefix kernel's extra ints (PFX_INTS)
GRID_YZ_MAX = 65535
_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one paged (``prefix`` False) or prefix-paged call launches.

    ``split``: grid (x, Hkv, B) with x = ``n_splits`` x units; block x is
    split ``x % n_splits`` of unit ``x // n_splits``. Paged: the units are
    the ``n_tiles`` row tiles of the row's C*G query rows. Prefix: the
    ``n_gtiles`` tiles of the B*C*G rows (the largest group there can be);
    on the card unit u of row z is group tile u of z's group when z is a
    representative and the split lies below its position, else z's row
    tile u. Blocks with nothing to read exit at once: the grid is the most
    the data could need, since the positions stay on the card. Then
    ``combine_blocks`` blocks of 4 warps merge the partials.
    ``simt``: grid (Hkv, B, row chunks of 64), the whole key walk per block.
    """

    variant: str
    prefix: bool
    B: int
    C: int
    Hq: int
    Hkv: int
    hd: int
    bs: int
    n_blocks: int
    s_split: int  # keys per split (split); the whole walk (simt): 0
    row_tile: int
    n_tiles: int
    n_gtiles: int
    n_splits: int
    grid: Tuple[int, int, int]
    smem_bytes: int
    workspace_floats: int
    combine_blocks: int

    @property
    def rows(self) -> int:
        """Query rows per (batch row, KV head): C * G."""
        return self.C * (self.Hq // self.Hkv)

    @property
    def grid_x(self) -> int:
        """The launch argument the C entry checks: the grid's x for split,
        the row chunks (grid z) for simt."""
        return self.grid[0] if self.variant == "split" else self.grid[2]

    @property
    def items(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def block_items(self, block: int) -> Tuple[Tuple[str, int, int, int, int], ...]:
        """The (kind, KV head, batch row, tile, split) items block ``block``
        may compute (x fastest): kind ``own`` (a row tile of that row) or
        ``shared`` (a group tile of the group that row represents); which of
        the two a prefix block takes is decided on the card from the data."""
        gx, gy, _ = self.grid
        x, y, z = block % gx, (block // gx) % gy, block // (gx * gy)
        if self.variant == "simt":
            return (("own", x, y, z, 0),)
        unit, s = divmod(x, self.n_splits)
        items = (("own", y, z, unit, s),) if unit < self.n_tiles else ()
        return items + ((("shared", y, z, unit, s),) if unit < self.n_gtiles else ())


def split_smem_bytes(hd: int, prefix: bool = False) -> int:
    """``dec::Layout<hd>::BYTES`` of ``csrc/decode.cuh``: bf16 Q (16 rows),
    K and V (64 keys) tiles and P (16 x 64), each row padded by 8 elements;
    float row maxima and sums per warp; the tile's row table (320 bytes);
    the prefix kernel's group scan (68 bytes) after it."""
    tiles = 2 * (SPLIT_ROWS + 2 * SPLIT_KEYS) * (hd + 8) + 2 * SPLIT_ROWS * (SPLIT_KEYS + 8)
    return tiles + 2 * 4 * 4 * SPLIT_ROWS + 320 + (68 if prefix else 0)


def check_plan(plan: DecodePlan) -> None:
    """Raise ValueError for a plan the kernels do not take."""
    kernel = "prefix_paged_attention" if plan.prefix else "paged_attention"
    _build.check_plan(kernel, plan.variant, plan.smem_bytes, variants=VARIANTS)
    rows = plan.rows
    width = plan.n_blocks * plan.bs
    if plan.variant == "split":
        n_splits = -(-width // SPLIT_KEYS)
        n_tiles = -(-rows // SPLIT_ROWS)
        n_gtiles = -(-plan.B * rows // SPLIT_ROWS) if plan.prefix else 0
        if plan.hd not in SPLIT_HDS or (plan.s_split, plan.row_tile) != (SPLIT_KEYS, SPLIT_ROWS):
            raise ValueError(f"{kernel}: no split kernel for hd={plan.hd}, {plan.s_split} keys x {plan.row_tile} rows")
        if (plan.n_splits, plan.n_tiles, plan.n_gtiles) != (n_splits, n_tiles, n_gtiles):
            raise ValueError(f"{kernel}: {plan.n_splits} splits x {plan.n_tiles}+{plan.n_gtiles} tiles do not cover "
                             f"{width} keys x {rows} rows (B={plan.B})")
        if plan.grid != (n_splits * max(n_tiles, n_gtiles), plan.Hkv, plan.B):
            raise ValueError(f"{kernel}: grid {plan.grid} is not (splits x tiles, Hkv, B)")
        if plan.smem_bytes != split_smem_bytes(plan.hd, plan.prefix):
            raise ValueError(f"{kernel}: split plan gives {plan.smem_bytes} B, the kernel takes "
                             f"{split_smem_bytes(plan.hd, plan.prefix)}")
        total = plan.B * plan.Hkv * rows
        if plan.workspace_floats != total * n_splits * (plan.hd + 2) or plan.combine_blocks != -(-total // 4):
            raise ValueError(f"{kernel}: workspace {plan.workspace_floats} floats / {plan.combine_blocks} combine "
                             f"blocks for {total} rows x {n_splits} splits")
        if plan.grid[0] > _INT_MAX or plan.combine_blocks > _INT_MAX:
            raise ValueError(f"{kernel}: grid {plan.grid} exceeds 2^31-1 blocks in x")
    else:
        chunks = -(-(plan.B * rows if plan.prefix else rows) // SIMT_ROWS)
        smem = simt_smem_bytes(plan.hd) + (4 * PFX_SIMT_INTS if plan.prefix else 0)
        if (plan.grid != (plan.Hkv, plan.B, chunks) or (plan.n_tiles, plan.n_gtiles) != (chunks, 0)
                or plan.row_tile != SIMT_ROWS or plan.s_split):
            raise ValueError(f"{kernel}: simt grid {plan.grid} is not (Hkv, B, {chunks} row chunks)")
        if plan.smem_bytes != smem or plan.workspace_floats or plan.combine_blocks or plan.n_splits != 1:
            raise ValueError(f"{kernel}: simt plan gives {plan.smem_bytes} B and {plan.workspace_floats} "
                             f"workspace floats, the kernel takes {smem} and none")
    if max(plan.grid[1], plan.grid[2]) > GRID_YZ_MAX:
        raise ValueError(f"{kernel}: grid {plan.grid} exceeds {GRID_YZ_MAX} blocks in y or z")


@functools.lru_cache(maxsize=1024)
def decode_plan(
    B: int, C: int, Hq: int, Hkv: int, hd: int, bs: int, n_blocks: int, dtype: torch.dtype,
    prefix: bool = False, aligned: bool = True,
) -> DecodePlan:
    """The launch plan for B rows of C chunk tokens, Hq query heads over Hkv
    KV heads of ``hd`` dims, a table of ``n_blocks`` pages of ``bs`` slots,
    in ``dtype``; ``prefix`` for the prefix kernel; ``aligned``: every
    operand starts on a 16-byte boundary (the split variant's vector loads)."""
    G = Hq // Hkv
    rows = C * G
    if dtype == torch.bfloat16 and aligned and hd in SPLIT_HDS:
        n_splits = -(-(n_blocks * bs) // SPLIT_KEYS)
        n_tiles = -(-rows // SPLIT_ROWS)
        n_gtiles = -(-B * rows // SPLIT_ROWS) if prefix else 0
        total = B * Hkv * rows
        plan = DecodePlan(
            "split", prefix, B, C, Hq, Hkv, hd, bs, n_blocks, SPLIT_KEYS, SPLIT_ROWS, n_tiles, n_gtiles, n_splits,
            (n_splits * max(n_tiles, n_gtiles), Hkv, B), split_smem_bytes(hd, prefix),
            total * n_splits * (hd + 2), -(-total // 4),
        )
    else:
        chunks = -(-(B * rows if prefix else rows) // SIMT_ROWS)
        smem = simt_smem_bytes(hd) + (4 * PFX_SIMT_INTS if prefix else 0)
        plan = DecodePlan("simt", prefix, B, C, Hq, Hkv, hd, bs, n_blocks, 0, SIMT_ROWS, chunks, 0, 1,
                          (Hkv, B, chunks), smem, 0, 0)
    check_plan(plan)
    return plan


# The split variant's float32 workspace for the partials, cached per device
# and power-of-two size. Calls on one device share it, so they are ordered
# on one stream at a time (the engine issues every attention call on its
# serving stream).
_WORKSPACES: Dict[Tuple[int, int], torch.Tensor] = {}


def workspace(device: torch.device, floats: int) -> Optional[int]:
    """A pointer to a cached float32 buffer of at least ``floats`` elements
    on ``device`` (None for 0)."""
    if floats == 0:
        return None
    size = 1 << (floats - 1).bit_length()
    key = (device.index if device.index is not None else torch.cuda.current_device(), size)
    buf = _WORKSPACES.get(key)
    if buf is None:
        buf = _WORKSPACES[key] = torch.empty(size, dtype=torch.float32, device=device)
    return buf.data_ptr()


def work(B: int, C: int, Hq: int, Hkv: int, hd: int, keys: int, element_size: int, window: int = 0,
         is_global=True) -> Tuple[int, int]:
    """(FLOPs, HBM bytes) of one call over a table of ``keys`` positions, the
    cache taken full (every row's chunk at the table's last C positions: a
    fake tensor holds no positions, and the dry run's decode shapes are a
    step at a cache of that length): q, k_new, v_new and out once, each
    row's cached keys (within the window) read once, the chunk's K/V
    written once; 4 flops per (query, valid key, dim)."""
    if window > 0 and not bool(is_global):
        keys = min(keys, window)
    flops = 4 * hd * Hq * B * C * keys
    return flops, element_size * (2 * B * C * Hq * hd + 2 * B * keys * Hkv * hd + 4 * B * C * Hkv * hd)


def aligned(*tensors: torch.Tensor) -> bool:
    """Every operand starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def paged_attention_plain(
    q, k_pages, v_pages, block_tables, k_new, v_new, pos, is_global=True, *, scale=None, softcap=0.0, window=0
):
    """The kernel's contract in plain PyTorch, float32 throughout.

    Chunk token c of row b is written at logical position pos[b] + c
    through the row's table (positions past the table width are dropped),
    then every query attends causally over the row's logical view.
    """
    B, C, Hq, hd = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    n_blocks = block_tables.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = hd**-0.5
    tables = block_tables.long()
    tpos = pos.long()[:, None] + torch.arange(C, device=q.device)  # (B, C)
    live = (tpos >= 0) & (tpos < n_blocks * bs)
    phys = torch.gather(tables, 1, (tpos // bs).clamp(0, n_blocks - 1))
    rows, toks = live.nonzero(as_tuple=True)
    k_pages[phys[live], (tpos % bs)[live]] = k_new[rows, toks].to(k_pages.dtype)
    v_pages[phys[live], (tpos % bs)[live]] = v_new[rows, toks].to(v_pages.dtype)
    k = k_pages[tables].reshape(B, n_blocks * bs, Hkv, hd).float()
    v = v_pages[tables].reshape(B, n_blocks * bs, Hkv, hd).float()
    qg = q.reshape(B, C, Hkv, G, hd).float()
    logits = torch.einsum("bckgd,bskd->bkgcs", qg, k) * scale
    if softcap > 0:
        logits = softcap_ref(logits, softcap)
    kpos = torch.arange(n_blocks * bs, device=q.device)
    ok = kpos <= tpos[:, :, None]  # (B, C, S)
    if window > 0 and not bool(is_global):
        ok &= (tpos[:, :, None] - kpos) < window
    logits = torch.where(ok[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", p, v).reshape(B, C, Hq, hd)
    return out.to(q.dtype), k_pages, v_pages


def _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, window) -> None:
    if q.ndim != 4 or k_pages.ndim != 4:
        raise ValueError(
            f"paged_attention takes q (B, C, Hq, hd) and pages (N, bs, Hkv, hd); got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}"
        )
    B, C, Hq, hd = q.shape
    N, bs, Hkv, hd_p = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_p != hd:
        raise ValueError(f"page shapes {tuple(k_pages.shape)}, {tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if k_new.shape != (B, C, Hkv, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"k_new/v_new must be {(B, C, Hkv, hd)}, got {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs q heads ({Hq}) to divide over kv heads ({Hkv})")
    if not 0 < hd <= HD_MAX:
        raise ValueError(f"paged_attention supports head_dim 1..{HD_MAX}, got {hd}")
    if block_tables.ndim != 2 or block_tables.shape[0] != B or block_tables.shape[1] == 0:
        raise ValueError(f"block_tables must be (B={B}, max_blocks >= 1), got {tuple(block_tables.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be a (B,) vector (broadcast scalars), got {tuple(pos.shape)}")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"block_tables and pos must be int32, got {block_tables.dtype}, {pos.dtype}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype == k_new.dtype == v_new.dtype):
        raise ValueError("paged_attention needs q, pages and new K/V in one dtype")
    _build.dtype_code(q.dtype)
    tensors = (q, k_pages, v_pages, block_tables, k_new, v_new, pos)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention operands lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous operands")
    if max(t.numel() for t in tensors) > 2**31 - 1 or block_tables.shape[1] * bs > 2**31 - 1:
        raise ValueError("paged_attention operand too large for 32-bit sizes")
    if B > 65535:
        raise ValueError(f"paged_attention launches one block row per batch row: B={B} > 65535")


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: torch.Tensor,
    is_global=True,
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    window: int = 0,
):
    """Fused paged append + decode attention.

    q: (B, C, Hq, hd) rope'd queries; k_pages/v_pages: (N, bs, Hkv, hd)
    shared physical pages; block_tables: (B, max_blocks) int32; k_new/v_new:
    (B, C, Hkv, hd) rope'd chunk K/V; pos: (B,) int32 write positions;
    ``is_global`` (a bool) switches the sliding window off. Returns
    ``(out (B, C, Hq, hd), k_pages, v_pages)``, the pages updated in place.
    """
    _check(q, k_pages, v_pages, block_tables, k_new, v_new, pos, window)
    B, C, Hq, hd = q.shape
    bs, Hkv = k_pages.shape[1], k_pages.shape[2]
    if scale is None:
        scale = hd**-0.5
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, k_new, v_new, pos, is_global,
            scale=scale, softcap=softcap, window=window,
        )
    out = torch.empty_like(q)
    if _build.is_fake(q):
        _build.count_traced("paged_attention", (B, C, Hq, Hkv, hd),
                            *work(B, C, Hq, Hkv, hd, block_tables.shape[1] * bs, q.element_size(), window, is_global))
        return out, k_pages, v_pages
    if out.numel() == 0:
        return out, k_pages, v_pages
    plan = decode_plan(B, C, Hq, Hkv, hd, bs, block_tables.shape[1], q.dtype, False,
                       aligned(q, k_pages, v_pages, k_new, v_new))
    lib = _build.library()
    with torch.cuda.device(q.device):
        ws = workspace(q.device, plan.workspace_floats)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), out.data_ptr(), _build.dtype_code(q.dtype),
            B, C, Hq, Hkv, hd, bs, block_tables.shape[1], 0 if bool(is_global) else int(window),
            float(softcap), float(scale), int(plan.variant == "split"), plan.grid_x, plan.smem_bytes, ws,
            stream,
        )
    _build.check(status, "paged_attention")
    _build.count_launch("paged_attention", plan.variant, (B, C, Hq, Hkv, hd))
    return out, k_pages, v_pages
