"""Dispatch over the hand-written Hopper kernels: the kernel-backend seam.

Every hot spot with a kernel is reached through one of these functions,
selected by a ``KernelBackend``:

- ``hopper`` launches the CUDA C++ kernels (``csrc/``) for sm_90a,
- ``ref`` serves the plain PyTorch oracles in ``repro_torch.kernels.ref``.

Selection mirrors ``repro.kernels.ops``: an explicit ``backend=``
argument, then the ``REPRO_TORCH_KERNEL_BACKEND`` environment variable,
then the device of the tensors: a CUDA tensor resolves to ``hopper``, a
CPU tensor to ``ref``. There is no silent fallback. ``hopper`` on a CPU
tensor raises, and so does a CUDA card other than compute capability 9.0.
``ref`` runs on a CUDA tensor only when a caller asks for it explicitly;
nothing on the serving path does.

``LAUNCH_COUNTS`` counts real kernel launches by kernel name (the wrappers
bump it where they launch). ``DISPATCH_COUNTS`` counts which branch each
call took, ``*.hopper`` or ``*.ref``, so a run can show that no ``ref`` op
served it. Both live in ``_build`` and are updated under a lock: the async
INT4 restore dispatches from a worker thread. While a step is captured into
a CUDA graph its thread's counts are recorded, not added, and every replay
adds the recorded counts (``repro_torch.serving.step_cache``).

On fake CUDA tensors (``FakeTensorMode``, the dry run of
``repro_torch.launch.dryrun``) each wrapper applies its checks, returns
fake outputs of the shapes and dtypes its kernel writes, and adds its
FLOPs and HBM bytes to ``_build``'s ``TRACED_*`` tally; nothing is built
or launched, and ``LAUNCH_COUNTS`` is left alone. This is no fallback: a
fake tensor has no data to compute on.

The expert matmul also takes the INT4 formats (``QuantizedWeight``, the
flat transition wire format, and ``QuantizedExpert``, the structured
resident format): the weight is dequantized by ``int4_dequant`` into one
transient dense buffer, then multiplied by the grouped-matmul kernel.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple, Union

import torch

from repro_torch.sharding import autograd as sharding_autograd

from . import _build, ref
from ._build import DISPATCH_COUNTS, LAUNCH_COUNTS  # noqa: F401 (re-export)
from .flash_attention import flash_attention as _flash_hopper
from .grouped_matmul import grouped_matmul as _gmm_hopper
from .int4_dequant import int4_dequant as _dequant_hopper
from .paged_attention import paged_attention as _paged_hopper
from .prefix_paged_attention import prefix_paged_attention as _prefix_hopper


class KernelBackend(str, enum.Enum):
    """Which implementation a kernel dispatch executes."""

    REF = "ref"
    HOPPER = "hopper"


BACKEND_ENV = "REPRO_TORCH_KERNEL_BACKEND"

BackendSpec = Union[KernelBackend, str, None]

record = _build.count_dispatch


def reset_counts() -> None:
    """Zero ``DISPATCH_COUNTS``, ``LAUNCH_COUNTS``, ``VARIANT_COUNTS`` and
    ``SHAPE_COUNTS``."""
    _build.reset_launch_counts()


def default_backend(device) -> KernelBackend:
    """``hopper`` for a CUDA device, ``ref`` for the CPU."""
    return KernelBackend.HOPPER if torch.device(device).type == "cuda" else KernelBackend.REF


def resolve_backend(backend: BackendSpec = None, device="cpu") -> KernelBackend:
    """Normalize a backend spec for tensors on ``device``:
    None/"auto" -> environment variable -> device. Raises where the
    choice cannot run: ``hopper`` off CUDA, or on a card that is not sm_90.
    Under a ``FakeTensorMode`` (the dry run) no card is asked: its target
    is the H100, and the wrappers launch nothing on fake tensors."""
    if backend is None or backend == "auto":
        backend = os.environ.get(BACKEND_ENV) or default_backend(device)
    be = KernelBackend(backend)
    if be is KernelBackend.HOPPER:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"the hopper backend runs on CUDA tensors, got a {device.type} tensor; "
                "use backend='ref' on the CPU"
            )
        if _build.faking():  # a dry run's fake CUDA tensors: the target is the H100
            return be
        cap = torch.cuda.get_device_capability(device)
        if cap != (9, 0):
            raise RuntimeError(
                f"the hopper kernels are built for sm_90a (H100/H200); "
                f"{torch.cuda.get_device_name(device)} has compute capability {cap}"
            )
    return be


def attention(
    q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
    scale: Optional[float] = None, backend: BackendSpec = None,
) -> torch.Tensor:
    """(B, Hq, Sq, hd) x (B, Hkv, Sk, hd)^2 -> (B, Hq, Sq, hd)."""
    if resolve_backend(backend, q.device) is KernelBackend.HOPPER:
        record("attention.hopper")
        return _flash_hopper(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)
    record("attention.ref")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def flash_attention(
    q, k, v, *, is_global=True, window: int = 0, softcap: float = 0.0,
    scale: Optional[float] = None, backend: BackendSpec = None,
) -> torch.Tensor:
    """Causal full-sequence (prefill) attention in MODEL layout.

    q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd) -> (B, S, Hq, hd). ``window``
    applies only when ``is_global`` is false; the TPU seam chose with
    ``lax.cond`` on a traced flag, here it is a host-side branch.
    """
    B, S, Hq, hd = q.shape
    if resolve_backend(backend, q.device) is not KernelBackend.HOPPER:
        record("flash.ref")
        pos = torch.arange(S, dtype=torch.int32, device=q.device)
        return ref.decode_attend_ref(
            q, k, v, pos, pos, scale=hd**-0.5 if scale is None else scale,
            softcap=softcap, window=window, is_global=is_global,
        )
    record("flash.hopper")
    win = 0 if window <= 0 or bool(is_global) else window
    out = _flash_hopper(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=win, softcap=softcap, scale=scale,
    )
    return out.transpose(1, 2)  # the kernel wrote a (B, S, Hq, hd) buffer


def decode_attention(
    q, k_cache, v_cache, k_new, v_new, pos, *, block_tables=None, prefix_groups=None,
    scale: Optional[float] = None, softcap: float = 0.0, window: int = 0,
    is_global=True, trash_block: int = 0, backend: BackendSpec = None,
):
    """One cache-appending decode/chunk attention step, either layout.

    q: (B, C, Hq, hd) rope'd queries; k_new/v_new: (B, C, Hkv, hd) the
    chunk's rope'd K/V; ``pos`` an int, a scalar tensor (lockstep) or a
    (B,) tensor of write positions. ``block_tables`` None means contiguous
    ``(B, Smax, Hkv, hd)`` caches, sent to the paged kernel as one page per
    row behind the identity table; otherwise shared ``(N, bs, Hkv, hd)``
    pages addressed through the ``(B, max_blocks)`` table. The caches are
    updated in place. Returns ``(out, k_cache, v_cache)``.

    ``prefix_groups`` (paged only) is the prefix cache's ``(2, B)`` int32
    grouping: row 0 each row's group representative, row 1 its shared
    leading block count (DESIGN.md §4d). It routes to the prefix kernel,
    which reads each shared page once per group; the result is exactly the
    unshared one.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    if pos.ndim > 1:
        raise ValueError(f"pos must be a scalar or (B,) vector, got {tuple(pos.shape)}")
    B, C = q.shape[0], q.shape[1]
    if block_tables is None and C > 1 and pos.ndim != 0:
        raise ValueError(
            f"contiguous multi-token append is lockstep-only: a C={C} chunk needs a "
            f"scalar pos, got shape {tuple(pos.shape)}; pass block_tables for per-row chunks"
        )
    if prefix_groups is not None and block_tables is None:
        raise ValueError("prefix_groups requires a paged cache (block_tables)")
    if resolve_backend(backend, q.device) is KernelBackend.HOPPER:
        posv = torch.broadcast_to(pos.reshape(-1), (B,)).contiguous()
        if prefix_groups is not None:
            record("decode.hopper_prefix")
            return _prefix_hopper(
                q, k_cache, v_cache, block_tables, k_new, v_new, posv, prefix_groups[0], prefix_groups[1],
                is_global, scale=scale, softcap=softcap, window=window,
            )
        record("decode.hopper")
        tables = (
            torch.arange(B, dtype=torch.int32, device=q.device)[:, None]  # one page per row
            if block_tables is None
            else block_tables
        )
        return _paged_hopper(
            q, k_cache, v_cache, tables, k_new, v_new, posv, is_global,
            scale=scale, softcap=softcap, window=window,
        )
    if prefix_groups is not None:
        record("decode.ref_prefix")
        return ref.prefix_paged_attention_ref(
            q, k_cache, v_cache, block_tables, k_new, v_new, pos, prefix_groups[0], prefix_groups[1],
            is_global, scale=scale, softcap=softcap, window=window, trash_block=trash_block,
        )
    if block_tables is not None:
        record("decode.ref_paged")
        return ref.paged_attention_ref(
            q, k_cache, v_cache, block_tables, k_new, v_new, pos, is_global,
            scale=scale, softcap=softcap, window=window, trash_block=trash_block,
        )
    record("decode.ref_append")
    return ref.append_attention_ref(
        q, k_cache, v_cache, k_new, v_new, pos, is_global, scale=scale, softcap=softcap, window=window
    )


def seq_decode_attention(
    q, k_cache, v_cache, k_new, v_new, pos, mesh, *, scale: Optional[float] = None, softcap: float = 0.0,
    window: int = 0, is_global=True, shard=None,
):
    """``decode_attention`` over a contiguous cache whose positions are
    sharded over the ranks of ``mesh`` (the ``seq`` layout): this rank
    holds (B, P, Hkv, hd) of every kv head, global positions rank*P ..
    rank*P + P - 1. The rank that holds a new entry writes it; every rank
    computes the partial softmax of every q head of ``q`` (B, C, Hq, hd)
    over its own valid keys; one all-gather of the partials and a
    log-sum-exp merge give every rank the whole output (B, C, Hq, hd).

    The reference routes this layout to its plain path (its
    ``decode_kernel_axes`` is None unless the cache is heads-sharded), and
    so does the port: the plain version runs per rank on any device,
    counted as ``decode.ref_seq``, whatever the backend. ``shard`` (this
    rank's index, the number of shards; ``specs.seq_shards``) defaults to
    the model axis's; more shards than the model axis has (``seq_all`` on a
    mesh with a data axis) spread over every rank of the mesh."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    record("decode.ref_seq")
    index, n = shard or (mesh.rank, mesh.size)
    o, m, s = ref.seq_append_attention_partial_ref(
        q, k_cache, v_cache, k_new, v_new, pos, index, n, is_global,
        scale=scale, softcap=softcap, window=window,
    )
    axis = "model" if n == mesh.size else tuple(mesh.axis_names)
    parts = mesh.all_gather(torch.cat([o, m[..., None], s[..., None]], dim=-1)[None], dim=0, axis=axis)
    hd = q.shape[-1]
    return ref.merge_partials_ref(parts[..., :hd], parts[..., hd], parts[..., hd + 1]).to(q.dtype), k_cache, v_cache


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """A per-group INT4 weight in the flat transition format of
    ``repro_torch.core.quantization`` (two nibbles per uint8, low nibble
    first, per-group float32 scale and zero). ``shape`` is the unpacked
    (E, d, f) the matmul sees."""

    packed: torch.Tensor  # (G, gs // 2) uint8
    scales: torch.Tensor  # (G, 1) float32
    zeros: torch.Tensor  # (G, 1) float32
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class QuantizedExpert:
    """Resident INT4 expert weight: the same nibble packing, with the groups
    tiling the LAST weight dim and the leading dims kept explicit:

        packed (*lead, n_groups, gs // 2) uint8
        scales (*lead, n_groups, 1) float32
        zeros  (*lead, n_groups, 1) float32

    The unpacked shape is derived from the leaves, and indexing slices the
    leading dims of all three, so ``models.params.layer_slice`` takes one
    layer of a stacked (L, E, d, f) leaf as it takes a dense one.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: torch.Tensor

    @property
    def group_size(self) -> int:
        return 2 * self.packed.shape[-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        lead = tuple(self.packed.shape[:-2])
        return lead + (self.packed.shape[-2] * self.group_size,)

    @property
    def ndim(self) -> int:
        return self.packed.ndim - 1

    @property
    def nbytes(self) -> int:
        return self.packed.nbytes + self.scales.nbytes + self.zeros.nbytes

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def __getitem__(self, idx) -> "QuantizedExpert":
        return QuantizedExpert(self.packed[idx], self.scales[idx], self.zeros[idx])


def quantize_weight(w: torch.Tensor, group_size: Optional[int] = None) -> QuantizedExpert:
    """Quantize a dense weight into a resident ``QuantizedExpert`` on its
    own device; groups tile the last dim (``pick_group_size`` when not
    given). Bit-equal to the reference's host quantization."""
    from repro_torch.core.quantization import quantize_int4_lastdim_torch

    qt = quantize_int4_lastdim_torch(w, group_size)
    return QuantizedExpert(packed=qt.packed, scales=qt.scales, zeros=qt.zeros)


def int4_dequant(packed, scales, zeros, *, out_dtype=torch.bfloat16, backend: BackendSpec = None) -> torch.Tensor:
    """packed (G, gs/2) uint8 + scales/zeros (G, 1) float32 -> (G, gs)."""
    if resolve_backend(backend, packed.device) is KernelBackend.HOPPER:
        record("int4_dequant.hopper")
        return _dequant_hopper(packed, scales, zeros, out_dtype=out_dtype)
    record("int4_dequant.ref")
    return ref.int4_dequant_ref(packed, scales, zeros, out_dtype=out_dtype)


def _dequant_weight(rhs, out_dtype, backend: BackendSpec = None):
    """Materialize a quantized rhs (a dense tensor passes through): the
    structured leaves flatten to the (G, gs/2) slab the dequant takes, and
    the result takes the unpacked shape."""
    if isinstance(rhs, QuantizedExpert):
        half = rhs.packed.shape[-1]
        packed = rhs.packed.reshape(-1, half)
        scales = rhs.scales.reshape(-1, 1)
        zeros = rhs.zeros.reshape(-1, 1)
    elif isinstance(rhs, QuantizedWeight):
        packed, scales, zeros = rhs.packed, rhs.scales, rhs.zeros
    else:
        return rhs
    w = int4_dequant(packed, scales, zeros, out_dtype=out_dtype, backend=backend)
    return w.reshape(rhs.shape)


def grouped_matmul(lhs, rhs, *, shard_axes=None, sharded_dim: str = "out",
                   backend: BackendSpec = None) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f), the expert-FFN seam.

    ``rhs`` may be dense, a ``QuantizedWeight`` or a ``QuantizedExpert``;
    a quantized one is dequantized in the lhs dtype first (on the card one
    ``int4_dequant`` launch per call).

    ``shard_axes`` (a TP plan's ``expert_kernel_axes``, whose ``dim`` is
    the global d_ff) makes the call one rank's part of a Megatron-style
    product, the kernel running on the rank's own d_ff shard:

    - ``sharded_dim="out"``: column-parallel. ``rhs`` holds the rank's
      columns, the output stays sharded there; no collective (wi_gate,
      wi_up).
    - ``sharded_dim="in"``: row-parallel. ``lhs`` and ``rhs`` hold the
      rank's part of the contraction dim; the partial products are summed
      over the ranks with one ``all_reduce`` (wo).

    A resident ``QuantizedExpert`` is the rank's own slice where its group
    axis divides the mesh axis, and each rank dequantizes only that slice.
    Where it does not (DeepSeek's ``wi``: 11 groups of 128 over two ranks)
    the rank holds the whole packed leaf, dequantizes all of it, as the
    reference does, and multiplies its own columns.
    """
    w = _dequant_weight(rhs, lhs.dtype, backend)
    if shard_axes is not None:
        if sharded_dim not in ("out", "in"):
            raise ValueError(f"sharded_dim must be 'out'|'in', got {sharded_dim!r}")
        dim = -1 if sharded_dim == "out" else -2
        n = shard_axes.size
        if n > 1 and w.shape[dim] == shard_axes.dim:  # a whole leaf: its group axis does not divide
            local = shard_axes.dim // n
            w = w.narrow(dim, shard_axes.mesh.rank * local, local).contiguous()
    if resolve_backend(backend, lhs.device) is KernelBackend.HOPPER:
        record("gmm.hopper" if shard_axes is None else f"gmm.hopper_shard_{sharded_dim}")
        out = _gmm_hopper(lhs, w)
    else:
        record("gmm.ref" if shard_axes is None else f"gmm.ref_shard_{sharded_dim}")
        out = ref.grouped_matmul_ref(lhs, w)
    if shard_axes is not None and sharded_dim == "in":
        out = sharding_autograd.reduce_out(out, shard_axes.mesh, shard_axes.axis)
    return out


def a2a_ppermute(x: torch.Tensor, mesh, *, split: int, concat: int) -> torch.Tensor:
    """The tiled all-to-all decomposed into ring hops: bit-identical to
    ``mesh.all_to_all(x, split, concat)``. The split dim is cut into ``n``
    blocks, block ``j`` travels to rank ``j``, and the blocks received land
    on the concat dim in source-rank order. Hop ``r`` sends the block for
    rank ``(me + r) % n`` and receives from rank ``(me - r) % n``; all
    ``n - 1`` hops are posted as one batch of point-to-point ops. Identity
    on a 1-rank mesh."""
    return a2a_ppermute_start(x, mesh, split=split, concat=concat).wait()


def a2a_ppermute_start(x: torch.Tensor, mesh, *, split: int, concat: int):
    """Post ``a2a_ppermute``'s hops and return the pending exchange at
    once; its ``wait()`` completes them and returns the result."""
    n = mesh.size
    if n == 1:
        return mesh.exchange([], [], result=x)
    split, concat = split % x.ndim, concat % x.ndim
    if x.shape[split] % n:
        raise ValueError(f"split dim {x.shape[split]} not divisible by the mesh size {n}")
    me, s, c = mesh.rank, x.shape[split] // n, x.shape[concat]
    shape = list(x.shape)
    shape[split], shape[concat] = s, c * n
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    out.narrow(concat, me * c, c).copy_(x.narrow(split, me * s, s))
    sends, recvs = [], []
    for r in range(1, n):
        sends.append((x.narrow(split, ((me + r) % n) * s, s), (me + r) % n))
        src = (me - r) % n
        recvs.append((out.narrow(concat, src * c, c), src))
    return mesh.exchange(sends, recvs, result=out)


def pipelined_ep_ffn(buf: torch.Tensor, ffn, *, mesh, chunks: int) -> torch.Tensor:
    """The EP exchange and expert FFN, micro-batch pipelined (the EPS-MoE
    schedule, DESIGN.md §4e). ``buf`` is this rank's (E, C, d) dispatch
    buffer; ``ffn`` maps an exchanged (E/n, c*n, d) slab to its expert
    outputs.

    ``chunks`` <= 1 is the serial schedule: one ``all_to_all`` dispatch,
    the FFN, one ``all_to_all`` combine. Otherwise the capacity dim is split
    into K near-equal slabs, each running the same dispatch -> FFN ->
    combine chain through ``a2a_ppermute``, double-buffered: slab i+1's
    dispatch hops are posted BEFORE slab i's FFN, and slab i's combine hops
    overlap slab i+1's FFN. Token-exact with the serial schedule: routing
    and capacity were assigned before the split, the FFN is
    row-independent, and the concat restores the capacity order.
    """
    K = min(max(int(chunks), 1), buf.shape[1])
    if torch.is_grad_enabled() and buf.requires_grad:
        # training: the serial schedule through the differentiable exchange
        # (the same function: the slabs only reorder its work)
        record("moe.ep_serial")
        a2a = sharding_autograd.all_to_all
        return a2a(ffn(a2a(buf, mesh, split=0, concat=1)), mesh, split=1, concat=0)
    if K <= 1:
        record("moe.ep_serial")
        return mesh.all_to_all(ffn(mesh.all_to_all(buf, split=0, concat=1)), split=1, concat=0)
    record(f"moe.ep_pipeline_k{K}")
    if mesh.size > 1:
        record("moe.ep_a2a_ppermute")
    bounds = [(i * buf.shape[1]) // K for i in range(K + 1)]
    slabs = [buf[:, bounds[i]:bounds[i + 1]].contiguous() for i in range(K)]
    combines = []
    inflight = a2a_ppermute_start(slabs[0], mesh, split=0, concat=1)
    for i in range(K):
        # double buffer: slab i+1's dispatch is posted before slab i's FFN
        upnext = a2a_ppermute_start(slabs[i + 1], mesh, split=0, concat=1) if i + 1 < K else None
        combines.append(a2a_ppermute_start(ffn(inflight.wait()), mesh, split=1, concat=0))
        inflight = upnext
    return torch.cat([c.wait() for c in combines], dim=1)
