"""Mamba-1 selective SSM mixer (falcon-mamba, hymba's SSM heads): the port
of ``repro.models.mamba``.

Full sequence: the sequence is cut into chunks carrying the SSM state from
one to the next, with a scan inside each chunk. This bounds the
(B, chunk, d_inner, N) working set; the whole-sequence scan would hold
(B, S, d_inner, N). The reference scans within a chunk with
``lax.associative_scan``; torch has none, so the chunk runs a log-depth
(Hillis-Steele) scan over the pairs (a_bar, b x) in place: log2(chunk)
passes, each one multiply-add over the chunk with one temporary. The
closed form ``exp(cumsum(dt * A))`` is not used: its ratios overflow
float32 inside a 256-step chunk.

The mixer also returns the final (conv window, SSM state), which prime the
decode cache; the reference runs the recurrence a second time for them
(``repro.models.transformer._mamba_final_state``).

Decode: the O(1) recurrent update of the (conv window, SSM state) cache, in
place, since captured decode steps read those buffers. The recurrence is
kept in float32, the conv window in the activations' dtype, as in the
reference.

On a mesh (a ShardingPlan whose leaves hold this rank's d_inner channels,
``models.params.param_pspecs``) the mixer is tensor-parallel over d_inner:
``in_proj`` gives this rank's channels of x and of z, the conv, the scan
and the (conv window, SSM state) are per channel and stay on the rank, and
the two row-parallel products complete with one all-reduce each: ``x_proj``
(dt, B and C, before ``dt_proj`` and the scan) and ``out_proj``. In
training these go through ``repro_torch.sharding.autograd``: the mixer
enters through ``parallel.tp_in``, ``x_proj``'s sum is replicated and then
read by the rank's channels (``copy_in``), and ``out_proj``'s sum leaves
through ``parallel.tp_out`` (a reduce-scatter over the sequence under
``seq_shard_acts``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import autograd as ad

from . import parallel


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, conv_w - 1, d_inner) trailing inputs
    ssm: torch.Tensor  # (B, d_inner, N) state, float32


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, di), w: (cw, di)."""
    cw, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        out = out + pad[:, i : i + S, :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _mesh(p: Dict[str, Any], cfg: ModelConfig, plan):
    """The mesh whose ranks share d_inner, or None (the leaves are whole)."""
    if plan is None or plan.is_null or p["conv_w"].shape[-1] == cfg.ssm_d_inner:
        return None
    return plan.mesh


def _row_parallel(x: torch.Tensor, w: torch.Tensor, mesh, plan=None, sp: bool = False) -> torch.Tensor:
    """x @ w over this rank's rows of ``w``. On a mesh each rank's partial
    product is kept in float32, summed over the ranks (reduce-scattered
    over the sequence under ``sp``) and rounded once to the activations'
    dtype, as the one-device product rounds once: a bf16 partial rounded
    on each rank would part from it by about twice the rounding of a
    batch's row order."""
    if mesh is None:
        return x @ w
    if sp:
        return parallel.tp_out(x.float() @ w.float(), plan, True).to(x.dtype)
    return ad.reduce_out(x.float() @ w.float(), mesh).to(x.dtype)


def _ssm_inputs(x_c: torch.Tensor, p: Dict[str, Any], cfg: ModelConfig, mesh=None):
    """x_c: (B, S, di) -> dt (B,S,di), B_ssm/C_ssm (B,S,N), A (di,N), the
    last four in float32."""
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    proj = _row_parallel(x_c, p["x_proj"], mesh)
    if mesh is not None:  # the whole sum, read by this rank's channels
        proj = ad.copy_in(proj, mesh)
    dt_raw, B_ssm, C_ssm = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_w"]).float() + p["dt_b"].float())
    A = -torch.exp(p["A_log"].float())
    return dt, B_ssm.float(), C_ssm.float(), A


def _scan_chunk(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """The recurrence h_t = a_t * h_{t-1} + b_t over one chunk, from h0.

    a, b: (B, cs, di, N) float32, both overwritten (a with the running
    products, b with the states); h0: (B, di, N). Returns b, now every
    step's state h_t. After the pass at offset d, (a_t, b_t) compose steps
    t-2d+1 .. t, so log2(cs) passes compose each step with all before it;
    each pass computes its update into one temporary before it writes.

    Under autograd (training) the same passes run out of place: the
    in-place writes would overwrite tensors that the backward needs."""
    cs = a.shape[1]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        d = 1
        while d < cs:
            b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
            d *= 2
        return b + a * h0[:, None]
    d = 1
    while d < cs:
        b[:, d:] += a[:, d:] * b[:, :-d]
        a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b.addcmul_(a, h0[:, None])


def chunk_size(S: int, chunk: int = 256) -> int:
    """The reference's chunk rule: ``min(chunk, S)``, shrunk until it
    divides S."""
    cs = min(chunk, S)
    while S % cs:
        cs -= 1
    return cs


def mamba_mixer(x: torch.Tensor, p: Dict[str, Any], cfg: ModelConfig, chunk: int = 256, plan=None,
                sp: bool = False) -> Tuple[torch.Tensor, MambaCache]:
    """Full-sequence mamba1 block: (B, S, d) -> ((B, S, d), the final
    (conv window, SSM state)), the sequence sharded over the model axis
    under ``sp``. The conv window is the last cw - 1 inputs of the conv
    (the pre-conv half of ``in_proj``), zeros where the sequence is
    shorter; the state is float32. On a mesh both hold this rank's
    channels."""
    mesh = _mesh(p, cfg, plan)
    if mesh is not None:
        x = parallel.tp_in(x, plan, sp)
    elif parallel.on_mesh(plan):
        x = parallel.whole_in(x, plan, sp)
    B, S, _ = x.shape
    di, n, cw = p["conv_w"].shape[-1], cfg.ssm_state, cfg.ssm_conv
    x_in, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    conv = F.pad(x_in[:, -(cw - 1):], (0, 0, max(cw - 1 - S, 0), 0))

    dt, B_ssm, C_ssm, A = _ssm_inputs(x_c, p, cfg, mesh)
    xf = x_c.float()
    cs = chunk_size(S, chunk)
    h = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, cs):
        sl = slice(c0, c0 + cs)
        dt_c = dt[:, sl]
        a = torch.exp(dt_c[..., None] * A)  # (B, cs, di, N)
        bx = (dt_c * xf[:, sl])[..., None] * B_ssm[:, sl, None, :]
        h_all = _scan_chunk(a, bx, h)
        del a
        ys.append(torch.matmul(h_all, C_ssm[:, sl, :, None])[..., 0])  # (B, cs, di)
        h = h_all[:, -1].clone()
        del h_all, bx
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + xf * p["D"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    if mesh is None and parallel.on_mesh(plan):
        return parallel.whole_out(y @ p["out_proj"], plan, sp), MambaCache(conv=conv, ssm=h)
    return _row_parallel(y, p["out_proj"], mesh, plan, sp), MambaCache(conv=conv, ssm=h)


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.ssm_d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
    )


def mamba_decode_step(x: torch.Tensor, p: Dict[str, Any], cfg: ModelConfig, cache: MambaCache,
                      plan=None) -> torch.Tensor:
    """One-token recurrent step, x: (B, 1, d) -> (B, 1, d). ``cache``'s
    conv window and SSM state (this rank's channels on a mesh) are updated
    in place (the reference returned new ones)."""
    mesh = _mesh(p, cfg, plan)
    x_in, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)  # (B, 1, di)
    window = torch.cat([cache.conv.to(x_in.dtype), x_in], dim=1)
    w = p["conv_w"].float()  # (cw, di)
    x_c = (window.float() * w[None]).sum(dim=1, keepdim=True)
    x_c = F.silu(x_c + p["conv_b"].float()).to(x.dtype)
    cache.conv.copy_(window[:, 1:])

    dt, B_ssm, C_ssm, A = _ssm_inputs(x_c, p, cfg, mesh)  # (B, 1, ...)
    a = torch.exp(dt[:, 0, :, None] * A)  # (B, di, N)
    bx = (dt[:, 0] * x_c[:, 0].float())[..., None] * B_ssm[:, 0, None, :]
    h = a * cache.ssm + bx
    cache.ssm.copy_(h)
    y = torch.matmul(h, C_ssm[:, 0, :, None])[..., 0][:, None, :]  # (B, 1, di)
    y = y + x_c.float() * p["D"].float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return _row_parallel(y, p["out_proj"], mesh)
