"""The plain reference: the decoder a configuration file describes, written
from its equations in float32 PyTorch, with no kernel, cache or batching.

It reads the weights the benchmark made (``hapbench.weights``), the same
tensors the program serves, and nothing the program derived from them. It
runs one layer at a time over every sequence it is given, so that what it
adds beside the served weights is one layer's float32 copy (one expert at a
time) and the sequences' activations.

The model, per layer: RMSNorm, attention with RoPE (the rotate-half form)
and grouped kv heads under a causal mask, a residual add; RMSNorm, then the
FFN: a softmax router whose top-k gates are renormalised to sum to one
(unless the configuration says ``norm_topk_prob`` false), each chosen
expert a SwiGLU FFN weighted by its gate, no token ever dropped, plus the
shared experts as one SwiGLU FFN; a residual add. The final RMSNorm and
the output head give the logits. Leading dense layers
(``first_k_dense_replace``) are refused.

``precision="fp8"`` is the control: every matrix product takes its inputs
rounded to float8 e4m3, the weights with a scale per output column and the
activations with a scale per row (a W8A8 path), the rest in float32.
``precision="bf16"`` is a witness of what bf16 alone does: every matrix
product in bf16 (inputs and output rounded, float32 accumulation), the rest
in float32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 number


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Matmul:
    def __init__(self, precision: str):
        if precision not in ("float32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16":
            return w.bfloat16()
        w = w.float()
        return _fp8(w, 0) if self.precision == "fp8" else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (T, K) float32 @ a weight already through ``weight``."""
        if self.precision == "bf16":
            return (x.bfloat16() @ w).float()
        return (_fp8(x, -1) if self.precision == "fp8" else x) @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1, rotate-half form."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Causal attention, q (S, Hq, hd), k/v (S, Hkv, hd) -> (S, Hq * hd)."""
    S, Hq, hd = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)  # (Hq, S, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((S, Hq, hd), dtype=torch.float32, device=q.device)
    keys = torch.arange(S, device=q.device)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        s = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) * hd**-0.5
        s = s.masked_fill(keys[None, None, :hi] > keys[lo:hi, None][None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1), v[:, :hi])
    return out.reshape(S, Hq * hd)


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"the reference takes SwiGLU or GeGLU FFNs, not {name!r}")


def _moe(h: torch.Tensor, p: Dict, layer: int, cfg: Dict, mm: _Matmul) -> torch.Tensor:
    """Routed experts (top-k of a softmax, gates renormalised as the
    configuration says, dropless) plus the shared experts, over every token
    of every sequence: h (T, d)."""
    act = _act(cfg["activation"])
    probs = torch.softmax(mm(h, mm.weight(p["router"][layer])), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, : cfg["top_k"]], idx[:, : cfg["top_k"]]
    if cfg.get("norm_topk_prob", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        he = h[tok]
        a = act(mm(he, mm.weight(p["wi_gate"][layer, e]))) * mm(he, mm.weight(p["wi_up"][layer, e]))
        y.index_add_(0, tok, mm(a, mm.weight(p["wo"][layer, e])) * gates[tok, slot, None])
    if cfg.get("n_shared_experts", 0):
        a = act(mm(h, mm.weight(p["shared_wi_gate"][layer]))) * mm(h, mm.weight(p["shared_wi_up"][layer]))
        y = y + mm(a, mm.weight(p["shared_wo"][layer]))
    return y


def _dense(h: torch.Tensor, p: Dict, layer: int, cfg: Dict, mm: _Matmul) -> torch.Tensor:
    act = _act(cfg["activation"])
    a = act(mm(h, mm.weight(p["wi_gate"][layer]))) * mm(h, mm.weight(p["wi_up"][layer]))
    return mm(a, mm.weight(p["wo"][layer]))


def logits(params: Dict, cfg: Dict, rows: Sequence[Tuple[np.ndarray, int]],
           precision: str = "float32") -> List[torch.Tensor]:
    """For each (tokens, first) of ``rows``: the float32 logits (S - first, V)
    at positions first .. S-1 of the sequence ``tokens`` (S,)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _logits(params, cfg, rows, _Matmul(precision))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _logits(params: Dict, cfg: Dict, rows, mm: _Matmul) -> List[torch.Tensor]:
    if cfg.get("first_k_dense_replace", 0):
        raise ValueError("the reference takes a uniform stack of layers, not leading dense layers")
    dev = params["embed"].device
    eps, theta, hd = cfg["norm_eps"], cfg["rope_theta"], cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]
    xs = [params["embed"][torch.as_tensor(np.asarray(t), dtype=torch.long, device=dev)].float() for t, _ in rows]
    lp = params["layers"]
    for layer in range(cfg["num_layers"]):
        a = lp["attn"]
        wq, wk, wv, wo = (mm.weight(a[n][layer]) for n in ("wq", "wk", "wv", "wo"))
        for i, x in enumerate(xs):
            h = _rms(x, lp["ln1"][layer], eps)
            S = h.shape[0]
            q = _rope(mm(h, wq).view(S, -1, hd), theta)
            k = _rope(mm(h, wk).view(S, -1, hd), theta)
            v = mm(h, wv).view(S, -1, hd)
            xs[i] = x + mm(_attention(q, k, v), wo)
        del wq, wk, wv, wo
        sizes = [x.shape[0] for x in xs]
        h = _rms(torch.cat(xs), lp["ln2"][layer], eps)
        if cfg.get("ffn_type") == "moe":
            y = _moe(h, lp["moe"], layer, cfg, mm)
        else:
            y = _dense(h, lp["ffn"], layer, cfg, mm)
        xs = [x + part for x, part in zip(xs, torch.split(y, sizes))]
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    head = mm.weight(head)
    return [mm(_rms(x[first:], params["final_norm"], eps), head) for x, (_, first) in zip(xs, rows)]
