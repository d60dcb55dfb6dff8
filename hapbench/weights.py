"""Random weights from the seed, made on the device, in the layout the
program's models take (a nested dict, every per-layer leaf stacked along a
leading layer axis, matrices as ``x @ W``) and in the configuration's dtype.

One ``normal_`` call per leaf on a generator that lives on the device: the
embedding N(0, 0.02), every matrix N(0, 1 / fan_in), the norms 1. The same
tensors go to the program and to the plain reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def shapes(cfg: Dict) -> Dict:
    """Every leaf's shape, as the program lays it out (attention decoders
    with a dense or MoE FFN)."""
    L, d, V = cfg["num_layers"], cfg["d_model"], cfg["vocab_size"]
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // hq
    out: Dict = {"embed": (V, d), "final_norm": (d,)}
    if not cfg.get("tie_embeddings", True):
        out["lm_head"] = (d, V)
    layers: Dict = {
        "ln1": (L, d),
        "ln2": (L, d),
        "attn": {"wq": (L, d, hq * hd), "wk": (L, d, hkv * hd), "wv": (L, d, hkv * hd), "wo": (L, hq * hd, d)},
    }
    if cfg.get("ffn_type") == "moe":
        E, f = cfg["n_routed_experts"], cfg["moe_d_ff"]
        moe = {"router": (L, d, E), "wi_gate": (L, E, d, f), "wi_up": (L, E, d, f), "wo": (L, E, f, d)}
        s = cfg.get("n_shared_experts", 0)
        if s:
            sf = s * cfg.get("shared_d_ff", f)
            moe.update(shared_wi_gate=(L, d, sf), shared_wi_up=(L, d, sf), shared_wo=(L, sf, d))
        layers["moe"] = moe
    else:
        f = cfg["d_ff"]
        layers["ffn"] = {"wi_gate": (L, d, f), "wi_up": (L, d, f), "wo": (L, f, d)}
    out["layers"] = layers
    return out


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if name == "embed":
        return 0.02
    return shape[-2] ** -0.5


def make(cfg: Dict, seed: int, device, dtype=None) -> Dict:
    """The weights of ``cfg`` drawn from ``seed`` on ``device``."""
    dt = DTYPES[dtype or cfg["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)

    def build(tree: Dict) -> Dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v)
                continue
            t = torch.empty(v, dtype=dt, device=device)
            if k.startswith("ln") or k.endswith("norm"):
                out[k] = t.fill_(1.0)
            else:
                out[k] = t.normal_(0.0, _std(k, v), generator=g)
        return out

    return build(shapes(cfg))
