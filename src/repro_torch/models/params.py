"""Parameter shapes, initialization and the bridge from the JAX pytree.

Parameters are a nested dict of tensors with the keys of the JAX pytree,
every per-layer leaf STACKED along a leading ``num_layers`` axis; the
forward pass loops over that axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A torch dtype from a config dtype name (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Abstract shapes (tuples) of every parameter leaf."""
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    shapes: Dict[str, Any] = {"embed": (V, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    if cfg.frontend != "none":
        shapes["frontend_proj"] = (cfg.frontend_dim, d)

    layers: Dict[str, Any] = {"ln1": (L, d)}
    if cfg.use_post_norm:
        layers.update({"ln1_post": (L, d), "ln2_post": (L, d)})
    if cfg.has_attention:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        layers["attn"] = {
            "wq": (L, d, hq * hd),
            "wk": (L, d, hkv * hd),
            "wv": (L, d, hkv * hd),
            "wo": (L, hq * hd, d),
        }
    if cfg.has_mamba:
        di, n, r, cw = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
        layers["mamba"] = {
            "in_proj": (L, d, 2 * di),
            "conv_w": (L, cw, di),
            "conv_b": (L, di),
            "x_proj": (L, di, r + 2 * n),
            "dt_w": (L, r, di),
            "dt_b": (L, di),
            "A_log": (L, di, n),
            "D": (L, di),
            "out_proj": (L, di, d),
        }
    if cfg.block_type == "hybrid":
        layers["fuse_norm_attn"] = (L, d)
        layers["fuse_norm_mamba"] = (L, d)
    if cfg.ffn_type == "dense":
        layers["ln2"] = (L, d)
        f = cfg.d_ff
        if cfg.activation in ("silu", "gelu"):
            layers["ffn"] = {"wi_gate": (L, d, f), "wi_up": (L, d, f), "wo": (L, f, d)}
        else:
            layers["ffn"] = {"wi": (L, d, f), "wo": (L, f, d)}
    elif cfg.ffn_type == "moe":
        layers["ln2"] = (L, d)
        E, f, sf = cfg.n_routed_experts, cfg.moe_d_ff, cfg.shared_d_ff
        moe: Dict[str, Any] = {
            "router": (L, d, E),
            "wi_gate": (L, E, d, f),
            "wi_up": (L, E, d, f),
            "wo": (L, E, f, d),
        }
        if cfg.n_shared_experts:
            s = cfg.n_shared_experts
            moe["shared_wi_gate"] = (L, d, sf * s)
            moe["shared_wi_up"] = (L, d, sf * s)
            moe["shared_wo"] = (L, sf * s, d)
        layers["moe"] = moe
    shapes["layers"] = layers
    return shapes


def _init_leaf(name: str, shape, stacked: bool, generator, device, dt) -> torch.Tensor:
    """One leaf by the reference's rules (``repro.models.params``): norms
    and ``D`` ones, ``A_log`` log(1..N), conv/dt biases zeros, the embedding
    N(0, 0.02), every other weight N(0, 1/fan_in). Random leaves are drawn
    one layer slice at a time straight into ``dt``, so a full-width model
    never holds a float32 copy of a stacked leaf."""
    out = torch.empty(shape, dtype=dt, device=device)
    if "norm" in name or name.startswith("ln") or name == "D":
        return out.fill_(1.0)
    if name in ("conv_b", "dt_b"):
        return out.zero_()
    if name == "A_log":
        n = shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return out.copy_(a.expand(shape))
    if name == "embed":
        std = 0.02
    else:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    for piece in out if stacked else (out,):
        piece.normal_(0.0, std, generator=generator)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, dtype=None) -> Params:
    """Seeded random weights at the config's shapes, on ``device``.

    ``generator`` must live on ``device``. The values differ from the JAX
    package's (torch cannot replay ``jax.random``); tests that compare the
    two frameworks bridge the JAX weights with ``params_from_numpy``.
    """
    dt = torch_dtype(dtype or cfg.dtype)

    def build(tree, stacked):
        return {
            k: build(v, stacked or k == "layers") if isinstance(v, dict)
            else _init_leaf(k, v, stacked, generator, device, dt)
            for k, v in tree.items()
        }

    return build(param_shapes(cfg), False)


def _to_tensor(leaf, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(leaf)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], device=None, dtype=None) -> Params:
    """The weight bridge: a nested dict of array-likes (numpy arrays, or
    anything ``np.asarray`` takes, such as the JAX package's pytree) ->
    the same nested dict of torch tensors on ``device``."""
    dt = torch_dtype(dtype) if dtype is not None else None
    return {
        k: params_from_numpy(v, device, dtype) if isinstance(v, dict) else _to_tensor(v, device, dt)
        for k, v in tree.items()
    }


def layer_slice(tree: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """The per-layer view of the stacked ``params["layers"]`` dict."""
    return {k: layer_slice(v, layer) if isinstance(v, dict) else v[layer] for k, v in tree.items()}
