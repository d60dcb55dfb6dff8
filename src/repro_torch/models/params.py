"""Parameter shapes, sharding specs, initialization and the bridge from
the JAX pytree.

Parameters are a nested dict of tensors with the keys of the JAX pytree,
every per-layer leaf STACKED along a leading ``num_layers`` axis; the
forward pass loops over that axis. On a mesh each rank holds only its
shard of every leaf, as ``param_pspecs`` assigns it: ``shard_params``
cuts one rank's shard out of a whole tree, and ``init_params(...,
shard=(plan, rank))`` draws it directly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import QuantizedExpert
from repro_torch.sharding.specs import Spec, packed_spec_for, shard_slices, take_slices

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn}  # float8: a KV cache dtype (``kv_cache_dtype``)


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


def fsdp_pspecs(cfg: ModelConfig, plan) -> Dict[str, Any]:
    """ZeRO-3 (the reference's ``fsdp_pspecs`` as written): each leaf's
    largest dimension that divides the whole mesh is sharded over all its
    axes (indexed by the global rank), the rest replicated. Like the
    reference's, it does not skip the stacked-layer dimension (its comment
    says it does): a leaf can be sharded along L."""
    axes = tuple(plan.mesh.axis_names)
    total = plan.axis_size(axes)

    def spec_for(shape):
        best, best_dim = None, 0
        for i, dim in enumerate(shape):
            if dim % total == 0 and dim > best_dim:
                best, best_dim = i, dim
        out = [None] * len(shape)
        if best is not None:
            out[best] = axes
        return tuple(out)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec_for(v) for k, v in tree.items()}

    return walk(param_shapes(cfg))


def param_pspecs(cfg: ModelConfig, plan) -> Dict[str, Any]:
    """The spec of every leaf of ``param_shapes`` under a ShardingPlan (the
    reference's ``param_pspecs``; ``fsdp_pspecs`` under ``plan.fsdp``): a
    tuple per leaf, an axis name on each sharded dimension. Every leaf is
    replicated over the data axis. The embedding is sharded over the
    vocabulary, ``lm_head`` over its vocabulary columns, attention over
    heads (k/v only when the kv heads divide), the dense FFN and the shared
    experts over d_ff, and the routed experts over E (EP) or d_ff (TP).
    A dimension that does not divide its axis stays replicated. The mamba
    leaves take the reference's specs (d_inner on the FFN's TP axis); the
    shard of ``in_proj``, whose columns are the x half and the z half, is
    a slice of each half (``SPLIT_LEAVES``), where the reference's
    contiguous slice is resharded by XLA after the split."""
    if getattr(plan, "fsdp", False):
        return fsdp_pspecs(cfg, plan)
    tp = plan.ffn_tp_axis
    at = plan.attn_tp_axis if plan.attn_mode == "tp_heads" else None
    kv_ok = at is not None and cfg.num_kv_heads % plan.axis_size(at) == 0
    ep = plan.ep_axis
    specs: Dict[str, Any] = {"embed": (tp, None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, tp)
    if cfg.frontend != "none":
        specs["frontend_proj"] = (None, None)
    layers: Dict[str, Any] = {"ln1": (None, None)}
    if cfg.use_post_norm:
        layers["ln1_post"] = (None, None)
        layers["ln2_post"] = (None, None)
    if cfg.has_attention:
        layers["attn"] = {"wq": (None, None, at), "wk": (None, None, at if kv_ok else None),
                          "wv": (None, None, at if kv_ok else None), "wo": (None, at, None)}
    if cfg.has_mamba:
        layers["mamba"] = {"in_proj": (None, None, tp), "conv_w": (None, None, tp), "conv_b": (None, tp),
                           "x_proj": (None, tp, None), "dt_w": (None, None, tp), "dt_b": (None, tp),
                           "A_log": (None, tp, None), "D": (None, tp), "out_proj": (None, tp, None)}
    if cfg.block_type == "hybrid":
        layers["fuse_norm_attn"] = (None, None)
        layers["fuse_norm_mamba"] = (None, None)
    if cfg.ffn_type == "dense":
        layers["ln2"] = (None, None)
        if cfg.activation in ("silu", "gelu"):
            layers["ffn"] = {"wi_gate": (None, None, tp), "wi_up": (None, None, tp), "wo": (None, tp, None)}
        else:
            layers["ffn"] = {"wi": (None, None, tp), "wo": (None, tp, None)}
    elif cfg.ffn_type == "moe":
        layers["ln2"] = (None, None)
        if ep is not None:
            moe = {"router": (None, None, None), "wi_gate": (None, ep, None, None),
                   "wi_up": (None, ep, None, None), "wo": (None, ep, None, None)}
        else:
            moe = {"router": (None, None, None), "wi_gate": (None, None, None, tp),
                   "wi_up": (None, None, None, tp), "wo": (None, None, tp, None)}
        if cfg.n_shared_experts:
            moe.update(shared_wi_gate=(None, None, tp), shared_wi_up=(None, None, tp), shared_wo=(None, tp, None))
        layers["moe"] = moe
    specs["layers"] = layers
    return _sanitize(param_shapes(cfg), specs, plan)


def _sanitize(shapes, specs, plan):
    """Drop sharding on any dim whose size does not divide its axis."""
    if isinstance(specs, dict):
        return {k: _sanitize(shapes[k], v, plan) for k, v in specs.items()}
    return tuple(ax if ax is not None and dim % plan.axis_size(ax) == 0 else None
                 for dim, ax in zip(shapes, specs))


def leaf_specs(cfg: ModelConfig, plan) -> Dict[str, Tuple]:
    """``param_pspecs`` flat: {"layers/attn/wq": spec, ...}."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v

    walk(param_pspecs(cfg, plan), "")
    return out


# leaves whose sharded last dimension is this many blocks, each sharded on
# its own: a rank's ``in_proj`` holds its channels of x and of z
SPLIT_LEAVES = {"in_proj": 2}


def take_shard(x, spec: Spec, rank, sizes: Dict[str, int], parts: int = 1):
    """``rank``'s shard of ``x`` (numpy or torch; a ``QuantizedExpert``
    takes ``spec`` as its dense spec) under ``spec``; ``parts`` as in
    ``SPLIT_LEAVES``. ``rank``: the rank's mesh coordinates
    ({"data": i, "model": j}, ``RankMesh.coords``), or an int, its index
    along the axis the spec names."""
    if isinstance(x, QuantizedExpert) or _is_quantized(x):
        qspec = packed_spec_for(spec, tuple(x.packed.shape), sizes)
        return QuantizedExpert(*(t[shard_slices(qspec, t.shape, rank, sizes)] for t in (x.packed, x.scales, x.zeros)))
    return take_slices(x, spec, rank, sizes, parts)


def shard_params(params: Params, cfg: ModelConfig, plan, rank) -> Params:
    """``rank``'s shard (its coordinates, or its model-axis index, as in
    ``take_shard``) of a whole params tree (numpy arrays, as the JAX
    pytree converts to, or tensors) under ``plan``; feed the result to
    ``params_from_numpy``."""
    sizes = dict(plan.mesh.shape)
    specs = param_pspecs(cfg, plan)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, dict)
                else take_shard(_array(v), spec[k], rank, sizes, SPLIT_LEAVES.get(k, 1))
                for k, v in tree.items()}

    return walk(params, specs)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh, parts: int = 1) -> torch.Tensor:
    """The whole leaf from every rank's shard ``x`` under ``spec`` (the
    inverse of ``take_shard``), on every rank: one all-gather per sharded
    dimension, over its axis or axes, outside autograd."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        whole = mesh.all_gather(x, dim, ax)
        if parts > 1 and n > 1:  # [x_0 z_0 | x_1 z_1] -> [x_0 x_1 | z_0 z_1]
            w = x.shape[dim] // parts
            blocks = whole.split(w, dim=dim)
            whole = torch.cat([blocks[r * parts + p] for p in range(parts) for r in range(n)], dim=dim)
        x = whole
    return x


def _array(v):
    if isinstance(v, torch.Tensor) or _is_quantized(v):
        return v
    return np.asarray(v)


def _init_leaf(name: str, shape, stacked: bool, generator, device, dt, index=None, shard=None) -> torch.Tensor:
    """One leaf by the reference's rules (``repro.models.params``): norms
    and ``D`` ones, ``A_log`` log(1..N), conv/dt biases zeros, the embedding
    N(0, 0.02), every other weight N(0, 1/fan_in). Random leaves are drawn
    one layer slice at a time straight into ``dt``, so a full-width model
    never holds a float32 copy of a stacked leaf. ``index`` (slices of the
    global ``shape``) keeps only that shard: each slice is drawn whole, in
    the same generator sequence, and cut, so a shard holds the values the
    whole leaf would; ``shard`` ((spec, rank, sizes)) cuts a leaf of
    ``SPLIT_LEAVES`` block by block."""
    local = shape if index is None else tuple(len(range(*ix.indices(n))) for ix, n in zip(index, shape))
    out = torch.empty(local, dtype=dt, device=device)
    if "norm" in name or name.startswith("ln") or name == "D":
        return out.fill_(1.0)
    if name in ("conv_b", "dt_b"):
        return out.zero_()
    if name == "A_log":
        n = local[-1]
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device))
        return out.copy_(a[index[-1] if index else slice(None)].expand(local[:-1] + (n,)))
    if name == "embed":
        std = 0.02
    else:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    if index is None:
        for piece in out if stacked else (out,):
            piece.normal_(0.0, std, generator=generator)
        return out
    whole = torch.empty(shape[1:] if stacked else shape, dtype=dt, device=device)
    cut = index[1:] if stacked else index
    parts = SPLIT_LEAVES.get(name, 1)
    # a leaf sharded along L (FSDP) keeps the layers of its slice of L
    layers = range(shape[0])[index[0]] if stacked else range(1)
    for layer in range(shape[0]) if stacked else range(1):
        drawn = whole.normal_(0.0, std, generator=generator)
        if layer not in layers:
            continue
        piece = out[layer - layers.start] if stacked else out
        if parts == 1:
            piece.copy_(drawn[cut])
        else:
            spec, rank, sizes = shard
            piece.copy_(take_slices(drawn, spec[1:] if stacked else spec, rank, sizes, parts))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, dtype=None, shard=None) -> Params:
    """Seeded random weights at the config's shapes, on ``device`` (the
    card when None; raises without one).

    ``generator`` must live on ``device``. The values differ from the JAX
    package's (torch cannot replay ``jax.random``); tests that compare the
    two frameworks bridge the JAX weights with ``params_from_numpy``.
    ``shard=(plan, rank)`` draws only ``rank``'s shard of every leaf under
    the ShardingPlan ``plan`` (``param_pspecs``), equal to the same slice
    of the whole init from the same seed, and never holds more of a leaf
    than one layer slice beside the shard.
    """
    dt = torch_dtype(dtype or cfg.dtype)
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    specs, sizes, rank = None, None, 0
    if shard is not None:
        plan, rank = shard
        specs, sizes = param_pspecs(cfg, plan), dict(plan.mesh.shape)

    def build(tree, spec, stacked):
        out = {}
        for k, v in tree.items():
            sp = spec[k] if spec is not None else None
            if isinstance(v, dict):
                out[k] = build(v, sp, stacked or k == "layers")
            else:
                index = shard_slices(sp, v, rank, sizes) if sp is not None and any(sp) else None
                out[k] = _init_leaf(k, v, stacked, generator, device, dt, index, (sp, rank, sizes))
        return out

    return build(shapes, specs, False)


def _to_tensor(leaf, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(leaf)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def _is_quantized(leaf) -> bool:
    """A resident INT4 leaf of either package (duck-typed: the port does not
    import the JAX package's ``QuantizedExpert``)."""
    return all(hasattr(leaf, a) for a in ("packed", "scales", "zeros"))


def params_from_numpy(tree: Dict[str, Any], device=None, dtype=None) -> Params:
    """The weight bridge: a nested dict of array-likes (numpy arrays, or
    anything ``np.asarray`` takes, such as the JAX package's pytree) ->
    the same nested dict of torch tensors on ``device`` (the card when
    None; raises without one). A resident INT4 leaf (anything with
    ``packed``, ``scales`` and ``zeros``, such as the JAX package's
    ``QuantizedExpert``) becomes the port's ``QuantizedExpert``, its
    uint8 and float32 leaves kept as they are; ``dtype`` casts only the
    dense leaves."""
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None

    def leaf(v):
        if _is_quantized(v):
            return QuantizedExpert(*(_to_tensor(getattr(v, a), device, None) for a in ("packed", "scales", "zeros")))
        return _to_tensor(v, device, dt)

    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


def layer_slice(tree: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """The per-layer view of the stacked ``params["layers"]`` dict."""
    return {k: layer_slice(v, layer) if isinstance(v, dict) else v[layer] for k, v in tree.items()}


def layer_slices(tree: Dict[str, Any], num_layers: int) -> List[Dict[str, Any]]:
    """Every layer's view of the stacked ``params["layers"]`` dict, from
    one ``unbind`` per leaf. Under autograd the backward of an unbind
    stacks the layers' gradients into the leaf once; indexing the leaf
    once per layer (``layer_slice``) would give it L whole (L, ...)
    gradients, each zero but for one layer, added one by one: work
    quadratic in L."""
    def unbind(t):
        return {k: unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in t.items()}

    unbound = unbind(tree)
    return [layer_slice(unbound, layer) for layer in range(num_layers)]
