"""Input specifications and synthetic batches (the port of
``repro.models.io``).

``input_specs`` describes every model input of one (architecture x input
shape) combination without allocating it: tensors on the ``meta`` device
where the reference has ``jax.ShapeDtypeStruct``s. ``make_batch``
materializes the same structure with random values (from a
``torch.Generator``: the values cannot be ``jax.random``'s, the keys,
shapes and dtypes are). The audio and vision frontends are stubs, as in
the reference: the inputs are precomputed frame or patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from .params import torch_dtype
from .transformer import DecodeCache

# The four assigned input shapes (seq_len, global_batch, kind).
INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _input_shapes(cfg: ModelConfig, seq: int, batch: int, with_labels: bool) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{input name: (shape, dtype)} of a batch of ``batch`` x ``seq``."""
    i32, dt = torch.int32, torch_dtype(cfg.dtype)
    if cfg.frontend == "audio":
        out = {"features": ((batch, seq, cfg.frontend_dim), dt)}
        n_label = seq
    elif cfg.frontend == "vision":
        n_label = max(seq - cfg.num_patches, 16)
        out = {"patches": ((batch, cfg.num_patches, cfg.frontend_dim), dt), "tokens": ((batch, n_label), i32)}
    else:
        n_label = seq
        out = {"tokens": ((batch, seq), i32)}
    if with_labels:
        out["labels"] = ((batch, n_label), i32)
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> DecodeCache:
    dt = torch_dtype(cfg.dtype)
    kv_dt = torch_dtype(cfg.kv_cache_dtype) if cfg.kv_cache_dtype else dt
    L = cfg.num_layers
    k = v = conv = ssm = None
    if cfg.has_attention:
        shape = (L, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        k, v = _spec(shape, kv_dt), _spec(shape, kv_dt)
    if cfg.has_mamba:
        conv = _spec((L, batch, cfg.ssm_conv - 1, cfg.ssm_d_inner), dt)
        ssm = _spec((L, batch, cfg.ssm_d_inner, cfg.ssm_state), torch.float32)
    return DecodeCache(k=k, v=v, conv=conv, ssm=ssm, pos=_spec((), torch.int32))


def batch_specs(cfg: ModelConfig, seq: int, batch: int, kind: str) -> Dict[str, torch.Tensor]:
    """Meta tensors of a ``kind`` ("train" or "prefill") batch of ``batch``
    rows x ``seq`` positions: its inputs, and for ``train`` its labels."""
    return {k: _spec(s, d) for k, (s, d) in _input_shapes(cfg, seq, batch, with_labels=kind == "train").items()}


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Meta tensors for one (arch x input-shape) combination.

    train:   {"batch": {tokens, labels, ...}}
    prefill: {"batch": {tokens, ...}}
    decode:  {"token": (B, 1), "cache": DecodeCache at seq_len}
    """
    seq, batch, kind = INPUT_SHAPES[shape_name]
    if kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, seq, batch, kind)}
    return {"token": _spec((batch, 1), torch.int32), "cache": cache_specs(cfg, batch, seq)}


def supported_shapes(cfg: ModelConfig) -> Dict[str, str]:
    """shape_name -> "ok" or a skip reason."""
    out: Dict[str, str] = {}
    for name, (seq, batch, kind) in INPUT_SHAPES.items():
        if kind == "decode":
            if cfg.is_encoder_only:
                out[name] = "SKIP: encoder-only (no decode step)"
                continue
            if name == "long_500k":
                subquad = cfg.has_mamba or (cfg.sliding_window > 0 and cfg.layer_pattern)
                if not subquad:
                    out[name] = "SKIP: full quadratic attention only (no sliding-window/SSM variant)"
                    continue
        out[name] = "ok"
    return out


def make_batch(cfg: ModelConfig, seq: int, batch: int, generator: torch.Generator = None, with_labels: bool = True,
               device=None) -> Dict[str, torch.Tensor]:
    """A random batch with the keys, shapes and dtypes of ``input_specs``
    (frames and patches standard normal, ids uniform over the vocabulary),
    on ``device`` (the card when None); ``generator`` lives there (None:
    seed 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, (shape, dt) in _input_shapes(cfg, seq, batch, with_labels).items():
        if dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=generator, device=device, dtype=dt)
        else:
            out[name] = torch.randn(shape, generator=generator, device=device).to(dt)
    return out
