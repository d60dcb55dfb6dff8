"""The yardstick's frozen arithmetic: data-sheet peaks of the card, parameter
and byte counts of a configuration, the model FLOPs a served token costs,
and the work of one ``grouped_matmul`` launch.

Everything here reads a configuration file's dictionary (``configs/*.json``),
never the program's own objects, so that a change to the program cannot
move the yardstick. Only attention decoders with a dense or MoE FFN are
counted; that is what the benchmark's configurations are.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at the 700 W
# power limit.
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _glu_mult(cfg: Dict) -> int:
    return 3 if cfg.get("activation", "silu") in ("silu", "gelu") else 2


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def attn_params(cfg: Dict) -> int:
    """q, k, v and o projections of one layer."""
    d, hd = cfg["d_model"], head_dim(cfg)
    return d * cfg["num_heads"] * hd * 2 + d * cfg["num_kv_heads"] * hd * 2


def ffn_params(cfg: Dict) -> int:
    """The FFN of one layer: every routed expert, the shared experts and the
    router of an MoE, or the dense FFN."""
    d, m = cfg["d_model"], _glu_mult(cfg)
    if cfg.get("ffn_type", "dense") == "moe":
        routed = cfg["n_routed_experts"] * m * d * cfg["moe_d_ff"]
        shared = cfg.get("n_shared_experts", 0) * m * d * cfg.get("shared_d_ff", cfg["moe_d_ff"])
        return routed + shared + d * cfg["n_routed_experts"]
    return m * d * cfg["d_ff"]


def layer_params(cfg: Dict) -> int:
    """One layer: attention, FFN and its two norms."""
    return attn_params(cfg) + ffn_params(cfg) + 2 * cfg["d_model"]


def total_params(cfg: Dict) -> int:
    """Every weight: embedding, output head (when untied), final norm, layers."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    head = 0 if cfg.get("tie_embeddings", True) else V * d
    return V * d + head + d + cfg["num_layers"] * layer_params(cfg)


def active_matmul_params(cfg: Dict) -> int:
    """The weights one token multiplies by: attention projections, the top-k
    routed experts, the shared experts and the router in every layer, and the
    output head. The embedding is a lookup and the norms are no matmul."""
    d, m = cfg["d_model"], _glu_mult(cfg)
    if cfg.get("ffn_type", "dense") == "moe":
        ffn = (cfg["top_k"] * m * d * cfg["moe_d_ff"]
               + cfg.get("n_shared_experts", 0) * m * d * cfg.get("shared_d_ff", cfg["moe_d_ff"])
               + d * cfg["n_routed_experts"])
    else:
        ffn = m * d * cfg["d_ff"]
    return cfg["num_layers"] * (attn_params(cfg) + ffn) + cfg["vocab_size"] * d


def attention_flops_per_key(cfg: Dict) -> int:
    """FLOPs of one query against one key over every layer: the score and the
    weighted value, 2 * hd each, for every q head."""
    return 4 * cfg["num_layers"] * cfg["num_heads"] * head_dim(cfg)


def sequence_flops(cfg: Dict, prompt: int, new: int) -> int:
    """Model FLOPs of one request served whole: its ``prompt`` tokens and the
    ``new - 1`` generated tokens fed back (the last one never is). A token at
    position p (0-based, no padding) attends p + 1 keys. No padding of any
    kind is counted: neither the prompt bucket nor expert capacity."""
    n = prompt + max(new - 1, 0)
    keys = n * (n + 1) // 2  # sum over p of (p + 1)
    return 2 * active_matmul_params(cfg) * n + attention_flops_per_key(cfg) * keys


def decode_step_weight_bytes(cfg: Dict, elem: int = BF16_BYTES) -> int:
    """Weight bytes of every layer, which a decode step over enough rows reads
    once: every expert is hit."""
    return cfg["num_layers"] * layer_params(cfg) * elem


def kv_bytes_per_token(cfg: Dict, elem: int = BF16_BYTES) -> int:
    """K and V of one token over every layer."""
    return cfg["num_layers"] * 2 * cfg["num_kv_heads"] * head_dim(cfg) * elem


def gmm_work(E: int, C: int, K: int, N: int, elem: int = BF16_BYTES) -> Tuple[int, int]:
    """(FLOPs, bytes) of one grouped matmul (E, C, K) x (E, K, N): every row
    of the launched capacity, and each operand and the output moved once."""
    return 2 * E * C * K * N, (E * K * N + E * C * K + E * C * N) * elem


def least_time_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
