# The port's own copy of repro.core.comm: the port imports nothing of the JAX package.
"""Per-layer collective-communication volume model (paper §III-A/B).

Accounting is PER DEVICE wire bytes for one transformer layer under a
joint (attention strategy, expert strategy) pair — the paper's T_{C_{ki}}
is indexed by both because the attention->expert boundary reshard depends
on the pair.

Layout state machine: after each module, the T tokens of the layer live in
"replication grade r" — every device holds T*r/N tokens, replicated within
groups of r devices.

  attention (A_d, A_t):  input needs grade A_t (head-sharded QKV consume
      full d_model); output allreduce within A_t groups leaves grade A_t.
  expert TP (E_t):       input needs grade E_t; output AR leaves grade E_t.
  expert EP (E_e):       all_to_all dispatch from token owners to expert
      owners and back; replication grade unchanged.

Collective volume formulas (ring algorithms, per-device wire bytes for
payload of P bytes over g devices):
  all-reduce      2 * P * (g-1)/g
  all-gather      P * (g-1)/g        (P = full gathered payload)
  all-to-all      P * (g-1)/g        (P = per-device resident payload)
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from .flops import Workload
from .strategy import AttnStrategy, ExpertStrategy


def _allreduce(payload: float, g: int) -> float:
    return 2.0 * payload * (g - 1) / g if g > 1 else 0.0


def _allgather(payload: float, g: int) -> float:
    return payload * (g - 1) / g if g > 1 else 0.0


def _all2all(payload: float, g: int) -> float:
    return payload * (g - 1) / g if g > 1 else 0.0


def _reshard_to_grade(tokens_bytes_per_dev_grade1: float, r_from: int,
                      r_to: int) -> float:
    """All-gather cost of raising replication grade r_from -> r_to.

    tokens_bytes_per_dev_grade1: bytes/device at grade 1 (= T*d*B/N).
    Each device must end with r_to/N of the tokens; it already holds
    r_from/N of them.
    """
    if r_to <= r_from:
        return 0.0
    return tokens_bytes_per_dev_grade1 * (r_to - r_from)


def layer_comm_bytes(cfg: ModelConfig, w: Workload, phase: str,
                     a: AttnStrategy, e: ExpertStrategy,
                     n_devices: int) -> float:
    """Per-device wire bytes for one layer under (a, e)."""
    N = n_devices
    T = w.tokens(phase)
    d = cfg.d_model
    B = w.dtype_bytes
    tok_dev = T * d * B / N            # grade-1 bytes per device

    total = 0.0
    grade = a.tp                       # state after the previous layer

    # --- attention module ---------------------------------------------------
    # input already at grade A_t (attention leaves it there layer-to-layer)
    if a.tp > 1:
        # o-proj partial sums: AR over the A_t group; payload = tokens in
        # group = T/A_d * d * B
        total += _allreduce(T / a.dp * d * B, a.tp)
    grade = a.tp

    if cfg.ffn_type == "none":
        return total

    # --- boundary: attention -> expert ---------------------------------------
    if e.ep > 1:
        # EP dispatch+combine: per-device resident token-copies
        copies = (T * cfg.top_k) if cfg.is_moe else T
        payload = copies * d * B / N
        total += 2.0 * _all2all(payload, e.ep)        # dispatch + combine
        if e.tp > 1:
            # hybrid EP x TP: AR within the E_t slice group per token slab
            total += _allreduce(copies * d * B / (N // e.tp), e.tp)
    else:
        # pure expert TP: tokens must be replicated to grade E_t
        total += _reshard_to_grade(tok_dev, grade, e.tp)
        total += _allreduce(T * e.tp / N * d * B, e.tp)

    # --- boundary: expert -> next attention ----------------------------------
    # next layer's attention needs grade A_t again
    post_grade = e.tp if e.ep == 1 else grade
    total += _reshard_to_grade(tok_dev, post_grade, a.tp)
    return total


def comm_events(a: AttnStrategy, e: ExpertStrategy) -> int:
    """Number of distinct collectives per layer (for latency floors)."""
    n = 0
    if a.tp > 1:
        n += 1
    if e.ep > 1:
        n += 2 + (1 if e.tp > 1 else 0)
    else:
        n += 1 + (1 if e.tp > a.tp else 0)
    return max(n, 1)
