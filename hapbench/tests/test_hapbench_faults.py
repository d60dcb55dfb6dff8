"""The check catches a broken timed path: a whole run of the tiny cell on the
CPU (the look for a card skipped), with a fault planted in the program
underneath, must come out ``correct`` false. One fault for each that a
one-card serving cell can have; the exchange between cards does not exist
on one card."""

import time

import pytest
import torch

from hapbench import harness


def _state_unchanged(monkeypatch):
    """Attention steps write their K/V into copies: the cache a step returns
    is the one it was given."""
    from repro_torch.kernels import ops

    real = ops.decode_attention

    def stale(q, k_cache, v_cache, *args, **kwargs):
        out, _, _ = real(q, k_cache.clone(), v_cache.clone(), *args, **kwargs)
        return out, k_cache, v_cache

    monkeypatch.setattr(ops, "decode_attention", stale)


def _half_the_batch(monkeypatch):
    """The MoE leaves out the second half of its tokens and gives them the
    mean of the rest."""
    from repro_torch.models import moe

    real = moe.apply_moe

    def half(x, *args, **kwargs):
        out = real(x, *args, **kwargs)
        y = out.y.reshape(-1, out.y.shape[-1]).clone()
        n = y.shape[0]
        if n > 1:
            y[n // 2:] = y[: n // 2].mean(dim=0)
        return out._replace(y=y.reshape(out.y.shape))

    monkeypatch.setattr(moe, "apply_moe", half)


def _token_altered(monkeypatch):
    """Sampling hands back the next token id for one row of each step."""
    from repro_torch.serving import engine

    real = engine.sample

    def altered(logits, *args, **kwargs):
        toks = real(logits, *args, **kwargs).clone()
        toks[-1] = (toks[-1] + 1) % logits.shape[-1]
        return toks

    monkeypatch.setattr(engine, "sample", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_batch": _half_the_batch, "token_altered": _token_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    tiny_cell.config["dtype"] = "bfloat16"  # the cells' precision
    FAULTS[fault](monkeypatch)
    r = harness.run_cell(tiny_cell, 2**31 + 21, 0.0, False, "cpu", time.perf_counter())
    gap = r["checks"]["mean_logit_gap"]
    assert r["correct"] is False and gap["value"] > gap["limit"], gap


def test_the_sound_path_in_bfloat16_is_correct(tiny_cell):
    tiny_cell.config["dtype"] = "bfloat16"
    r = harness.run_cell(tiny_cell, 2**31 + 21, 0.0, False, "cpu", time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert torch.get_default_dtype() == torch.float32


def test_the_control_is_judged_by_the_cell_s_rule_and_limit(tiny_cell):
    """In control mode each stand-in gets the program's verdict: the same
    numbers compared, at the cell's own limit."""
    tiny_cell.config["dtype"] = "bfloat16"
    r = harness.run_cell(tiny_cell, 2**31 + 22, 0.0, False, "cpu", time.perf_counter(), control=True)
    limit = tiny_cell.limits["mean_logit_gap"]
    assert r["control"]["program"]["correct"] is r["correct"] is True
    for p in ("fp8", "bf16"):
        c = r["control"][p]
        assert c["checks"]["mean_logit_gap"] == {"value": c["mean"], "limit": limit}
        assert c["correct"] is (c["mean"] <= limit)
    assert r["control"]["fp8"]["mean"] > r["control"]["program"]["mean"]


@pytest.mark.parametrize("gap, failed, want", [(0.05, 0, True), (0.1, 0, True), (0.11, 0, False), (0.05, 1, False),
                                               (None, 0, False)])
def test_the_verdict_holds_each_number_to_its_limit(gap, failed, want):
    from hapbench import check

    checks, ok = check.verdict(gap, failed, {"mean_logit_gap": 0.1})
    assert ok is want and list(checks) == ["mean_logit_gap", "failed_requests"]
