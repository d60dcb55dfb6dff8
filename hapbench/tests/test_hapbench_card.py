"""Tests that need the card (``python -m pytest -q -m gpu hapbench/tests`` on
it). Each decides inside its body whether there is a card, and skips on the
CPU."""

import ast
import time

import pytest
import torch

from conftest import ROOT, TINY_TRAFFIC
from hapbench import harness, manifest

# the smallest decoder the hand kernels take at their tensor-core widths
CARD_TINY = dict(name="card-tiny", family="moe", num_layers=2, d_model=256, vocab_size=512, num_heads=4,
                 num_kv_heads=2, head_dim=64, d_ff=256, ffn_type="moe", n_routed_experts=4, n_shared_experts=1,
                 top_k=2, moe_d_ff=128, shared_d_ff=128, capacity_factor=2.0, activation="silu",
                 rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False, dtype="bfloat16")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_cell_on_the_card_is_correct_and_traced(tiny_cell, trace):
    _card()
    tiny_cell.config = dict(CARD_TINY)
    r = harness.run_cell(tiny_cell, 2**31 + 3, 0.0, bool(trace), "cuda", time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"] and 0 < r["metrics"]["gmm_roofline"]["value"] <= 105
        assert 0 <= r["metrics"]["idle_share"]["value"] < 100
    else:
        assert r["metrics"]["out_tok_s"]["value"] > 0 and r["metrics"]["peak_mem_gib"]["value"] > 0


# a few short requests of each cell's own model: enough served tokens for a
# mean, few enough for a test run
CARD_TRAFFIC = dict(TINY_TRAFFIC, requests_per_job=8,
                    prompt_tokens=dict(dist="lognormal", median=200, sigma=0.5, min=64, max=512),
                    new_tokens=dict(dist="uniform", min=16, max=48),
                    engine=dict(TINY_TRAFFIC["engine"], max_batch=4, prefill_chunk=512), check=dict(requests=8))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["deepseek-moe-16b.azure_conv", "mixtral-8x7b-l16.azure_code"])
def test_the_float8_control_is_not_correct_at_the_cell_s_limit_on_the_card(cell):
    """The control in the program's place, judged by the cell's own rule and
    limit, on the cell's own model: not correct, while the program is."""
    _card()
    c = manifest.cell(cell)
    c.traffic = dict(CARD_TRAFFIC)
    r = harness.run_cell(c, 2**31 + 4, 0.0, False, "cuda", time.perf_counter(), control=True)
    assert r["control"]["program"]["correct"] is True, r["checks"]
    assert r["control"]["fp8"]["correct"] is False, r["control"]["fp8"]["checks"]
    assert r["control"]["fp8"]["checks"]["mean_logit_gap"]["limit"] == c.limits["mean_logit_gap"]


def test_card_tests_decide_inside_their_bodies():
    """No card test is skipped by a decorator or at import: the decision is
    made while the test runs."""
    for path in (ROOT / "hapbench" / "tests").glob("test_*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "skipif":
                raise AssertionError(f"{path.name}: skipif decides at import")
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.Expr, ast.If)) and "cuda" in ast.unparse(node):
                raise AssertionError(f"{path.name}: looks for a card at import: {ast.unparse(node)[:80]}")
