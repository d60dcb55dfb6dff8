"""The plain reference against the program at a tiny size on the CPU, and
what the benchmark may import."""

import ast

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from hapbench import check, weights
from hapbench.reference import model as reference

VARIANTS = {
    "moe": {},
    "tied_head": dict(tie_embeddings=True),
    "mha_no_shared": dict(num_kv_heads=4, n_shared_experts=0),
    "dense": dict(ffn_type="dense", n_routed_experts=0, top_k=0),
    "gelu_top1": dict(activation="gelu", top_k=1, capacity_factor=4.0),
}


def program_logits(cfg, params, tokens):
    from hapbench.harness import model_config
    from repro_torch.models import transformer

    mc = model_config(cfg)
    with torch.no_grad():
        h = transformer.forward_hidden(params, mc, transformer.embed_inputs(params, mc, {"tokens": tokens[None]}))
        h = h[0] if isinstance(h, tuple) else h
        return transformer.unembed(params, mc, h)[0]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reference_matches_the_program_in_float32(variant):
    cfg = {**TINY, **VARIANTS[variant]}
    params = weights.make(cfg, 11, "cpu")
    toks = np.random.default_rng(5).integers(0, cfg["vocab_size"], size=70)
    want = program_logits(cfg, params, torch.as_tensor(toks))
    got = reference.logits(params, cfg, [(toks, 0), (toks[:33], 30)])
    assert got[0].shape == want.shape
    torch.testing.assert_close(got[0], want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want[30:33], rtol=1e-4, atol=1e-4)  # a shorter row beside it


def test_the_control_is_coarser_than_float32():
    params = weights.make(TINY, 3, "cpu")
    toks = np.random.default_rng(1).integers(0, TINY["vocab_size"], size=40)
    f32 = reference.logits(params, TINY, [(toks, 0)])[0]
    f8 = reference.logits(params, TINY, [(toks, 0)], precision="fp8")[0]
    err = (f8 - f32).abs().max()
    assert 1e-3 < err < 0.5 * f32.abs().max()


def test_the_reference_follows_the_configuration_s_gates_and_refuses_dense_layers():
    toks = np.random.default_rng(2).integers(0, TINY["vocab_size"], size=30)
    params = weights.make(TINY, 4, "cpu")
    normed = reference.logits(params, TINY, [(toks, 0)])[0]
    assert torch.equal(normed, reference.logits(params, {**TINY, "norm_topk_prob": True}, [(toks, 0)])[0])
    raw = reference.logits(params, {**TINY, "norm_topk_prob": False}, [(toks, 0)])[0]
    assert (raw - normed).abs().max() > 1e-3
    with pytest.raises(ValueError, match="dense"):
        reference.logits(params, {**TINY, "first_k_dense_replace": 1}, [(toks, 0)])


def test_served_row_pads_left_to_the_bucket():
    row, first = check.served_row(np.array([5, 6, 7]), [8, 9, 10], 4)
    assert row.tolist() == [0, 5, 6, 7, 8, 9] and first == 3
    row, first = check.served_row(np.arange(1, 9), [3], 4)
    assert row.tolist() == list(range(1, 9)) and first == 7


def test_gaps_are_zero_for_the_best_token():
    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 1.0, 0.5]])
    assert check.gaps(ref, torch.tensor([1, 1])).tolist() == [0.0, 2.0]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` is the port, ``repro``
    the JAX package."""
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    files = [p for p in (ROOT / "hapbench").rglob("*.py") if "tests" not in p.parts]
    files += list((ROOT / "src" / "repro_torch").rglob("*.py"))  # the program the runs drive
    assert files
    for path in files:
        found = {name.split(".")[0] for name in _imports(path)} & forbidden
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "hapbench" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, path


def test_the_run_time_check_compares_whole_names():
    from hapbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.serving.engine", "reprox", "numpy"]) == []
    found = run.forbidden_modules(["repro", "repro.core.hap", "jaxlib.xla_client", "flax"])
    assert found == ["flax", "jaxlib", "repro"]
