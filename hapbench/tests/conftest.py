"""The benchmark's own tests: ``python -m pytest -q hapbench/tests`` from the
root of the repository (the card-marked ones with ``-m gpu`` on the card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# a decoder small enough for the CPU, with every part the cells' models have:
# grouped kv heads, routed and shared experts, an untied head
TINY = dict(name="tiny", family="moe", num_layers=2, d_model=64, vocab_size=128, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=64, ffn_type="moe", n_routed_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=32,
            shared_d_ff=32, capacity_factor=2.0, activation="silu", rope_theta=10000.0, norm_eps=1e-6,
            tie_embeddings=False, dtype="float32")
TINY_TRAFFIC = dict(why="tiny", serve="continuous", requests_per_job=6,
                    prompt_tokens=dict(dist="lognormal", median=40, sigma=0.5, min=20, max=90),
                    new_tokens=dict(dist="uniform", min=4, max=12),
                    engine=dict(max_batch=3, prefill_chunk=32, kv_block_size=16, eos_id=-1, kernel_backend="hopper"),
                    prompt_bucket=64, warm_new_tokens=2, check=dict(requests=3),
                    trace_steps=dict(first=3, count=6))


@pytest.fixture
def tiny_cell():
    """A cell of the tiny model under the tiny traffic, with the decode
    cell's limit and the manifest's metrics."""
    from hapbench import manifest

    bench = manifest.load()
    limit = manifest.cell("deepseek-moe-16b.azure_conv").limits
    return manifest.Cell("tiny.cell", 1, dict(TINY), dict(TINY_TRAFFIC), limit, bench["end_to_end"],
                         bench["per_layer"])
