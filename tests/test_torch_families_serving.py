"""The port's static serving engine on the other attention-only families,
against ``repro.serving.InferenceEngine``.

For each of the eight families beside DeepSeekMoE-16B, on the bridged
weights of the reduced config (``capacity_factor=8.0`` for the MoE
families, as ``tests/test_torch_serving.py`` does, so no token is dropped),
in float32 on the CPU: greedy ``run()`` gives exactly the JAX engine's
tokens on ``tests/test_serving.py``'s prompts, two batches deep, with the
same batch count. Dense families take no expert leaves, so they run no
grouped matmul.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402

FAMILIES = ("gemma-7b", "gemma2-9b", "gemma3-27b", "mistral-nemo-12b", "mixtral-8x7b", "qwen1.5-moe-a2.7b",
            "qwen2-57b-a14b", "qwen3-moe-30b-a3b")
PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20],
           [5, 6, 7, 8, 9, 10])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_setup(name):
    """(JAX config, port config, JAX params, bridged params) of the reduced
    family, float32; capacity factor 8 for the MoE families."""
    over = dict(capacity_factor=8.0) if get_config(name).is_moe else {}
    cfg_j = reduced(name, **over)
    cfg_t = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_run_greedy_tokens_equal_jax(name):
    """Four requests of 4-20 tokens through ``max_batch`` 2, 8 new tokens:
    two batches, the second at a longer bucket (past the reduced 16-token
    sliding window of Gemma-2/3)."""
    cfg_j, cfg_t, jparams, tparams = family_setup(name)
    je = JaxEngine(cfg_j, jparams, max_batch=2)
    te = InferenceEngine(cfg_t, tparams, max_batch=2, device="cpu")
    for p in PROMPTS:
        je.submit(JaxRequest(prompt=p, max_new_tokens=8))
        te.submit(Request(prompt=p, max_new_tokens=8))
    want = [c.tokens for c in je.run()]
    ops.reset_counts()
    got = [c.tokens for c in te.run()]
    assert got == want
    assert [len(t) for t in got] == [8] * len(PROMPTS)
    assert te.stats.batches == je.stats.batches == 2
    assert all(0 <= t < cfg_t.vocab_size for toks in got for t in toks)
    assert ("gmm.ref" in ops.DISPATCH_COUNTS) == cfg_t.is_moe
    assert not any("hopper" in k for k in ops.DISPATCH_COUNTS)


# tests/test_prefix_cache.py:326's donor and two identical followers, then a
# request of its own that joins when a slot drains: 8-token chunks over
# 8-token blocks, the prefix cache on
SHARED = list(range(1, 21))
CONT_REQS = [(SHARED + [40, 41], 6), (SHARED + [40, 41], 4), (SHARED + [40, 41], 4),
             ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 5)]
CONT_KW = dict(max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9, prefix_cache=True)
# the port's own measurement counters, which the JAX engine does not keep
PORT_ONLY_STATS = ("prefix_grouped_steps", "decode_step_ms_sum", "decode_step_ms_max", "reshard_bytes")


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_continuous_prefix_cache_equals_jax(name):
    """``serve_continuous`` with the prefix cache on: the JAX engine's
    tokens and every ``EngineStats`` counter both engines keep; the
    followers adopt the donor's blocks and decode through the prefix path."""
    from repro_torch.serving import EngineStats

    cfg_j, cfg_t, jparams, tparams = family_setup(name)
    je = JaxEngine(cfg_j, jparams, kernel_backend="ref", **CONT_KW)
    te = InferenceEngine(cfg_t, tparams, device="cpu", **CONT_KW)
    je.scheduler.bucket = te.scheduler.bucket = 16
    for p, g in CONT_REQS:
        je.submit(JaxRequest(prompt=p, max_new_tokens=g))
        te.submit(Request(prompt=p, max_new_tokens=g))
    want = [c.tokens for c in je.serve_continuous()]
    ops.reset_counts()
    got = [c.tokens for c in te.serve_continuous()]
    assert got == want
    assert [len(t) for t in got] == [g for _, g in CONT_REQS]
    fields = [f.name for f in dataclasses.fields(EngineStats) if f.name not in PORT_ONLY_STATS]
    assert {f: getattr(te.stats, f) for f in fields} == {f: getattr(je.stats, f) for f in fields}
    assert te.stats.prefix_hit_blocks > 0 and te.stats.prefix_grouped_steps > 0
    assert ops.DISPATCH_COUNTS["decode.ref_prefix"] > 0
