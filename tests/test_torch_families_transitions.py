"""Eq.-6 transitions and resident INT4 on a second MoE family, reduced
Mixtral-8x7B (top-2 of 8 experts, no shared expert), against the JAX
package; and the dense families, which take neither.

Under the pinned switching plan ``fixed_plan("TP1", "TP2", "EP2",
mechanism="int4_upload")`` (on one device both layouts are the identity, so
the INT4 round trip is all that moves), in float32 on the CPU, the port's
greedy tokens and its transition counters equal the JAX engine's exactly:
async and sync, resident and dense, through ``run()`` and
``serve_continuous()``, pinned on the engine and through a ``HAPSession``.
A dense family keeps exact weights under the same plan (no expert leaf to
back up), and refuses resident INT4, as the reference does.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import HAPSession as JaxSession  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HAPSession, fixed_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402

EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")
PLAN = ("TP1", "TP2", "EP2")
PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10], list(range(11, 31)))
COUNTERS = ("batches", "replans", "plan_switches", "cache_hits", "planner_fallbacks", "resident_bytes_saved",
            "async_restores", "restore_errors", "background_errors", "joins", "decode_steps", "prefill_chunks",
            "fused_steps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    over = dict(capacity_factor=8.0) if get_config(name).is_moe else {}
    cfg_j = reduced(name, **over)
    cfg_t = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


@pytest.fixture(scope="module")
def mixtral():
    return _setup("mixtral-8x7b")


def _serve(eng, req_cls, prompts=PROMPTS, gen=6, continuous=False):
    for p in prompts:
        eng.submit(req_cls(prompt=p, max_new_tokens=gen))
    out = eng.serve_continuous() if continuous else eng.run()
    return [c.tokens for c in out]


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("asy", [False, True])
def test_mixtral_tokens_and_counters_equal_jax(mixtral, asy, resident, continuous):
    cfg_j, cfg_t, jparams, tparams = mixtral
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=resident, async_transitions=asy)
    if continuous:
        kw.update(kv_block_size=8, prefill_chunk=8)
    je = JaxEngine(cfg_j, jparams, hap_plan=jfixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    te = InferenceEngine(cfg_t, tparams, device="cpu", hap_plan=fixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    if continuous:
        je.scheduler.bucket = te.scheduler.bucket = 16
    want = _serve(je, JaxRequest, continuous=continuous)
    ops.reset_counts()
    got = _serve(te, Request, continuous=continuous)
    assert got == want
    assert _counters(te.stats) == _counters(je.stats)
    assert te.stats.resident_bytes_saved == (je.stats.resident_bytes_saved if resident else 0)
    assert (te.stats.transition_ms_total > 0) == (je.stats.transition_ms_total > 0)
    leaves = te.params["layers"]["moe"]
    assert all(isinstance(leaves[n], ops.QuantizedExpert) == resident for n in EXPERT_LEAVES)
    if resident:  # every expert matmul dequantizes its packed leaf first
        assert ops.DISPATCH_COUNTS["int4_dequant.ref"] >= ops.DISPATCH_COUNTS["gmm.ref"] > 0


@pytest.mark.parametrize("continuous", [False, True])
def test_mixtral_session_engine_equals_jax(mixtral, continuous):
    """Through a session: per-bucket re-planning, cache hits and the Eq.-6
    moves give the JAX session engine's tokens and counters."""
    cfg_j, cfg_t, jparams, tparams = mixtral
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=True)
    if continuous:
        kw.update(kv_block_size=8, prefill_chunk=8)
    js = JaxSession(cfg_j, "a6000", 1, source=jfixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    ts = HAPSession(cfg_t, "a6000", 1, source=fixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    je, te = js.engine(jparams, **kw), ts.engine(tparams, device="cpu", **kw)
    want = _serve(je, JaxRequest, continuous=continuous)
    got = _serve(te, Request, continuous=continuous)
    assert got == want
    assert _counters(te.stats) == _counters(je.stats)
    assert (ts.hits, ts.misses) == (js.hits, js.misses)


def test_mixtral_resident_equals_dense_round_trip(mixtral):
    """Serving from resident packed leaves == serving the dequantized
    backup as dense weights, token for token."""
    _, cfg_t, _, tparams = mixtral
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, resident_int4=True)
    toks = _serve(eng, Request)
    moe = dict(tparams["layers"]["moe"])
    for n in EXPERT_LEAVES:
        moe[n] = eng._tx.restore(f"moe/{n}", dtype=moe[n].dtype)
    rt = dict(tparams, layers=dict(tparams["layers"], moe=moe))
    assert _serve(InferenceEngine(cfg_t, rt, device="cpu", max_batch=2), Request) == toks
    dense = sum(tparams["layers"]["moe"][n].nbytes for n in EXPERT_LEAVES)
    packed = sum(eng.params["layers"]["moe"][n].nbytes for n in EXPERT_LEAVES)
    assert eng.stats.resident_bytes_saved == dense - packed > 0


@pytest.mark.parametrize("name", ["gemma2-9b", "mistral-nemo-12b"])
def test_dense_family_takes_no_transition(name):
    """A dense family under the switching INT4 plan: the JAX engine's
    tokens and counters, no restore, no dequant; resident INT4 is refused by
    both engines."""
    cfg_j, cfg_t, jparams, tparams = _setup(name)
    kw = dict(max_batch=2, use_int4_transition=True)
    je = JaxEngine(cfg_j, jparams, hap_plan=jfixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    te = InferenceEngine(cfg_t, tparams, device="cpu", hap_plan=fixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    want = _serve(je, JaxRequest)
    ops.reset_counts()
    got = _serve(te, Request)
    assert got == want
    assert _counters(te.stats) == _counters(je.stats)
    assert te.stats.async_restores == 0 and "int4_dequant.ref" not in ops.DISPATCH_COUNTS
    with pytest.raises(ValueError, match="MoE"):
        JaxEngine(cfg_j, jparams, resident_int4=True)
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(cfg_t, tparams, device="cpu", resident_int4=True)
