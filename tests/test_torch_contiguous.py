"""The port's contiguous continuous fallback (``paged=False``) and the
mamba and hybrid families served end to end, against the JAX engine.

In float32 on the CPU, on bridged weights, with the same 16-token prompt
bucket in both engines:

- the reduced DeepSeekMoE-16B (``capacity_factor=8.0``, so no token is
  dropped) through ``serve_continuous`` with ``paged=False``: greedy tokens
  and every ``EngineStats`` counter the JAX engine keeps equal its, in
  mid-stream joins with mixed budgets, a zero budget, under the
  pinned switching INT4 plan through a session (with its transition
  counts), and with a deadline and a cancel;
- the reduced Falcon-Mamba-7B and Hymba-1.5B through ``run()`` and
  ``serve_continuous()`` (contiguous by default for them): tokens and
  counters equal the JAX engine's;
- the reference's option errors: ``paged=True`` for a mamba model,
  ``prefix_cache`` or ``kv_overcommit`` without the paged path, and a mamba
  model on a mesh with a data axis of size > 1 (ROADMAP A.9).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import HAPSession as JaxSession  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSampling  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HAPSession, fixed_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import EngineStats, InferenceEngine, Request, SamplingParams  # noqa: E402

# the port's own measurement counters, which the JAX engine does not keep
PORT_ONLY_STATS = ("prefix_grouped_steps", "decode_step_ms_sum", "decode_step_ms_max", "reshard_bytes")
STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats) if f.name not in PORT_ONLY_STATS]
# the counters a wall-clock time does not decide
COUNTS = [f for f in STAT_FIELDS if not f.endswith("_ms") and not f.endswith("_ms_total")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def setup_of(name):
    """(JAX config, port config, JAX params, bridged params), float32, built
    once per module; capacity factor 8 for DeepSeek."""
    if name not in _SETUPS:
        over = dict(capacity_factor=8.0) if get_config(name).is_moe else {}
        cfg_j = reduced(name, **over)
        cfg_t = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
        jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
        _SETUPS[name] = (cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu"))
    return _SETUPS[name]


def _both(name, reqs, continuous=True, drive=None, **kw):
    """Serve ``reqs`` ((prompt, budget), ...) on a JAX and a port engine
    built with ``kw``; returns ((uid, tokens, status) per engine, the two
    engines). ``drive(engine, Request class)`` runs after the submissions."""
    cfg_j, cfg_t, jparams, tparams = setup_of(name)
    je = JaxEngine(cfg_j, jparams, kernel_backend="ref", **kw)
    te = InferenceEngine(cfg_t, tparams, device="cpu", **kw)
    out = []
    for e, R in ((je, JaxRequest), (te, Request)):
        e.scheduler.bucket = 16
        for p, g in reqs:
            e.submit(R(prompt=p, max_new_tokens=g))
        if drive is not None:
            drive(e, R)
        comps = e.serve_continuous() if continuous else e.run()
        out.append([(c.uid, c.tokens, c.status) for c in comps])
    te.close()
    return out, (je, te)


def _stats_equal(te, je, fields=STAT_FIELDS):
    assert {f: getattr(te.stats, f) for f in fields} == {f: getattr(je.stats, f) for f in fields}


# tests/test_continuous.py's scenarios on the contiguous path
CASES = {
    # mid-stream joins, mixed output budgets, prompts over two buckets
    "midstream_joins": ([([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 8), ([2, 7, 1, 8, 2, 8], 3),
                         ([1, 1, 2, 3, 5, 8, 13, 2, 1, 4, 7, 11], 6), (list(range(1, 21)), 5)], dict(max_batch=2)),
    # short prompts and one of three buckets in one generation's capacity
    "long_and_short": ([([1, 2, 3], 2), ([4, 5], 2), (list(range(1, 40)), 4)], dict(max_batch=3)),
    # a budget of zero ends at admission
    "zero_budget": ([([1, 2, 3, 4], 0), ([5, 6, 7], 4), ([8, 9], 3)], dict(max_batch=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deepseek_contiguous_equals_jax(case):
    reqs, kw = CASES[case]
    ops.reset_counts()
    (want, got), (je, te) = _both("deepseek-moe-16b", reqs, paged=False, **kw)
    assert got == want
    assert [len(t) for _, t, _ in got] == [g for _, g in reqs]
    _stats_equal(te, je)
    assert not te.paged and te._live is None
    assert te.stats.prefill_chunks == 0 and te.stats.joins == len(reqs)
    assert te.stats.batches == 1
    assert "decode.ref_append" in ops.DISPATCH_COUNTS and "decode.ref_paged" not in ops.DISPATCH_COUNTS


def test_deepseek_contiguous_joins_keep_graph_buffers():
    """A join merges into the live cache in place: the step cache keeps one
    decode step and one admission prefill per prompt bucket, no graph is
    dropped mid-generation, and the live cache's tensors keep their
    storage."""
    cfg_j, cfg_t, jparams, tparams = setup_of("deepseek-moe-16b")
    eng = InferenceEngine(cfg_t, tparams, device="cpu", paged=False, max_batch=2)
    eng.scheduler.bucket = 16
    for p, g in CASES["midstream_joins"][0]:
        eng.submit(Request(prompt=p, max_new_tokens=g))
    eng._begin_live_batch()
    ptrs = (eng._live.cache.k.data_ptr(), eng._live.cache.v.data_ptr())
    assert eng.admit() == [0, 1]
    while eng.step(SamplingParams()):
        eng.retire()
        eng.admit()
        assert (eng._live.cache.k.data_ptr(), eng._live.cache.v.data_ptr()) == ptrs
    kinds = sorted(k[0] for k in eng.steps.keys())
    assert kinds == ["admit_prefill", "admit_prefill", "decode"] and eng.steps.stats.dropped == 0


def test_deepseek_contiguous_session_transitions_equal_jax():
    """Under the pinned switching INT4 plan through a session, resident
    INT4: each admission re-plans, kicks the async restore and runs the
    barrier; tokens, transition and plan counters equal the JAX session
    engine's."""
    cfg_j, cfg_t, jparams, tparams = setup_of("deepseek-moe-16b")
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=True, paged=False)
    js = JaxSession(cfg_j, "a6000", 1, source=jfixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"),
                    prompt_bucket=16, gen_bucket=8)
    ts = HAPSession(cfg_t, "a6000", 1, source=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"),
                    prompt_bucket=16, gen_bucket=8)
    je, te = js.engine(jparams, **kw), ts.engine(tparams, device="cpu", **kw)
    reqs = CASES["midstream_joins"][0]
    for e, R in ((je, JaxRequest), (te, Request)):
        for p, g in reqs:
            e.submit(R(prompt=p, max_new_tokens=g))
    want = [c.tokens for c in je.serve_continuous()]
    got = [c.tokens for c in te.serve_continuous()]
    te.close()
    assert got == want
    _stats_equal(te, je, COUNTS)
    assert te.stats.async_restores == je.stats.async_restores > 0
    assert (ts.hits, ts.misses) == (js.hits, js.misses)


def test_deepseek_contiguous_deadline_and_cancel_equal_jax():
    """One request expires at the first boundary, one queued request is
    cancelled, and one live request is cancelled after two steps; partial
    outputs and counters equal the JAX engine's."""
    clocks = []

    def drive(e, R):
        t = [0.0]
        clocks.append(t)
        e.clock = lambda t=t: t[0]
        e.submit(R(prompt=[1, 2], max_new_tokens=3, deadline_ms=5.0))
        assert e.cancel(1) and not e.cancel(9)
        t[0] = 1.0

    reqs = [([3, 4, 5], 3), ([6, 7], 4), ([8, 9, 10, 11], 8)]
    (want, got), (je, te) = _both("deepseek-moe-16b", reqs, drive=drive, paged=False, max_batch=2)
    assert got == want
    assert [s for _, _, s in got] == ["ok", "cancelled", "ok", "deadline"]
    _stats_equal(te, je)
    assert (te.stats.cancelled, te.stats.deadline_expired) == (1, 1)

    cfg_j, cfg_t, jparams, tparams = setup_of("deepseek-moe-16b")
    out = []
    for e, R in ((JaxEngine(cfg_j, jparams, kernel_backend="ref", paged=False, max_batch=2), JaxRequest),
                 (InferenceEngine(cfg_t, tparams, device="cpu", paged=False, max_batch=2), Request)):
        e.scheduler.bucket = 16
        for p, g in reqs:
            e.submit(R(prompt=p, max_new_tokens=g))
        sp = SamplingParams() if isinstance(e, InferenceEngine) else JaxSampling()
        e._begin_live_batch()
        e.admit(sp)
        e.step(sp)
        e.retire()
        assert e.cancel(0)
        out.append(([(c.uid, c.tokens, c.status) for c in e.serve_continuous()], e.stats.cancelled))
    assert out[1] == out[0]
    assert out[1][0][0][2] == "cancelled" and len(out[1][0][0][1]) == 2


SSM_PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1, 8], list(range(1, 25)), [5, 6, 7, 8, 9, 10])


@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("name", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_families_serve_equal_jax(name, continuous):
    """Four requests, one past Hymba's reduced 16-token window, through
    ``max_batch`` 2: ``run()`` in two batches, or ``serve_continuous()`` on
    the contiguous path (the default for them) with mid-stream joins."""
    reqs = [(p, 6 + i % 3) for i, p in enumerate(SSM_PROMPTS)]
    ops.reset_counts()
    (want, got), (je, te) = _both(name, reqs, continuous=continuous, max_batch=2)
    assert got == want
    assert [len(t) for _, t, _ in got] == [g for _, g in reqs]
    _stats_equal(te, je)
    assert not te.paged
    assert ("decode.ref_append" in ops.DISPATCH_COUNTS) == (name == "hymba-1.5b")
    assert not any("hopper" in k for k in ops.DISPATCH_COUNTS)


@pytest.mark.parametrize(
    "name,kw,err,match",
    [
        ("falcon-mamba-7b", dict(paged=True), ValueError, "attention-only"),
        ("hymba-1.5b", dict(paged=True), ValueError, "attention-only"),
        ("hymba-1.5b", dict(prefix_cache=True), ValueError, "prefix_cache"),
        ("deepseek-moe-16b", dict(paged=False, prefix_cache=True), ValueError, "prefix_cache"),
        ("deepseek-moe-16b", dict(paged=False, kv_overcommit=0.5), ValueError, "kv_overcommit"),
        ("falcon-mamba-7b", dict(kv_overcommit=0.5), ValueError, "kv_overcommit"),
        # mamba models serve on a mesh since A.9's serving half; a data axis
        # of size > 1 is still not ported
        ("hymba-1.5b", dict(session=types.SimpleNamespace(mesh=types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2}, rank=0, capturable=False))),
         NotImplementedError, "A.9"),
    ],
)
def test_option_errors_equal_reference(name, kw, err, match):
    cfg_j, cfg_t, jparams, tparams = setup_of(name)
    jkw = {k: v for k, v in kw.items() if k != "session"}
    if jkw == kw:  # the reference raises the same error on the same options
        with pytest.raises(err, match=match):
            JaxEngine(cfg_j, jparams, **jkw)
    with pytest.raises(err, match=match):
        InferenceEngine(cfg_t, tparams, device="cpu", **kw)
