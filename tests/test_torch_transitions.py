"""The port's Eq.-6 transitions, resident INT4 serving and the session-bound
engine against the JAX package.

``TransitionExecutor`` restores must equal the reference executor's bit for
bit. Under the pinned switching plan ``fixed_plan("TP1", "TP2", "EP2",
mechanism="int4_upload")`` (on one device both layouts are the identity, so
the INT4 round trip is all that moves) the port's greedy tokens and its
transition counters must equal the JAX engine's exactly: async and sync,
resident and dense, through ``run()`` and ``serve_continuous()``, pinned on
the engine and through a ``HAPSession``. The engine tests of
``tests/test_session.py`` and ``tests/test_async_restore.py`` are mirrored.
Everything runs in float32 on the CPU; the side-stream restore on the card
is in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import HAPSession as JaxSession  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.core.transition import TransitionExecutor as JaxExecutor  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HAPSession, Workload, fixed_plan  # noqa: E402
from repro_torch.core.transition import Restored, TransitionExecutor  # noqa: E402
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


@pytest.fixture(scope="module")
def moe_setup():
    cfg_j = reduced("deepseek-moe-16b", capacity_factor=8.0)
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def _port_engine(setup, **kw):
    return InferenceEngine(setup[1], setup[3], device="cpu", **kw)


def _serve(eng, req_cls, prompts=PROMPTS, gen=6, continuous=False):
    for p in prompts:
        eng.submit(req_cls(prompt=p, max_new_tokens=gen))
    out = eng.serve_continuous() if continuous else eng.run()
    return [c.tokens for c in out]


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_executor_restore_equals_reference(dtype):
    """Flat backup then dense restore, and structured backup then packed
    restore: the same values as the reference executor's, bit for bit."""
    w = np.random.default_rng(0).standard_normal((2, 4, 16, 96)).astype(np.float32) * 0.1
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jax.numpy.asarray(wt.float().numpy()).astype(dtype)
    tx, jtx = TransitionExecutor("cpu"), JaxExecutor()
    tx.backup("w", wt)
    jtx.backup("w", jw)
    got = tx.restore("w", dtype=wt.dtype)
    want = np.asarray(jtx.restore("w", dtype=jw.dtype), np.float32)
    assert got.dtype == wt.dtype and got.shape == wt.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(tx.restore("w").float(), torch.from_numpy(np.asarray(jtx.restore("w"), np.float32)))
    tx.backup_packed("p", wt, 32)
    jtx.backup_packed("p", jw, 32)
    qe, jqe = tx.restore_packed("p"), jtx.restore_packed("p")
    assert isinstance(qe, ops.QuantizedExpert) and qe.shape == wt.shape
    for a in ("packed", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(qe, a).numpy(), np.asarray(getattr(jqe, a)))
    assert qe.packed.data_ptr() != tx._backups["p"].packed.data_ptr()  # an upload is a copy


def test_executor_async_and_identity_reshard():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 8, 128)).astype(np.float32))
    tx = TransitionExecutor("cpu")
    tx.backup("w", w)
    tx.backup_packed("p", w)
    res = tx.restore_async("w", torch.float32).result(timeout=30)
    assert isinstance(res, Restored) and res.event is None
    assert torch.equal(res.install(), tx.restore("w", torch.float32))
    packed = tx.restore_packed_async("p").result(timeout=30).install()
    assert torch.equal(packed.packed, tx.restore_packed("p").packed)
    with pytest.raises(ValueError, match="flat"):
        tx.restore_packed("w")
    # the identity with no mesh, or between equal layouts (tests/test_torch_sharded_serving.py moves
    # expert slices between two ranks)
    assert TransitionExecutor.reshard(w) == (w, 0)
    moved, nbytes = TransitionExecutor.reshard(w, (None, "model", None), (None, None, "model"))
    assert moved is w and nbytes == 0
    tx.close()
    assert tx._pool is None


# ---------------------------------------------------------------------------
# engine parity under the pinned switching INT4 plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("continuous", [False, True])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("asy", [False, True])
def test_engine_tokens_and_counters_equal_jax(moe_setup, asy, resident, continuous):
    cfg_j, _, jparams, _ = moe_setup
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=resident, async_transitions=asy)
    if continuous:
        kw.update(kv_block_size=8, prefill_chunk=8)
    je = JaxEngine(cfg_j, jparams, hap_plan=jfixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    te = _port_engine(moe_setup, hap_plan=fixed_plan(*PLAN, mechanism="int4_upload"), **kw)
    if continuous:
        je.scheduler.bucket = te.scheduler.bucket = 16
    want = _serve(je, JaxRequest, continuous=continuous)
    got = _serve(te, Request, continuous=continuous)
    assert got == want
    assert _counters(te.stats) == _counters(je.stats)
    assert te.stats.resident_bytes_saved == (je.stats.resident_bytes_saved if resident else 0)
    assert (te.stats.transition_ms_total > 0) == (je.stats.transition_ms_total > 0)
    leaves = te.params["layers"]["moe"]
    assert all(isinstance(leaves[n], ops.QuantizedExpert) == resident for n in EXPERT_LEAVES)


@pytest.mark.parametrize("continuous", [False, True])
def test_session_engine_equals_jax(moe_setup, continuous):
    """Through a session: per-bucket re-planning, cache hits and the
    Eq.-6 moves give the JAX session engine's tokens and counters."""
    cfg_j, cfg_t, jparams, tparams = moe_setup
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=True)
    if continuous:
        kw.update(kv_block_size=8, prefill_chunk=8)
    js = JaxSession(cfg_j, "a6000", 1, source=jfixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    ts = HAPSession(cfg_t, "a6000", 1, source=fixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    je, te = js.engine(jparams, **kw), ts.engine(tparams, device="cpu", **kw)
    assert te.scheduler.coalesce_buckets and te.scheduler.bucket == 16
    want = _serve(je, JaxRequest, continuous=continuous)
    got = _serve(te, Request, continuous=continuous)
    assert got == want
    assert _counters(te.stats) == _counters(je.stats)
    assert (ts.hits, ts.misses) == (js.hits, js.misses)


def test_resident_equals_dense_round_trip(moe_setup):
    """Serving from resident packed leaves == serving the dequantized
    backup as dense weights, token for token (the resident path adds no
    error beyond the quantizer's)."""
    eng = _port_engine(moe_setup, max_batch=2, resident_int4=True)
    toks = _serve(eng, Request)
    moe = dict(moe_setup[3]["layers"]["moe"])
    for n in EXPERT_LEAVES:
        moe[n] = eng._tx.restore(f"moe/{n}", dtype=moe[n].dtype)
    rt = dict(moe_setup[3], layers=dict(moe_setup[3]["layers"], moe=moe))
    assert _serve(_port_engine((None, moe_setup[1], None, rt), max_batch=2), Request) == toks
    dense = sum(moe_setup[3]["layers"]["moe"][n].nbytes for n in EXPERT_LEAVES)
    packed = sum(eng.params["layers"]["moe"][n].nbytes for n in EXPERT_LEAVES)
    assert eng.stats.resident_bytes_saved == dense - packed > 0
    assert eng.params is not moe_setup[3] and not isinstance(moe_setup[3]["layers"]["moe"]["wo"], ops.QuantizedExpert)


# ---------------------------------------------------------------------------
# tests/test_session.py's engine tests, mirrored
# ---------------------------------------------------------------------------
class _CountingSource:
    def __init__(self, plan=None):
        self.calls = []
        self.plan = plan or fixed_plan("TP1", "TP1")

    def plan_for(self, w):
        self.calls.append(w)
        return dataclasses.replace(self.plan)


def _stub_session(cfg, source, prompt_bucket=16, gen_bucket=8):
    return HAPSession(cfg, "a6000", 1, source=source, prompt_bucket=prompt_bucket, gen_bucket=gen_bucket)


def test_engine_replans_per_bucket(moe_setup):
    src = _CountingSource()
    engine = _stub_session(moe_setup[1], src).engine(moe_setup[3], max_batch=4, device="cpu")
    assert engine.scheduler.coalesce_buckets and engine.scheduler.bucket == 16
    out = _serve(engine, Request, [list(range(1, n + 1)) for n in (6, 8, 30, 28)], gen=4)
    assert len(out) == 4 and all(len(t) == 4 for t in out)
    assert engine.stats.batches == 2 and engine.stats.replans == 1 and engine.stats.plan_switches == 0
    assert len(src.calls) == 2 and {w.prompt for w in src.calls} == {16, 32}


def test_engine_reuses_cached_plan_across_runs(moe_setup):
    src = _CountingSource()
    engine = _stub_session(moe_setup[1], src).engine(moe_setup[3], max_batch=2, device="cpu")
    for _ in range(2):
        _serve(engine, Request, [[1, 2, 3]], gen=4)
    assert len(src.calls) == 1 and engine.stats.cache_hits >= 1 and engine.stats.replans == 0


def test_engine_runs_interbatch_transition(moe_setup):
    """A plan switch whose layouts differ runs the Eq.-6 move between
    batches (the INT4 restore on the int4_upload mechanism)."""

    class _TwoPlanSource:
        def __init__(self):
            self.plans = [fixed_plan("TP1", "EP2", "EP2"), fixed_plan("TP1", "TP2", "TP2")]

        def plan_for(self, w):
            return self.plans.pop(0)

    session = _stub_session(moe_setup[1], _TwoPlanSource())
    session.transition_between = lambda old, new, w: ("int4_upload", 0.001)
    engine = session.engine(moe_setup[3], max_batch=2, device="cpu")
    out = _serve(engine, Request, [[1, 2, 3], list(range(1, 25))], gen=4)
    assert len(out) == 2 and engine.stats.replans == 1 and engine.stats.plan_switches == 1
    assert engine.stats.transition_ms_total > 0.0
    assert any(k.startswith("moe/") for k in engine._tx._backups)


def test_cached_switching_plan_restores_prefill_layout(moe_setup):
    plan = fixed_plan("TP1", "EP2", "TP2", mechanism="int4_upload")
    engine = _stub_session(moe_setup[1], _CountingSource(plan)).engine(moe_setup[3], max_batch=1, device="cpu")
    for _ in range(2):
        engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=4))
    out = engine.run()
    assert len(out) == 2 and engine.stats.batches == 2
    assert out[0].transition_ms > 0.0 and out[1].transition_ms > 0.0


def test_scheduler_padding_lands_on_session_bucket_edges(moe_setup):
    from repro_torch.serving.scheduler import FifoScheduler

    s = _stub_session(moe_setup[1], _CountingSource(), prompt_bucket=32)
    sch = FifoScheduler(max_batch=1, bucket=32)
    for n in (1, 31, 32, 33, 100):
        sch.submit(list(range(n)))
        toks, _ = sch.pad_batch(sch.next_batch())
        assert s.bucket_of(Workload(1, toks.shape[1], 8)).prompt == toks.shape[1]


def test_coalesce_buckets_splits_mixed_workloads():
    from repro.serving.scheduler import FifoScheduler as JaxFifo
    from repro_torch.serving.scheduler import FifoScheduler

    for coalesce in (True, False):
        ours, theirs = FifoScheduler(8, 8, coalesce_buckets=coalesce), JaxFifo(8, 8, coalesce_buckets=coalesce)
        for n in (4, 6, 20, 22, 5):
            ours.submit(list(range(1, n + 1)))
            theirs.submit(list(range(1, n + 1)))
        sizes = []
        while (b := ours.next_batch()) is not None:
            assert [r.uid for r in b] == [r.uid for r in theirs.next_batch()]
            sizes.append(len(b))
        assert theirs.next_batch() is None
        assert sizes == ([2, 2, 1] if coalesce else [5])


def test_use_int4_false_keeps_exact_weights(moe_setup):
    plan = fixed_plan("TP1", "EP2", "TP2", mechanism="int4_upload")
    want = _serve(_port_engine(moe_setup, max_batch=1), Request, [[1, 2, 3, 4]], gen=6)
    eng = _port_engine(moe_setup, max_batch=1, hap_plan=plan, use_int4_transition=False)
    assert _serve(eng, Request, [[1, 2, 3, 4]], gen=6) == want
    assert not eng._tx._backups


def test_engine_stats_survive_empty_run(moe_setup):
    engine = _stub_session(moe_setup[1], _CountingSource()).engine(moe_setup[3], max_batch=2, device="cpu")
    assert engine.run() == []
    assert engine.stats.batches == 0 and engine.stats.transition_ms_total == 0.0


# ---------------------------------------------------------------------------
# tests/test_async_restore.py, mirrored, and the watchdog
# ---------------------------------------------------------------------------
def _switching(setup, **kw):
    return _port_engine(setup, max_batch=2, hap_plan=fixed_plan(*PLAN, mechanism="int4_upload"),
                        use_int4_transition=True, **kw)


def test_no_torn_weights_until_barrier(moe_setup):
    eng = _switching(moe_setup)
    before = eng.params["layers"]["moe"]
    eng._begin_async_restore("decode")
    assert eng._pending_restore is not None and eng.stats.async_restores == 1
    assert eng.params["layers"]["moe"] is before
    assert eng.transition_expert_layout() >= 0.0
    assert eng._pending_restore is None
    after = eng.params["layers"]["moe"]
    assert all(after[n] is not before[n] for n in EXPERT_LEAVES)
    assert eng.stats.restore_overlap_ms > 0.0


def test_restore_completes_before_first_decode_step(moe_setup, monkeypatch):
    """Slow every background restore down: the first decode step still
    only runs once all three leaves are restored and installed."""
    from repro_torch.serving import engine as engine_mod

    eng = _switching(moe_setup)
    restored = []
    orig = eng._tx.restore

    def slow_restore(name, dtype=None):
        time.sleep(0.02)
        out = orig(name, dtype)
        restored.append(name)
        return out

    eng._tx.restore = slow_restore
    seen = []
    orig_step = engine_mod.decode_step

    def spy(*a, **k):
        seen.append(len(restored))
        return orig_step(*a, **k)

    monkeypatch.setattr(engine_mod, "decode_step", spy)
    out = _serve(eng, Request, [[1, 2, 3, 4]], gen=4)
    assert len(out[0]) == 4 and eng.stats.async_restores == 1
    assert seen and all(n == 3 for n in seen)


def test_sync_relayout_drains_stale_pending(moe_setup):
    eng = _switching(moe_setup)
    eng._begin_async_restore("decode")
    assert eng._pending_restore is not None
    eng._relayout_experts("reshard")
    assert eng._pending_restore is None
    assert eng.transition_expert_layout() >= 0.0


def test_kick_noop_without_int4_switch(moe_setup):
    eng = _port_engine(moe_setup, max_batch=1, hap_plan=fixed_plan("TP1", "TP2"), use_int4_transition=True)
    eng._begin_async_restore("decode")
    assert eng._pending_restore is None and eng.stats.async_restores == 0
    eng2 = _port_engine(moe_setup, max_batch=1, hap_plan=fixed_plan(*PLAN), use_int4_transition=False)
    eng2._begin_async_restore("decode")
    assert eng2._pending_restore is None and eng2.stats.async_restores == 0


def test_stalled_restore_trips_watchdog_falls_back(moe_setup):
    """A background restore that stalls past ``restore_timeout_s`` is
    counted and abandoned; the barrier relayouts in sync, so the tokens are
    the sync engine's."""
    want = _serve(_switching(moe_setup, async_transitions=False), Request, [[1, 2, 3, 4]], gen=4)
    eng = _switching(moe_setup, restore_timeout_s=0.05)
    release = threading.Event()
    orig = eng._tx.restore

    def stalled(name, dtype=None):
        release.wait(5.0)
        return orig(name, dtype)

    eng._tx.restore = stalled
    try:
        eng.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=4))
        eng._begin_async_restore("decode")
        assert eng._join_async_restore("decode") is None
        assert eng.stats.restore_errors == 1 and eng.stats.background_errors == 1
    finally:
        release.set()
    eng._tx.restore = orig
    assert _serve(eng, Request, [], gen=4) == want
    assert eng.stats.restore_errors == 1
    eng.close()


def test_not_ported_knobs_raise(moe_setup):
    """The robustness knobs (they raised before the robustness layer was
    ported) on the resident session, served continuously: an overcommitted
    pool that preempts, and an injector that fails one block allocation
    (one more preemption) and counts the restores. Tokens, preemptions,
    counters and the fault counts equal the JAX session engine's."""
    from repro.serving import FaultInjector as JaxInjector
    from repro_torch.serving import FaultInjector

    cfg_j, cfg_t, jparams, tparams = moe_setup
    kw = dict(max_batch=2, use_int4_transition=True, resident_int4=True, kv_block_size=4, prefill_chunk=8,
              kv_blocks=11, kv_overcommit=0.25)
    js = JaxSession(cfg_j, "a6000", 1, source=jfixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    ts = HAPSession(cfg_t, "a6000", 1, source=fixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                    gen_bucket=8)
    jfi, tfi = JaxInjector().fail("kv_alloc", at=5), FaultInjector().fail("kv_alloc", at=5)
    je, te = js.engine(jparams, faults=jfi, **kw), ts.engine(tparams, device="cpu", faults=tfi, **kw)
    assert tfi.calls == jfi.calls == {"restore": 3}  # the resident upload of the three expert leaves
    for e, R in ((je, JaxRequest), (te, Request)):
        for p in PROMPTS:
            e.submit(R(prompt=p, max_new_tokens=6))
    want = [(c.uid, c.tokens, c.status, c.preemptions) for c in je.serve_continuous()]
    got = [(c.uid, c.tokens, c.status, c.preemptions) for c in te.serve_continuous()]
    te.close()
    assert got == want
    robust = ("preemptions", "preempted_tokens", "joins", "restore_errors", "background_errors")
    assert _counters(te.stats) == _counters(je.stats)
    assert {k: getattr(te.stats, k) for k in robust} == {k: getattr(je.stats, k) for k in robust}
    assert te.stats.preemptions >= 2 and te.stats.restore_errors == 0
    assert (tfi.calls, tfi.fired) == (jfi.calls, jfi.fired) and tfi.fired == {"kv_alloc": 1}
    dense = dataclasses.replace(moe_setup[1], ffn_type="dense")
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(dense, moe_setup[3], resident_int4=True, device="cpu")
