"""The port's robustness layer (DESIGN.md §4f) against the JAX package.

Mirrors ``tests/test_faults.py`` case by case. The fault injector's firing
pattern, the allocator's ``OutOfBlocks`` messages and the scheduler's
optimistic-admission arithmetic must equal the reference's. Every engine
scenario (organic and injected preemption, the wedged raise, deadlines,
cancels, the restore failover, a failed prefetch pull, the ILP fallback,
the seeded stress run) is served by the JAX engine and by the port on the
same bridged weights of the reduced DeepSeekMoE-16B (``capacity_factor=8.0``,
so no token drops and rows cannot couple), in float32 on the CPU: greedy
tokens, ``Completion.status``/``preemptions``, the fault sites' counts and
the ``EngineStats`` counters must be equal.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serving as jserving  # noqa: E402
from conftest import reduced  # noqa: E402
from repro.core import HAPSession as JaxSession  # noqa: E402
from repro.core import Workload as JaxWorkload  # noqa: E402
from repro.core import latency as jlatency  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.core.hardware import get_chip as jget_chip  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HAPSession, Workload, fixed_plan, latency  # noqa: E402
from repro_torch.core.hardware import get_chip  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockAllocator,
    BlockTable,
    ContinuousScheduler,
    FaultError,
    FaultInjector,
    InferenceEngine,
    OutOfBlocks,
    Request,
    SamplingParams,
)

SIDES = {"jax": jserving, "torch": serving}
COUNTERS = ("batches", "joins", "decode_steps", "prefill_chunks", "fused_steps", "preemptions", "preempted_tokens",
            "prefix_evictions_on_pressure", "prefix_hit_blocks", "cow_copies", "cancelled", "deadline_expired",
            "planner_fallbacks", "restore_errors", "background_errors", "async_restores", "routing_steps",
            "replication_rebalances")
REQS = ([list(range(1, 13)), 8], [list(range(3, 12)), 8], [[5, 4, 3, 2, 1], 8])
PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10])


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


def _session(side, setup, **kw):
    kw.setdefault("source", (jfixed_plan if side == "jax" else fixed_plan)("TP1", "TP1"))
    cls = JaxSession if side == "jax" else HAPSession
    return cls(setup[0] if side == "jax" else setup[1], "a6000", 1, prompt_bucket=16, gen_bucket=8, **kw)


def _engine(side, setup, session=None, **kw):
    """A continuous engine bound to a TP1 session (``tests/test_faults.py``'s
    ``_session(cfg).engine(...)``)."""
    session = session or _session(side, setup)
    if side == "jax":
        return session.engine(setup[2], **kw)
    return session.engine(setup[3], device="cpu", **kw)


def _switching(side, setup, **kw):
    """The pinned switching INT4 plan's engine (``_switching_engine``)."""
    if side == "jax":
        return jserving.InferenceEngine(setup[0], setup[2], max_batch=2, use_int4_transition=True,
                                        hap_plan=jfixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), **kw)
    return InferenceEngine(setup[1], setup[3], device="cpu", max_batch=2, use_int4_transition=True,
                           hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), **kw)


def _done(comps):
    return [(c.uid, c.tokens, c.status, c.preemptions) for c in comps]


def _counters(eng):
    return {k: getattr(eng.stats, k) for k in COUNTERS}


def _both(setup, drive, injector=None, **kw):
    """``drive(side, setup, faults)`` on each side, with a fresh injector
    ``injector(FaultInjector)`` of that side's class; returns {side:
    (result, engine, injector)}."""
    out = {}
    for side, mod in SIDES.items():
        fi = injector(mod.FaultInjector) if injector is not None else None
        out[side] = (*drive(side, setup, fi, **kw), fi)
    return out


def _assert_equal(res, calls=("kv_alloc", "restore", "ilp")):
    (jout, jeng, jfi), (tout, teng, tfi) = res["jax"], res["torch"]
    assert tout == jout
    assert _counters(teng) == _counters(jeng)
    if tfi is not None:
        assert {s: tfi.calls.get(s, 0) for s in calls} == {s: jfi.calls.get(s, 0) for s in calls}
        assert tfi.fired == jfi.fired


# ---------------------------------------------------------------------------
# FaultInjector: the reference's schedules, call by call
# ---------------------------------------------------------------------------
def _pattern(mod, build, site, n=32):
    fi = build(mod.FaultInjector)
    hits = []
    for _ in range(n):
        try:
            fi.fire(site)
            hits.append(0)
        except Exception as e:  # noqa: BLE001
            hits.append(type(e).__name__)
    return hits, fi.calls, fi.fired


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
@pytest.mark.parametrize("rule", ["at", "times", "p", "p_stacked", "delay_fail"])
def test_injector_pattern_equals_reference(seed, rule):
    site = {"at": "prefetch", "times": "restore", "p": "ilp", "p_stacked": "kv_alloc", "delay_fail": "restore"}[rule]

    def build(cls):
        fi = cls(seed=seed)
        if rule == "at":
            return fi.fail(site, at=seed % 5)
        if rule == "times":
            return fi.fail(site, times=seed % 4 + 1)
        if rule == "p":
            return fi.fail(site, p=0.5)
        if rule == "p_stacked":
            return fi.fail(site, p=0.3).fail(site, p=0.6)
        return fi.delay(site, 0.0, times=2).fail(site, at=1)

    got = _pattern(serving.faults, build, site)
    want = _pattern(jserving.faults, build, site)
    assert got == want
    assert any(got[0])


def test_injector_semantics():
    """``tests/test_faults.py``'s injector cases on the port's copy."""
    fi = FaultInjector().fail("prefetch", at=2)
    fi.fire("prefetch")
    fi.fire("prefetch")
    with pytest.raises(FaultError):
        fi.fire("prefetch")
    fi.fire("prefetch")
    assert fi.calls["prefetch"] == 4 and fi.fired_at("prefetch") == 1
    with pytest.raises(OutOfBlocks):
        FaultInjector().fail("kv_alloc").fire("kv_alloc")
    with pytest.raises(KeyError):
        FaultInjector().fail("ilp", exc=lambda: KeyError("boom")).fire("ilp")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector().fail("nope")
    with pytest.raises(ValueError, match="at most one"):
        FaultInjector().fail("ilp", at=1, times=2)
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector().fire("nope")
    fi = FaultInjector().delay("restore", 0.01, times=1).fail("restore", at=0)
    with pytest.raises(FaultError):
        fi.fire("restore")
    assert fi.fired_at("restore") == 2
    assert serving.faults.SITES == jserving.faults.SITES


# ---------------------------------------------------------------------------
# the allocator: the reference's messages, and the kv_alloc site
# ---------------------------------------------------------------------------
def _message(mod, case):
    a = mod.BlockAllocator(7, 4) if case == "reserve" else mod.BlockAllocator(4, 4)
    if case == "reserve":
        t = mod.BlockTable(a, 16, owner="uid=3")
        t.ensure_tokens(8)
        with pytest.raises(mod.OutOfBlocks) as ei:
            mod.BlockTable(a, 16, owner="uid=4")
    else:
        t = mod.BlockTable(a, 4, owner="uid=9")
        t.ensure_tokens(12)
        with pytest.raises(mod.OutOfBlocks) as ei:
            t.ensure_tokens(16)
    return str(ei.value)


@pytest.mark.parametrize("case", ["reserve", "extra"])
def test_out_of_blocks_messages_equal_reference(case):
    msg = _message(serving, case)
    assert msg == _message(jserving, case)
    assert "--kv-blocks" in msg
    if case == "reserve":
        assert "cannot reserve 4 blocks (2 available of 6)" in msg and "uid=3=2+2r" in msg
        assert "kv_overcommit" in msg
    else:
        assert "pool exhausted" in msg and "uid=9=3+0r" in msg


def test_injected_kv_alloc_fires_at_exact_index():
    fi = FaultInjector().fail("kv_alloc", at=2)
    a = BlockAllocator(9, 4, faults=fi)
    t = BlockTable(a, 32)
    t.ensure_tokens(8)
    with pytest.raises(OutOfBlocks):
        t.ensure_tokens(12)
    t.ensure_tokens(12)
    assert fi.calls["kv_alloc"] == 4 and fi.fired_at("kv_alloc") == 1


# ---------------------------------------------------------------------------
# the scheduler: optimistic-admission arithmetic against the reference's
# ---------------------------------------------------------------------------
def test_kv_need_invariant_and_expected_need_equal_reference():
    for cls in (ContinuousScheduler, JaxScheduler):
        sch = cls(max_batch=4, bucket=16)
        sch.submit(list(range(1, 6)), max_new_tokens=8)
        r = sch.peek()
        need0 = sch.kv_need(r)
        assert need0 == 16 + 8 + 1
        assert [sch.expected_kv_need(r, f) for f in (0.25, 0.001, 1.0)] == [19, 18, need0]
        r.stashed, r.max_new_tokens = [7, 7, 7], 5  # preempted after 3 tokens
        assert (sch.padded_len(r), sch.kv_need(r)) == (19, need0)
    rng = np.random.default_rng(0)
    for _ in range(50):
        prompt = rng.integers(1, 100, rng.integers(0, 40)).tolist()
        gen, f = int(rng.integers(0, 40)), float(rng.uniform(0.01, 1.0))
        stash = rng.integers(1, 100, rng.integers(0, 9)).tolist()
        got, want = [], []
        for cls, out in ((ContinuousScheduler, got), (JaxScheduler, want)):
            sch = cls(max_batch=4, bucket=16)
            sch.submit(prompt, max_new_tokens=gen)
            r = sch.peek()
            r.stashed = list(stash)
            toks, lens = sch.pad_batch([r])
            out.append((sch.padded_len(r), sch.kv_need(r), sch.expected_kv_need(r, f), toks.tolist(),
                        lens.tolist()))
        assert got == want


def test_pad_batch_stashed_replay_layout():
    sch = ContinuousScheduler(max_batch=4, bucket=16)
    sch.submit([3, 1, 4, 1, 5], max_new_tokens=8)
    r = sch.peek()
    r.stashed = [9, 8]
    toks, lens = sch.pad_batch([r])
    assert toks.shape == (1, 18) and lens.tolist() == [7]
    assert toks[0, :11].tolist() == [0] * 11
    assert toks[0, 11:16].tolist() == [3, 1, 4, 1, 5]
    assert toks[0, 16:].tolist() == [9, 8]
    sch.submit([1, 2], max_new_tokens=2)
    with pytest.raises(ValueError, match="one at a time"):
        sch.pad_batch([r, sch.queued()[1]])


def _admit_all(mod, sched_cls, overcommit):
    a = mod.BlockAllocator(11, 4)
    sch = sched_cls(max_batch=4, bucket=16)
    for _ in range(3):
        sch.submit(list(range(1, 6)), max_new_tokens=8)
    n = 0
    while True:
        r = sch.next_fit_blocks(a, 64, overcommit=overcommit)
        if r is None:
            return n
        mod.BlockTable(a, sch.expected_kv_need(r, overcommit) if overcommit else sch.kv_need(r))
        n += 1


def test_overcommit_admits_more_requests():
    for f, want in ((None, 1), (0.25, 2)):
        assert _admit_all(serving, ContinuousScheduler, f) == _admit_all(jserving, JaxScheduler, f) == want
    sch = ContinuousScheduler(max_batch=4, bucket=16)
    sch.submit(list(range(1, 30)), max_new_tokens=8)
    assert sch.next_fit_blocks(BlockAllocator(64, 4), 24, overcommit=0.25) is None  # the width stays worst-case
    sch = ContinuousScheduler(max_batch=4, bucket=16)
    uid = sch.submit([1, 2], max_new_tokens=4, deadline=5.0)
    assert sch.peek().deadline == 5.0 and sch.cancel(uid) and not sch.cancel(uid + 1)
    first = sch.peek()
    sch.submit([3], max_new_tokens=4)
    sch.remove(first)
    sch.requeue(first)
    assert sch.peek() is first and len(sch) == 2


# ---------------------------------------------------------------------------
# the engine: preemption-by-recompute, equal to the JAX engine
# ---------------------------------------------------------------------------
def _serve_reqs(side, setup, fi, reqs=REQS, **kw):
    eng = _engine(side, setup, faults=fi, **kw)
    R = SIDES[side].Request
    for p, g in reqs:
        eng.submit(R(prompt=p, max_new_tokens=g))
    return _done(eng.serve_continuous()), eng


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_organic_preemption_equals_jax_engine(moe_setup, prefix_cache):
    """An overcommitted pool preempts rows as they grow; the port preempts
    the same victims at the same steps, and replays them to the same
    tokens. With the prefix cache on the replays ride the registered
    prompts."""
    res = _both(moe_setup, _serve_reqs, max_batch=3, kv_block_size=4, kv_blocks=10, kv_overcommit=0.25,
                prefix_cache=prefix_cache)
    _assert_equal(res)
    comps, eng, _ = res["torch"]
    assert eng.stats.preemptions >= 1 and eng.stats.preempted_tokens >= 1
    assert all(status == "ok" for _, _, status, _ in comps)
    assert sum(c[3] for c in comps) == eng.stats.preemptions
    assert eng._live is None
    if prefix_cache:
        assert eng.stats.prefix_hit_blocks >= 1


def test_prefix_eviction_under_pressure_equals_jax_engine(moe_setup):
    """Growth under pressure first evicts a cache-only prefix entry, then
    preempts (seeded prompts, half of them behind one shared 16-token
    prefix)."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 512, rng.integers(2, 15)).tolist(), int(rng.integers(2, 9))) for _ in range(6)]
    base = rng.integers(1, 512, 16).tolist()
    reqs = [(base + p[:3], g) if i % 2 else (p, g) for i, (p, g) in enumerate(reqs)]
    res = _both(moe_setup, _serve_reqs, reqs=reqs, max_batch=3, kv_block_size=4, kv_blocks=12,
                kv_overcommit=0.25, prefix_cache=True)
    _assert_equal(res)
    eng = res["torch"][1]
    assert eng.stats.prefix_evictions_on_pressure >= 1 and eng.stats.preemptions >= 1


def test_injected_preemption_equals_jax_engine(moe_setup):
    """A kv_alloc fault at an exact allocation index forces one
    preemption in an ample pool."""
    res = _both(moe_setup, _serve_reqs, lambda F: F().fail("kv_alloc", at=9), max_batch=3, kv_block_size=4)
    _assert_equal(res)
    eng, fi = res["torch"][1:]
    assert fi.fired_at("kv_alloc") == 1 and eng.stats.preemptions == 1


def test_every_victim_at_cap_raises_wedged(moe_setup):
    def drive(side, setup, fi):
        eng = _engine(side, setup, faults=fi, max_batch=2, kv_block_size=4, max_preemptions=1)
        eng.submit(SIDES[side].Request(prompt=[1, 2, 3], max_new_tokens=4))
        with pytest.raises(SIDES[side].OutOfBlocks, match="wedged"):
            eng.serve_continuous()
        return None, eng

    res = _both(moe_setup, drive, lambda F: F().fail("kv_alloc"))
    _assert_equal(res)
    assert res["torch"][1].stats.preemptions == 1


# ---------------------------------------------------------------------------
# the engine: deadlines and cancels
# ---------------------------------------------------------------------------
def test_deadline_expires_queued_request(moe_setup):
    def drive(side, setup, fi):
        eng = _engine(side, setup, max_batch=2)
        t = [0.0]
        eng.clock = lambda: t[0]
        R = SIDES[side].Request
        eng.submit(R(prompt=[1, 2, 3], max_new_tokens=4, deadline_ms=100.0))
        eng.submit(R(prompt=[4, 5, 6], max_new_tokens=4))
        t[0] = 1.0
        return _done(eng.serve_continuous()), eng

    res = _both(moe_setup, drive)
    _assert_equal(res)
    comps, eng, _ = res["torch"]
    assert comps[0][1:3] == ([], "deadline") and comps[1][2] == "ok" and len(comps[1][1]) == 4
    assert eng.stats.deadline_expired == 1


def _begin(side, eng):
    """``_begin_live_batch``, a lifecycle sweep and ``admit`` (the
    reference's ``admit`` takes the sampling parameters)."""
    eng._begin_live_batch()
    eng._reap_lifecycle()
    return eng.admit(SamplingParams()) if side == "jax" else eng.admit()


def _step(side, eng):
    if side == "jax":
        return eng.step(jserving.SamplingParams(), jax.random.PRNGKey(0))
    return eng.step(SamplingParams())


def test_deadline_expires_live_request_returns_partial(moe_setup):
    def drive(side, setup, fi):
        eng = _engine(side, setup, max_batch=1)
        t = [0.0]
        eng.clock = lambda: t[0]
        uid = eng.submit(SIDES[side].Request(prompt=[1, 2, 3], max_new_tokens=8, deadline_ms=100.0))
        _begin(side, eng)
        assert _step(side, eng) and _step(side, eng)  # the prompt chunk, then one decode step
        t[0] = 1.0
        eng._reap_lifecycle()
        comps = eng.retire()
        assert [c.uid for c in comps] == [uid] and eng._live.slots[0] is None
        return _done(comps), eng

    res = _both(moe_setup, drive)
    _assert_equal(res)
    comps = res["torch"][0]
    assert comps[0][2] == "deadline" and len(comps[0][1]) == 2


def test_cancel_queued_and_live(moe_setup):
    def drive(side, setup, fi):
        eng = _engine(side, setup, max_batch=2)
        R = SIDES[side].Request
        uid_live = eng.submit(R(prompt=[1, 2, 3], max_new_tokens=8))
        uid_q = eng.submit(R(prompt=[4, 5, 6], max_new_tokens=8))
        assert eng.cancel(uid_q)
        _begin(side, eng)
        assert _step(side, eng)
        assert eng.cancel(uid_live) and not eng.cancel(999)
        eng._reap_lifecycle()
        return _done(eng.retire()), eng

    res = _both(moe_setup, drive)
    _assert_equal(res)
    comps, eng, _ = res["torch"]
    assert [c[0] for c in comps] == [1, 0] and [c[2] for c in comps] == ["cancelled", "cancelled"]
    assert comps[0][1] == [] and len(comps[1][1]) == 1 and eng.stats.cancelled == 2


# ---------------------------------------------------------------------------
# degraded modes, each counted
# ---------------------------------------------------------------------------
def _serve_switching(side, setup, fi, **kw):
    eng = _switching(side, setup, faults=fi, **kw)
    for p in PROMPTS:
        eng.submit(SIDES[side].Request(prompt=list(p), max_new_tokens=8))
    out = _done(eng.run())
    if side == "torch":
        eng.close()
    return out, eng


def test_restore_failure_falls_back_to_sync(moe_setup):
    """A failed background restore is counted and the barrier relayouts
    in sync: the same tokens, failovers and counts as the JAX engine."""
    res = _both(moe_setup, _serve_switching, lambda F: F().fail("restore", times=1), async_transitions=True)
    _assert_equal(res)
    eng, fi = res["torch"][1:]
    assert fi.fired_at("restore") == 1
    assert eng.stats.restore_errors == 1 and eng.stats.background_errors == 1 and eng.stats.async_restores >= 1
    ref = _both(moe_setup, _serve_switching, async_transitions=True)
    assert res["torch"][0] == ref["torch"][0] == ref["jax"][0]


def test_restore_stall_trips_watchdog_falls_back(moe_setup):
    """A background restore stalled past ``restore_timeout_s`` trips the
    watchdog at the barrier and the sync relayout takes over. The stall is
    ten times the kick-to-barrier time this test measures on a run with no
    fault (plus the timeout), and the barrier must have given up before the
    stall ended, so a slow machine fails this loudly instead of racing. The
    JAX engine's stall test races on such a margin (ROADMAP C), so its
    counts are held here to the values that test asserts, and the tokens to
    its run with no fault."""
    want, ref, _ = _both(moe_setup, _serve_switching, async_transitions=True)["jax"]
    base = _serve_switching("torch", moe_setup, None, async_transitions=True)[1]
    assert base.stats.async_restores == ref.stats.async_restores
    kick_s = base.stats.restore_overlap_ms / 1e3 / base.stats.async_restores
    timeout_s = 0.05
    stall_s = 10 * (kick_s + timeout_s)

    class Timed(FaultInjector):
        ended = []  # when the stalled call (the first restore) returned

        def fire(self, site):
            idx = self.calls.get(site, 0)
            super().fire(site)
            if site == "restore" and idx == 0:
                self.ended.append(time.perf_counter())

    fi = Timed().delay("restore", stall_s, at=0)
    eng = _switching("torch", moe_setup, faults=fi, async_transitions=True, restore_timeout_s=timeout_s)
    gave_up = []
    join = eng._join_async_restore

    def timed_join(phase):
        out = join(phase)
        gave_up.append(time.perf_counter())
        return out

    eng._join_async_restore = timed_join
    for p in PROMPTS:
        eng.submit(Request(prompt=list(p), max_new_tokens=8))
    got = _done(eng.run())
    eng.close()  # drains the stalled worker
    assert got == want and len(fi.ended) == 1
    assert gave_up[0] < fi.ended[0], f"the barrier gave up after the stall ended ({gave_up[0] - fi.ended[0]:.3f} s)"
    assert eng.stats.restore_errors == 1 and eng.stats.background_errors == 1
    assert eng.stats.async_restores == ref.stats.async_restores


@pytest.mark.parametrize("schedule", ["times", "seeded"])
def test_prefetch_pull_failure_counted_not_silent(moe_setup, schedule):
    """Failed prefetch rows count one error each and miss at the barrier:
    the tokens stay the JAX engine's. ``times=3`` fails the first three
    (row, leaf) fires, as in the reference; the seeded schedule fails rows
    at random, and every failed row fired exactly once."""
    rule = dict(times=3) if schedule == "times" else dict(p=0.5)
    res = _both(moe_setup, _serve_switching, lambda F: F(5).fail("prefetch", **rule), prefetch=True,
                prefetch_top_p=0.9)
    (jout, jeng, jfi), (tout, teng, tfi) = res["jax"], res["torch"]
    assert tout == jout
    assert teng.stats.prefetch_errors == tfi.fired_at("prefetch") >= 1
    assert teng.stats.background_errors == teng.stats.prefetch_errors and teng.stats.restore_errors == 0
    if schedule == "times":
        assert teng.stats.prefetch_errors == jeng.stats.prefetch_errors == jfi.fired_at("prefetch") == 3


@pytest.fixture(scope="module")
def latency_models():
    # a small fit: on one device every plan source gives the one plan
    return (jlatency.LatencyModel(jget_chip("a6000"), n_samples=12),
            latency.LatencyModel(get_chip("a6000"), n_samples=12))


def test_ilp_failure_degrades_to_static_session_level(moe_setup, latency_models):
    got = []
    for side, model, W in (("jax", latency_models[0], JaxWorkload), ("torch", latency_models[1], Workload)):
        s = _session(side, moe_setup, model=model)
        s.faults = (jserving if side == "jax" else serving).FaultInjector().fail("ilp", times=1)
        plan = s.plan_for(W(1, 8, 8))
        assert s.fallbacks == 1 and plan.describe() == s.planner.tp_plan().describe()
        s.plan_for(W(2, 8, 8))
        got.append((s.fallbacks, plan.describe(), s.faults.calls, s.faults.fired))
    assert got[0] == got[1]


def test_ilp_failure_degrades_engine_still_serves(moe_setup, latency_models):
    def drive(side, setup, fi):
        sess = _session(side, setup, model=latency_models[side == "torch"])
        out, eng = _serve_reqs(side, setup, fi, reqs=REQS[:2], session=sess, max_batch=2)
        assert sess.fallbacks == 1
        return out, eng

    res = _both(moe_setup, drive, lambda F: F().fail("ilp", times=1))
    _assert_equal(res)
    assert res["torch"][1].stats.planner_fallbacks == 1 and res["torch"][2].fired_at("ilp") == 1


# ---------------------------------------------------------------------------
# seeded stress: admit/preempt/cancel/retire, blocks conserved
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [{}, {"replicate_experts": 2, "rebalance_interval": 4, "prefetch": True}],
                         ids=["plain", "replicated_prefetch"])
def test_randomized_stress_conserves_blocks_and_tokens(moe_setup, extra):
    """Seeded churn over an overcommitted pool, a queued cancel and an
    expired deadline: every request retires once with the JAX engine's
    status and tokens, and every generation's allocator ends with all
    blocks free and no reservation. Again with hot-expert replication and
    prefetch on: the routing tracker counts the same steps under churn."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, rng.integers(2, 15)).tolist(), int(rng.integers(3, 9))) for _ in range(6)]

    def drive(side, setup, fi):
        eng = _engine(side, setup, max_batch=3, kv_block_size=4, kv_blocks=10, kv_overcommit=0.25, **extra)
        allocators = []
        begin = eng._begin_live_batch

        def tracking_begin():
            begin()
            allocators.append(eng._live.allocator)

        eng._begin_live_batch = tracking_begin
        t = [0.0]
        eng.clock = lambda: t[0]
        R = SIDES[side].Request
        uids = [eng.submit(R(prompt=p, max_new_tokens=g, deadline_ms=(50.0 if i == 4 else None)))
                for i, (p, g) in enumerate(reqs)]
        assert eng.cancel(uids[2])
        t[0] = 1.0
        comps = eng.serve_continuous()
        assert sorted(c.uid for c in comps) == uids and eng._live is None and allocators
        for a in allocators:
            assert a.num_reserved == 0 and a.num_free == a.num_blocks - 1
            assert all(a.refcount(b) == 0 for b in range(1, a.num_blocks))
        return _done(comps), eng

    res = _both(moe_setup, drive)
    _assert_equal(res)
    comps, eng, _ = res["torch"]
    assert [c[2] for c in comps] == ["ok", "ok", "cancelled", "ok", "deadline", "ok"]
    assert eng.stats.cancelled == 1 and eng.stats.deadline_expired == 1 and eng.stats.preemptions >= 1
    if extra:
        assert eng.stats.routing_steps == eng.stats.decode_steps >= 1


def test_card_schedule_equals_jax_engine():
    """``chip_smoke.py``'s robustness phase serves the continuous traffic at
    its pools; the schedule (admissions, preemptions, evictions) depends on
    the lengths alone, so one reduced layer gives the card's. Overcommitted
    at the worst case's pool, and with the prefix cache at the smaller one:
    the port preempts and evicts as the JAX engine does, with its tokens."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg_j = dataclasses.replace(reduced("deepseek-moe-16b", capacity_factor=8.0), num_layers=1)
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0,
                                num_layers=1)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(1))
    params = {"jax": jparams, "torch": params_from_numpy(jparams, "cpu")}
    reqs = chip_smoke.cont_requests(cfg_t)
    pool = chip_smoke.robust_pool(cfg_t)[0]
    assert pool == 51
    for blocks, pc, want in ((pool, False, dict(preemptions=4, prefix_evictions_on_pressure=0)),
                             (chip_smoke.ROBUST_CACHE_BLOCKS, True, dict(preemptions=12,
                                                                          prefix_evictions_on_pressure=3))):
        got = {}
        for side, mod in SIDES.items():
            kw = {} if side == "jax" else {"device": "cpu"}
            eng = mod.InferenceEngine(cfg_j if side == "jax" else cfg_t, params[side], max_batch=8, kv_block_size=16,
                                      kv_blocks=blocks, kv_overcommit=chip_smoke.ROBUST_OVERCOMMIT, prefix_cache=pc,
                                      **kw)
            for p, g in reqs:
                eng.submit(mod.Request(prompt=p, max_new_tokens=g))
            got[side] = (_done(eng.serve_continuous()), _counters(eng))
        assert got["torch"] == got["jax"]
        assert {k: got["torch"][1][k] for k in want} == want
