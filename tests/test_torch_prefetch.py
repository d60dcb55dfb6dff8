"""The port's predictive expert prefetch (DESIGN.md §5c) against the JAX
package.

Mirrors ``tests/test_prefetch.py`` case for case: the affinity-driven
next-layer predictor (equal predictions over seeded trackers), the
planner's degree-vs-prefetch-bandwidth search and the latency terms it
prices (``expert_time`` with residency and replication, ``prefetch_time``,
``replication_search``, ``HAPPlanner.searched_replication``: rtol 1e-9 on
latency models fitted on the same 40 samples), the executor's per-row
restore (bit-identical to a full restore, dense and packed, whole and per
rank shard, at any coverage), and the engine's staged-consume path under
``fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload")``: tokens equal
with prefetch off and equal the JAX engine's, sync and async, dense and
resident; ``prefetch_predicted`` and hits + misses equal the reference's.
(Which rows a barrier finds staged depends on when a background pull
lands, so hits alone are not compared.) Reduced DeepSeekMoE-16B in float32
on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import hap as jhap  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import ilp as jilp  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.flops import Workload as JWorkload  # noqa: E402
from repro.core.strategy import ExpertStrategy as JExpertStrategy  # noqa: E402
from repro.core.transition import TransitionExecutor as JaxExecutor  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import replication as jrepl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Workload, fixed_plan, hap, hardware, ilp, latency  # noqa: E402
from repro_torch.core.strategy import ExpertStrategy  # noqa: E402
from repro_torch.core.transition import StagedRow, TransitionExecutor  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.serving import replication as repl  # noqa: E402
from repro_torch.sharding.specs import ExpertReplication  # noqa: E402

SEEDS = (0, 1, 2)
N_SAMPLES = 40
PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10], [2, 3, 4], [7, 8])
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# NextLayerPredictor
# ---------------------------------------------------------------------------
def _skewed_tracker(mod):
    tr = mod.RoutingTracker(n_layers=2, n_experts=4, ema=0.0)
    tr.update(np.array([[[2, 1], [2, 3]], [[0, 3], [0, 1]]]))
    return tr


def test_predictor_cold_start_predicts_nothing():
    pred = repl.NextLayerPredictor(2, 4)
    assert pred.predict() == ((), ())
    pred.observe(repl.RoutingTracker(2, 4))
    assert pred.predict() == ((), ())


def test_predictor_affinity_pushforward_equal_reference():
    a, b = repl.NextLayerPredictor(2, 4, top_p=0.5), jrepl.NextLayerPredictor(2, 4, top_p=0.5)
    a.observe(_skewed_tracker(repl))
    b.observe(_skewed_tracker(jrepl))
    assert a.predict() == b.predict()
    layer0, layer1 = a.predict()
    assert layer0[0] == 2 and layer1[0] == 0


def test_predictor_top_p_prefix_ties_and_floor():
    pred = repl.NextLayerPredictor(1, 4, top_p=0.6, min_confidence=0.0)
    pred.scores = np.array([[0.25, 0.25, 0.25, 0.25]])
    pred._warm = True
    assert pred.predict() == ((0, 1, 2),)
    pred.top_p = 0.5
    assert pred.predict() == ((0, 1),)
    pred.scores = np.array([[0.1, 0.7, 0.1, 0.1]])
    assert pred.predict() == ((1,),)
    pred = repl.NextLayerPredictor(1, 4, top_p=1.0, min_confidence=0.2)
    pred.scores = np.array([[0.5, 0.3, 0.15, 0.05]])
    pred._warm = True
    assert pred.predict() == ((0, 1),)


def test_predictor_ema_smoothing_and_validation():
    pred = repl.NextLayerPredictor(1, 2, top_p=1.0, min_confidence=0.0, ema=0.5)
    tr = repl.RoutingTracker(1, 2, ema=0.0)
    tr.update(np.array([[[0, 0]]]))
    pred.observe(tr)
    np.testing.assert_allclose(pred.scores, [[1.0, 0.0]])
    tr2 = repl.RoutingTracker(1, 2, ema=0.0)
    tr2.update(np.array([[[1, 1]]]))
    pred.observe(tr2)
    np.testing.assert_allclose(pred.scores, [[0.5, 0.5]])
    with pytest.raises(ValueError, match="top_p"):
        repl.NextLayerPredictor(1, 2, top_p=0.0)
    with pytest.raises(ValueError, match="ema"):
        repl.NextLayerPredictor(1, 2, ema=1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_predictor_equals_reference_random(seed):
    """Seeded random routing over several observe/predict rounds: the same
    scores and the same per-layer predictions."""
    rng = np.random.default_rng(seed)
    t, j = repl.RoutingTracker(3, 8, ema=0.7), jrepl.RoutingTracker(3, 8, ema=0.7)
    a = repl.NextLayerPredictor(3, 8, top_p=0.7, min_confidence=0.05)
    b = jrepl.NextLayerPredictor(3, 8, top_p=0.7, min_confidence=0.05)
    for _ in range(6):
        block = rng.integers(0, 8, size=(3, 6, 2))
        t.update(block)
        j.update(block)
        a.observe(t)
        b.observe(j)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.predict() == b.predict()


# ---------------------------------------------------------------------------
# searched replication degrees and the latency terms they price
# ---------------------------------------------------------------------------
def test_searched_degrees_cases():
    cases = [(([0.25] * 4,), dict(gain_scale=1.0, cost_per_replica=1e-9, max_extra=4), (1, 1, 1, 1)),
             (([0.7, 0.1, 0.1, 0.1],), dict(gain_scale=1.0, cost_per_replica=0.1, max_extra=8), (3, 1, 1, 1)),
             (([0.7, 0.1, 0.1, 0.1],), dict(gain_scale=1.0, cost_per_replica=1.0, max_extra=8), (1, 1, 1, 1)),
             (([0.7, 0.1, 0.1, 0.1],), dict(gain_scale=1.0, cost_per_replica=0.0, max_extra=2), (3, 1, 1, 1)),
             (([0.8, 0.15, 0.05],), dict(gain_scale=1.0, cost_per_replica=1e-6, max_extra=8, max_degree=2),
              (2, 1, 1)),
             (([],), dict(gain_scale=1.0, cost_per_replica=0.0, max_extra=2), ()),
             (([0.0, 0.0],), dict(gain_scale=1.0, cost_per_replica=1e-9, max_extra=2), (1, 1))]
    for args, kw, want in cases:
        assert ilp.searched_replication_degrees(*args, **kw) == want == jilp.searched_replication_degrees(*args, **kw)


@functools.lru_cache(maxsize=None)
def _planners():
    """A JAX and a port planner for reduced DeepSeek on four devices, their
    latency models fitted on the same 40 samples."""
    cfg_j, cfg_t = reduced("deepseek-moe-16b"), get_config("deepseek-moe-16b").reduced()
    pj = jhap.HAPPlanner(cfg_j, "a6000", 4, model=jlat.LatencyModel(jhw.get_chip("a6000"), n_samples=N_SAMPLES))
    pt = hap.HAPPlanner(cfg_t, "a6000", 4,
                        model=latency.LatencyModel(hardware.get_chip("a6000"), n_samples=N_SAMPLES))
    return pj, pt


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_terms_equal_reference(seed):
    """``expert_time`` with resident INT4 and a replica set,
    ``_replication_factor``, ``prefetch_time`` and ``replication_search``
    give the reference's numbers."""
    pj, pt = _planners()
    rng = np.random.default_rng(seed)
    b, s, g = int(rng.integers(1, 9)), int(rng.choice([128, 256, 1024])), int(rng.choice([8, 32]))
    wj, wt = JWorkload(b, s, g), Workload(b, s, g)
    E = pt.cfg.n_routed_experts
    rep = ExpertReplication(tuple(int(d) for d in rng.integers(1, 3, size=E)))
    for tp, ep in ((1, 4), (2, 2), (4, 1)):
        ej, et = JExpertStrategy(tp=tp, ep=ep), ExpertStrategy(tp=tp, ep=ep)
        for phase in ("prefill", "decode"):
            for kw in ({}, {"resident_int4": True}, {"replication": rep}, {"replication": rep.degrees}):
                jkw = dict(kw)
                if isinstance(kw.get("replication"), ExpertReplication):
                    jkw["replication"] = rep.degrees
                assert pt.sim.expert_time(wt, phase, et, **kw) == pytest.approx(
                    pj.sim.expert_time(wj, phase, ej, **jkw), rel=1e-9)
        assert pt.sim._replication_factor(et, rep) == pj.sim._replication_factor(ej, rep.degrees)
        freqs = rng.dirichlet(np.full(E, 0.5))
        assert pt.sim.replication_search(wt, et, freqs, max_extra=4, window_steps=8) == \
            pj.sim.replication_search(wj, ej, freqs, max_extra=4, window_steps=8)
    for win in (1, 32):
        assert pt.sim.prefetch_time(wt, window_steps=win) == pytest.approx(pj.sim.prefetch_time(wj, window_steps=win),
                                                                           rel=1e-9)


def test_planner_searched_replication_end_to_end():
    """A skewed snapshot yields nontrivial degrees, a uniform one stays
    all-ones, and both equal the reference planner's."""
    pj, pt = _planners()
    w, e = Workload(batch=4, prompt=256, gen=32), ExpertStrategy(tp=1, ep=4)
    E = pt.cfg.n_routed_experts
    skew = np.full(E, 0.3 / (E - 1))
    skew[0] = 0.7
    d_skew = pt.searched_replication(w, e, skew, max_extra=4)
    d_uni = pt.searched_replication(w, e, np.full(E, 1.0 / E), max_extra=4)
    assert d_skew == pj.searched_replication(JWorkload(4, 256, 32), JExpertStrategy(tp=1, ep=4), skew, max_extra=4)
    assert d_skew[0] == max(d_skew) >= 2 and d_uni == (1,) * E
    t = pt.sim.prefetch_time(w, window_steps=32)
    assert 0.0 < t < pt.sim.prefetch_time(w, window_steps=1)


# ---------------------------------------------------------------------------
# TransitionExecutor: per-(layer, expert)-row restore
# ---------------------------------------------------------------------------
def _w(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_prefetch_rows_of_equals_reference():
    tx, jtx = TransitionExecutor("cpu", group_size=8), JaxExecutor(group_size=8)
    for name, shape in (("ok", (2, 3, 4, 4)), ("ragged", (2, 2, 12)), ("flat2d", (4, 8))):
        w = _w(shape)
        tx.backup(name, w)
        jtx.backup(name, w.numpy())
        assert tx.prefetch_rows_of(name) == jtx.prefetch_rows_of(name)
    assert tx.prefetch_rows_of("ok") == 6 and tx.prefetch_rows_of("ragged") is None
    assert tx.prefetch_rows_of("flat2d") is None and tx.prefetch_rows_of("missing") is None
    w = _w((2, 3, 4, 16))
    tx.backup_packed("p", w)
    jtx.backup_packed("p", w.numpy())
    assert tx.prefetch_rows_of("p") == jtx.prefetch_rows_of("p") == 6


def test_prefetch_row_holds_the_backup_row():
    """A staged row is the row's bytes of the backup, uploaded (a copy),
    and dequantizes to the same row of a full restore."""
    from repro_torch.kernels import ops

    tx = TransitionExecutor("cpu", group_size=8)
    w = _w((2, 3, 4, 4))
    tx.backup("w", w)
    full = tx.restore("w", dtype=torch.float32).reshape(6, 4, 4)
    qt = tx._backups["w"]
    for r in range(6):
        st = tx.prefetch_row("w", r)
        assert isinstance(st, StagedRow) and st.event is None and st.nbytes > 0
        assert torch.equal(st.packed, qt.packed[2 * r:2 * r + 2]) and st.packed.data_ptr() != qt.packed.data_ptr()
        row = ops.int4_dequant(st.packed, st.scales, st.zeros, out_dtype=torch.float32).view(4, 4)
        assert torch.equal(row, full[r])


@pytest.mark.parametrize("shard", [None, "ep0", "ep1", "tp0", "tp1"])
def test_restore_with_rows_bit_identical_any_coverage(shard):
    """Staged-row restore equals the plain restore bit for bit with no rows
    staged, some staged, or all staged; whole, and a rank's EP or TP shard
    (rows outside an EP shard are not uploaded)."""
    tx = TransitionExecutor("cpu", group_size=8)
    w = _w((2, 4, 4, 16))
    tx.backup("w", w)
    jtx = JaxExecutor(group_size=8)
    jtx.backup("w", w.numpy())
    sh = None if shard is None else (((None, "model", None, None) if shard[:2] == "ep" else
                                      (None, None, None, "model")), int(shard[2]), {"model": 2})
    plain = tx.restore("w", dtype=torch.float32, **({} if sh is None else {"shard": sh}))
    if sh is None:
        np.testing.assert_array_equal(plain.numpy(), np.asarray(jtx.restore("w", dtype=np.float32)))
    stage = {r: tx.prefetch_row("w", r) for r in range(8)}
    for staged in ({}, {1: stage[1], 6: stage[6]}, stage):
        got = tx.restore_with_rows("w", staged, dtype=torch.float32, shard=sh)
        assert torch.equal(got, plain)


@pytest.mark.parametrize("shard", [None, "ep1", "tp0"])
def test_restore_packed_with_rows_bit_identical(shard):
    tx = TransitionExecutor("cpu", group_size=8)
    w = _w((2, 4, 4, 32))
    tx.backup_packed("w", w, 8)
    jtx = JaxExecutor(group_size=8)
    jtx.backup_packed("w", w.numpy(), 8)
    sh = None if shard is None else (((None, "model", None, None) if shard[:2] == "ep" else
                                      (None, None, None, "model")), int(shard[2]), {"model": 2})
    plain = tx.restore_packed("w", **({} if sh is None else {"shard": sh}))
    stage = {r: tx.prefetch_row("w", r) for r in (0, 3, 5)}
    got = tx.restore_packed_with_rows("w", stage, shard=sh)
    jgot = jtx.restore_packed_with_rows("w", {r: jtx.prefetch_row("w", r) for r in (0, 3, 5)})
    for leaf in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(got, leaf), getattr(plain, leaf))
        if sh is None:
            np.testing.assert_array_equal(getattr(got, leaf).numpy(), np.asarray(getattr(jgot, leaf)))
    tx.backup("flat", w)
    with pytest.raises(ValueError, match="flat"):
        tx.restore_packed_with_rows("flat", {})


# ---------------------------------------------------------------------------
# the engine: prefetch on/off, against the JAX engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup():
    cfg_j = reduced("deepseek-moe-16b", capacity_factor=8.0)
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_serve(**kw):
    cfg_j, _, jparams, _ = _setup()
    eng = JaxEngine(cfg_j, jparams, max_batch=2, use_int4_transition=True,
                    hap_plan=jhap.fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), **kw)
    for p in PROMPTS:
        eng.submit(JaxRequest(prompt=list(p), max_new_tokens=GEN))
    toks = [c.tokens for c in eng.run()]
    s = eng.stats
    return toks, s.prefetch_predicted, s.prefetch_hits + s.prefetch_misses


def _port_serve(**kw):
    _, cfg_t, _, tparams = _setup()
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, use_int4_transition=True,
                          hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), **kw)
    for p in PROMPTS:
        eng.submit(Request(prompt=list(p), max_new_tokens=GEN))
    toks = [c.tokens for c in eng.run()]
    eng.close()
    return eng, toks


@pytest.mark.parametrize("resident", [False, True], ids=["dense", "resident"])
@pytest.mark.parametrize("async_transitions", [False, True], ids=["sync", "async"])
def test_prefetch_token_exact_vs_off_and_jax(async_transitions, resident):
    """Greedy tokens do not move when prefetch turns on (staged rows are
    exact backup rows, misses are uploaded at the barrier) and equal the
    JAX engine's; the rows predicted and the rows each barrier accounted
    equal the reference's."""
    kw = dict(async_transitions=async_transitions, resident_int4=resident)
    off, toks_off = _port_serve(**kw)
    on, toks_on = _port_serve(prefetch=True, prefetch_top_p=0.9, **kw)
    jtoks, jpredicted, jrows = _jax_serve(prefetch=True, prefetch_top_p=0.9, **kw)
    assert toks_on == toks_off == jtoks
    s = on.stats
    assert s.prefetch_predicted == jpredicted > 0
    n_rows = on.cfg.num_layers * on.cfg.n_routed_experts
    assert s.prefetch_hits + s.prefetch_misses == jrows and jrows % n_rows == 0
    assert s.prefetch_hits > 0 and s.prefetch_bytes > 0
    assert s.prefetch_errors == 0 and s.background_errors == 0
    if async_transitions:
        assert s.async_restores >= 1
    z = off.stats
    assert z.prefetch_predicted == z.prefetch_hits == z.prefetch_misses == 0 == z.routing_steps


def test_prefetch_with_replication_and_continuous():
    """Prefetch and replication together, through ``serve_continuous``: the
    tracker feeds both, and the tokens equal prefetch and replication off."""
    _, cfg_t, _, tparams = _setup()

    def serve(**kw):
        eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, use_int4_transition=True,
                              hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), **kw)
        for p in PROMPTS:
            eng.submit(Request(prompt=list(p), max_new_tokens=GEN))
        toks = [c.tokens for c in eng.serve_continuous()]
        eng.close()
        return eng, toks

    _, base = serve()
    eng, toks = serve(prefetch=True, prefetch_top_p=0.9, replicate_experts=2, rebalance_interval=4)
    assert toks == base
    assert eng.stats.routing_steps > 0 and eng.stats.replication_rebalances >= 1


def test_prefetch_cold_start_no_pulls():
    _, cfg_t, _, tparams = _setup()
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, use_int4_transition=True, prefetch=True,
                          hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"))
    eng._maybe_prefetch()
    assert eng.stats.prefetch_predicted == 0
    assert eng._prefetch_stage == {} and eng._prefetch_live == set()
    eng.close()


def test_prefetch_requires_moe():
    dense = get_config("mistral-nemo-12b").reduced()
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(dense, {}, device="cpu", prefetch=True)
