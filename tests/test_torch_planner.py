"""The port's planner copies and session facade against the JAX package.

The strategy space, the FLOP/byte/comm models, the hardware table, the
regression forests, the latency model, the Eq.-6 cost model, the ILP and
``HAPPlanner.plan`` must give the reference's numbers exactly: they are
copies of framework-free modules. The latency models are fitted on 40
samples in each package (the full fit takes about a minute per chip here).
The ``HAPSession`` facade is mirrored from ``tests/test_session.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import reduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import comm as jcomm  # noqa: E402
from repro.core import flops as jflops  # noqa: E402
from repro.core import hap as jhap  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import ilp as jilp  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.core import strategy as jstrat  # noqa: E402
from repro.core import transition as jtr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (FixedPlanSource, HAPSession, StaticPlanSource,  # noqa: E402
                              Workload, WorkloadBucket, fixed_plan)
from repro_torch.core import comm, flops, hap, hardware, ilp, latency, regression, strategy, transition  # noqa: E402
from repro_torch.core.strategy import AttnStrategy, ExpertStrategy  # noqa: E402

N_SAMPLES = 40
WORKLOADS = [(1, 128, 16), (4, 512, 64), (8, 4096, 64), (32, 256, 1024), (3, 2048, 8)]


@pytest.fixture(scope="module")
def cfgs():
    return jget_config("deepseek-moe-16b"), get_config("deepseek-moe-16b")


@pytest.fixture(scope="module")
def models():
    """Latency models fitted on the same (tiny) sample in both packages."""
    return (jlat.LatencyModel(jhw.get_chip("a6000"), n_samples=N_SAMPLES),
            latency.LatencyModel(hardware.get_chip("a6000"), n_samples=N_SAMPLES))


def _pairs(cfg_j, cfg_t, n):
    """(JAX, port) strategy pairs of the whole space, by name."""
    ja, ta = jstrat.attention_strategies(cfg_j, n), strategy.attention_strategies(cfg_t, n)
    je, te = jstrat.expert_strategies(cfg_j, n), strategy.expert_strategies(cfg_t, n)
    assert [s.name for s in ja] == [s.name for s in ta]
    assert [s.name for s in je] == [s.name for s in te]
    return list(zip(ja, ta)), list(zip(je, te))


# ---------------------------------------------------------------------------
# strategy space and cost models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 64])
def test_strategy_space_equal(cfgs, n):
    _pairs(*cfgs, n)
    for spec in ("DP2xTP2", "TP4", "DP8"):
        assert AttnStrategy.parse(spec).name == jstrat.AttnStrategy.parse(spec).name
    for spec in ("EP4", "TP4", "EP2xTP2"):
        assert ExpertStrategy.parse(spec).name == jstrat.ExpertStrategy.parse(spec).name
    for bad in ("EP4", "TP0", "TP2xTP4"):
        with pytest.raises(ValueError):
            AttnStrategy.parse(bad)
    with pytest.raises(ValueError):
        ExpertStrategy.parse("DP2")


@pytest.mark.parametrize("n", [2, 4])
def test_flops_and_comm_equal(cfgs, n):
    cfg_j, cfg_t = cfgs
    attn, expert = _pairs(cfg_j, cfg_t, n)
    for b, s, g in WORKLOADS:
        wj, wt = jflops.Workload(b, s, g), Workload(b, s, g)
        for phase in ("prefill", "decode"):
            assert flops.attn_flops(cfg_t, wt, phase) == jflops.attn_flops(cfg_j, wj, phase)
            assert flops.expert_flops(cfg_t, wt, phase) == jflops.expert_flops(cfg_j, wj, phase)
            assert flops.kv_bytes_per_layer(cfg_t, wt, phase) == jflops.kv_bytes_per_layer(cfg_j, wj, phase)
            for aj, at in attn:
                assert flops.attn_flops_dev(cfg_t, wt, phase, at) == jflops.attn_flops_dev(cfg_j, wj, phase, aj)
                assert flops.attn_bytes(cfg_t, wt, phase, at) == jflops.attn_bytes(cfg_j, wj, phase, aj)
                for ej, et in expert:
                    assert comm.layer_comm_bytes(cfg_t, wt, phase, at, et, n) == jcomm.layer_comm_bytes(
                        cfg_j, wj, phase, aj, ej, n)
                    assert comm.comm_events(at, et) == jcomm.comm_events(aj, ej)
                    assert flops.memory_feasible(cfg_t, wt, at, et, n, 48e9) == jflops.memory_feasible(
                        cfg_j, wj, aj, ej, n, 48e9)
            for ej, et in expert:
                assert flops.expert_flops_dev(cfg_t, wt, phase, et) == jflops.expert_flops_dev(cfg_j, wj, phase, ej)
                assert flops.expert_bytes(cfg_t, wt, phase, et) == jflops.expert_bytes(cfg_j, wj, phase, ej)
                assert flops.ep_imbalance(cfg_t, wt, phase, et.ep) == jflops.ep_imbalance(cfg_j, wj, phase, ej.ep)
    assert flops.expert_weight_bytes(cfg_t) == jflops.expert_weight_bytes(cfg_j)
    assert flops.memory_terms(cfg_t, Workload(4, 512, 64)) == jflops.memory_terms(cfg_j, jflops.Workload(4, 512, 64))


def test_hardware_table_and_ground_truth_equal():
    """Every reference chip is copied unchanged; the port adds ``h100``."""
    assert set(hardware.CHIPS) == set(jhw.CHIPS) | {"h100"}
    for name, spec in jhw.CHIPS.items():
        assert dataclasses.asdict(hardware.CHIPS[name]) == dataclasses.asdict(spec)
    h100 = hardware.get_chip("H100")
    assert (h100.peak_flops, h100.hbm_bw, h100.mem_capacity) == (989e12, 3.35e12, 80e9)
    assert h100.link_bw == pytest.approx(450e9 * 250 / 300) and h100.interconnect == "nvlink"
    gj, gt = jhw.GroundTruth(jhw.get_chip("a100"), seed=3), hardware.GroundTruth(hardware.get_chip("a100"), seed=3)
    for f, b, md in ((1e9, 1e6, 64), (1e12, 1e9, 4096), (3e8, 4e8, 352)):
        assert gt.compute_time(f, b, md) == gj.compute_time(f, b, md)  # noisy: the same seeded draws
        assert gt.eta(f, b, md) == gj.eta(f, b, md)
    for v in (1e3, 1e6, 1e9):
        assert gt.comm_time(v) == gj.comm_time(v) and gt.rho(v) == gj.rho(v)
        assert gt.h2d_time(v) == gj.h2d_time(v) and gt.dequant_time(v) == gj.dequant_time(v)


def test_regression_forest_equal():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 3))
    y = X[:, 0] ** 2 + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(60)
    Xp = regression.polynomial_features(X, degree=2)
    np.testing.assert_array_equal(Xp, jreg.polynomial_features(X, degree=2))
    got = regression.RandomForestRegressor(n_trees=4, seed=1).fit(Xp, y)
    want = jreg.RandomForestRegressor(n_trees=4, seed=1).fit(Xp, y)
    np.testing.assert_array_equal(got.predict(Xp), want.predict(Xp))
    assert got.relative_error(Xp, y) == want.relative_error(Xp, y)


def test_latency_model_and_simulator_equal(cfgs, models):
    cfg_j, cfg_t = cfgs
    mj, mt = models
    assert (mt.compute_err, mt.comm_err) == (mj.compute_err, mj.comm_err)
    f, b = [1e9, 3e12], [1e7, 2e9]
    np.testing.assert_array_equal(mt.predict_compute(f, b, [4, 8], [512, 1], [2048, 2048], [352, 4096]),
                                  mj.predict_compute(f, b, [4, 8], [512, 1], [2048, 2048], [352, 4096]))
    np.testing.assert_array_equal(mt.predict_comm([1e4, 1e9]), mj.predict_comm([1e4, 1e9]))
    sj = jlat.InferenceSimulator(cfg_j, "a6000", 4, model=mj)
    st = latency.InferenceSimulator(cfg_t, "a6000", 4, model=mt)
    attn, expert = _pairs(cfg_j, cfg_t, 4)
    for b_, s_, g_ in WORKLOADS[:3]:
        wj, wt = jflops.Workload(b_, s_, g_), Workload(b_, s_, g_)
        for phase in ("prefill", "decode"):
            for (aj, at), (ej, et) in zip(attn, expert):
                assert st.attn_time(wt, phase, at) == sj.attn_time(wj, phase, aj)
                assert st.expert_time(wt, phase, et) == sj.expert_time(wj, phase, ej)
                k = latency.ep_pipeline_chunks(cfg_t, wt, phase, et, 4)
                assert k == jlat.ep_pipeline_chunks(cfg_j, wj, phase, ej, 4)
                assert st.comm_time(wt, phase, at, et, k) == sj.comm_time(wj, phase, aj, ej, k)
                assert st.true_layer_time(wt, phase, at, et) == sj.true_layer_time(wj, phase, aj, ej)
    assert latency.overlapped_comm(1.0, 0.5, 4) == jlat.overlapped_comm(1.0, 0.5, 4)


@pytest.mark.parametrize("async_restore", [True, False])
def test_transition_costs_and_switching_matrix_equal(cfgs, async_restore):
    cfg_j, cfg_t = cfgs
    _, expert = _pairs(cfg_j, cfg_t, 4)
    for chip in ("a6000", "a100", "tpu_v5e"):
        cj, ct = jhw.get_chip(chip), hardware.get_chip(chip)
        for b, s, g in WORKLOADS[:3]:
            wj, wt = jflops.Workload(b, s, g), Workload(b, s, g)
            for ej, et in expert:
                for fj, ft in expert:
                    assert transition.layout_overlap(et, ft) == jtr.layout_overlap(ej, fj)
                    got = transition.transition_costs(cfg_t, wt, ct, 4, et, ft, 0.004, async_restore=async_restore)
                    want = jtr.transition_costs(cfg_j, wj, cj, 4, ej, fj, 0.004, async_restore=async_restore)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)
                    assert (got.c_ij, got.mechanism) == (want.c_ij, want.mechanism)
            t_layer = np.linspace(0.001, 0.01, len(expert))
            np.testing.assert_array_equal(
                transition.switching_matrix(cfg_t, wt, ct, 4, [e for _, e in expert], t_layer,
                                            async_restore=async_restore),
                jtr.switching_matrix(cfg_j, wj, cj, 4, [e for e, _ in expert], t_layer, async_restore=async_restore))
    assert transition.INT4_BYTES_PER_PARAM == jtr.INT4_BYTES_PER_PARAM


def test_hap_ilp_against_brute_force_and_reference():
    rng = np.random.default_rng(0)
    for trial in range(25):
        ka, ke = rng.integers(2, 9), rng.integers(2, 9)
        args = dict(a=rng.random(ka), p=rng.random(ke), d=rng.random(ke), P=rng.random((ka, ke)),
                    D=rng.random((ka, ke)), C=rng.random((ke, ke)) * 0.3,
                    feasible_prefill=rng.random((ka, ke)) > 0.2, feasible_decode=rng.random((ka, ke)) > 0.2)
        got_ilp, want_ilp = ilp.HapIlp(**args), jilp.HapIlp(**args)
        try:
            got = got_ilp.solve()
        except ValueError:
            with pytest.raises(ValueError):
                got_ilp.brute_force()
            with pytest.raises(ValueError):
                want_ilp.solve()
            continue
        assert got == want_ilp.solve()
        assert got[3] == pytest.approx(got_ilp.brute_force()[3]), trial


@pytest.mark.parametrize("b,s,g", WORKLOADS)
def test_planner_plans_equal(cfgs, models, b, s, g):
    """``HAPPlanner.plan`` on a6000 x4 picks the reference's strategies,
    mechanism, predicted latency and switch cost."""
    cfg_j, cfg_t = cfgs
    mj, mt = models
    pj = jhap.HAPPlanner(cfg_j, "a6000", 4, model=mj)
    pt = hap.HAPPlanner(cfg_t, "a6000", 4, model=mt)
    got, want = pt.plan(Workload(b, s, g)), pj.plan(jflops.Workload(b, s, g))
    assert got.describe() == want.describe()
    assert (got.mechanism, got.switch_cost, got.predicted_latency) == (
        want.mechanism, want.switch_cost, want.predicted_latency)
    for static in ("tp_plan", "ep_plan"):
        assert getattr(pt, static)().describe() == getattr(pj, static)().describe()
    assert pt.evaluate(got, Workload(b, s, g), include_ilp_time=False) == pj.evaluate(
        want, jflops.Workload(b, s, g), include_ilp_time=False)


def test_planner_on_the_h100(cfgs):
    """The port's own chip entry plans (no reference to compare with)."""
    cfg_t = cfgs[1]
    p = hap.HAPPlanner(cfg_t, "h100", 4, model=latency.LatencyModel(hardware.get_chip("h100"), n_samples=N_SAMPLES))
    plan = p.plan(Workload(4, 512, 64))
    assert plan.attn in p.attn_space and plan.expert_decode in p.expert_space
    assert np.isfinite(plan.predicted_latency) and plan.predicted_latency > 0


# ---------------------------------------------------------------------------
# fixed plans and the mesh bridge
# ---------------------------------------------------------------------------
def test_fixed_plan_from_names():
    plan = fixed_plan("DP2xTP2", "EP4", "TP4")
    want = jhap.fixed_plan("DP2xTP2", "EP4", "TP4")
    assert plan.describe() == want.describe() and plan.mechanism == want.mechanism == "reshard"
    assert plan.attn == AttnStrategy(dp=2, tp=2) and plan.switches
    same = fixed_plan("TP4", "EP4")
    assert not same.switches and same.mechanism == "none"


def test_to_sharding_plan_null_mesh_only():
    """No mesh: the null plan. A mesh of two ranks: each phase's layout
    (tests/test_torch_sharding_plan.py holds the resolver to the
    reference's). A (2, 2) mesh builds the engine, its layout keeping the
    data axis; a mesh that is not a RankMesh is refused."""
    import types

    cfg = get_config("deepseek-moe-16b").reduced()
    plan = fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload")
    assert plan.to_sharding_plan(None, cfg, phase="prefill") is None
    assert plan.to_sharding_plan(None, cfg, phase="decode") is None
    with pytest.raises(ValueError):
        plan.to_sharding_plan(None, cfg, phase="train")
    mesh = types.SimpleNamespace(axis_names=("model",), shape={"model": 2})
    pre, dec = (plan.to_sharding_plan(mesh, cfg, phase=ph) for ph in ("prefill", "decode"))
    assert (pre.attn_mode, pre.ffn_mode, dec.ffn_mode, dec.ep_axis) == ("replicated", "tp", "ep", "model")
    grid = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 2, "model": 2}, rank=0, size=2,
                                 capturable=False)
    eng = HAPSession(cfg, "h100", 4, source=plan, mesh=grid).engine({}, device="cpu")
    assert eng._layout == plan.to_sharding_plan(grid, cfg, phase="prefill")
    assert eng._layout.dp_axes == ("data",)  # a data axis serves: the batch rows split over it
    with pytest.raises(TypeError, match="RankMesh"):
        HAPSession(cfg, "h100", 2, source=plan, mesh=mesh).engine({}, device="cpu")


# ---------------------------------------------------------------------------
# the session facade (tests/test_session.py, mirrored)
# ---------------------------------------------------------------------------
class _CountingSource:
    def __init__(self, plan=None):
        self.calls = []
        self.plan = plan or fixed_plan("TP1", "TP1")

    def plan_for(self, w):
        self.calls.append(w)
        return dataclasses.replace(self.plan)  # fresh object per solve


def _stub_session(cfg, source, prompt_bucket=32, gen_bucket=16):
    return HAPSession(cfg, "a6000", 1, source=source, prompt_bucket=prompt_bucket, gen_bucket=gen_bucket)


def test_bucket_of_rounds_up_to_edges():
    cfg = get_config("deepseek-moe-16b").reduced()
    s = _stub_session(cfg, _CountingSource())
    assert s.bucket_of(Workload(4, 1, 1)) == WorkloadBucket(4, 32, 16)
    assert s.bucket_of(Workload(4, 32, 16)) == WorkloadBucket(4, 32, 16)
    assert s.bucket_of(Workload(4, 33, 17)) == WorkloadBucket(4, 64, 32)
    assert s.bucket_of(Workload(2, 0, 0)) == WorkloadBucket(2, 32, 0)
    assert WorkloadBucket(4, 32, 16).describe() == "B=4,S<=32,gen<=16"


def test_plan_cache_hit_and_miss():
    cfg = get_config("deepseek-moe-16b").reduced()
    src = _CountingSource()
    s = _stub_session(cfg, src)
    p1 = s.plan_for(Workload(4, 10, 8))
    p2 = s.plan_for(Workload(4, 30, 12))  # same bucket (32, 16)
    assert p1 is p2 and len(src.calls) == 1
    assert (s.hits, s.misses) == (1, 1)
    s.plan_for(Workload(4, 40, 8))  # prompt bucket 64 -> miss
    s.plan_for(Workload(2, 10, 8))  # batch differs -> miss
    assert len(src.calls) == 3 and (s.hits, s.misses) == (1, 3)
    assert src.calls[0].prompt == 32 and src.calls[0].gen == 16
    assert set(s.cached_plans) == {WorkloadBucket(4, 32, 16), WorkloadBucket(4, 64, 16), WorkloadBucket(2, 32, 16)}


def test_source_one_liners():
    cfg = get_config("deepseek-moe-16b").reduced()
    pinned = fixed_plan("TP2", "EP2")
    assert HAPSession(cfg, "a6000", 2, source=pinned).plan_for(Workload(1, 8, 8)) is pinned
    assert HAPSession(cfg, "a6000", 2, source=FixedPlanSource(pinned)).plan_for(Workload(1, 8, 8)) is pinned
    got = HAPSession(cfg, "a6000", 2, source="attn=TP2,prefill=EP2,decode=TP2").plan_for(Workload(1, 8, 8))
    assert got.expert_prefill == ExpertStrategy(tp=1, ep=2) and got.switches
    with pytest.raises(ValueError):
        StaticPlanSource(object(), kind="dp")


def test_malformed_source_spec_raises_not_falls_back():
    cfg = get_config("deepseek-moe-16b").reduced()
    for spec in ("attn=TP4;prefill=EP4", "atn=TP4,prefill=EP4", "TP4"):
        s = HAPSession(cfg, "a6000", 2, source=spec)
        with pytest.raises(ValueError):
            s.plan_for(Workload(1, 8, 8))


def test_failing_source_degrades_to_static_fallback(models):
    """A source that raises degrades to the planner's static TP plan (the
    reference's fallback) and is counted; ``fallback=""`` re-raises."""

    class _Failing:
        def plan_for(self, w):
            raise ValueError("infeasible")

    cfg = reduced("deepseek-moe-16b")
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32")
    s = HAPSession(cfg_t, "a6000", 2, source=_Failing(), model=models[1])
    plan = s.plan_for(Workload(2, 8, 8))
    assert s.fallbacks == 1 and plan.describe() == s.planner.tp_plan().describe()
    from repro.core.session import HAPSession as JaxSession

    js = JaxSession(cfg, "a6000", 2, source=_Failing(), model=models[0])
    assert js.plan_for(jflops.Workload(2, 8, 8)).describe() == plan.describe()
    with pytest.raises(ValueError):
        HAPSession(cfg_t, "a6000", 2, source=_Failing(), fallback="").plan_for(Workload(2, 8, 8))


def test_session_transition_between():
    cfg = get_config("deepseek-moe-16b").reduced()
    s = _stub_session(cfg, _CountingSource())
    a, b = fixed_plan("TP1", "EP2", "EP2"), fixed_plan("TP1", "EP2", "TP2")
    assert s.transition_between(a, b, Workload(1, 8, 8)) == ("none", 0.0)
