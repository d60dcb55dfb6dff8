"""The port's hot-expert replication against the JAX package.

Mirrors ``tests/test_replication.py`` case for case: the
``ExpertReplication`` placement, ``replica_coords`` and ``slot_weights``
(exact), the water-filling degrees, ``OneHotIlp``, the routing tracker's
EMA and co-fire affinity, ``affinity_order`` and ``plan_replication``
(equal outputs, over seeded random inputs), the MoE layer and decode step
under a replica set (logits at 1e-4, router top-k equal), and the engine's
rebalance hook with the doctored router of the reference test (expert 0 in
every token's top-2): tokens, ``routing_steps``,
``replication_rebalances`` and the final degrees and order equal the JAX
engine's, through ``run()`` and ``serve_continuous()``, dense and resident
INT4. Reduced DeepSeekMoE-16B in float32 on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import ilp as jilp  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import decode_step as jdecode_step  # noqa: E402
from repro.models.transformer import prefill as jprefill  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import replication as jrepl  # noqa: E402
from repro.sharding.specs import NULL_PLAN as JNULL_PLAN  # noqa: E402
from repro.sharding.specs import ExpertReplication as JRep  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import fixed_plan, ilp  # noqa: E402
from repro_torch.core.transition import TransitionExecutor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decode_step, params_from_numpy, prefill  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import InferenceEngine, Request  # noqa: E402
from repro_torch.serving import replication as repl  # noqa: E402
from repro_torch.sharding.specs import NULL_PLAN, ExpertReplication  # noqa: E402

SEEDS = (0, 1, 2)
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")
PROMPTS = ([1, 2, 3, 4], [9, 8, 7])
GEN = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ExpertReplication placement
# ---------------------------------------------------------------------------
def _same_rep(a, b):
    return (a.degrees, a.order, a.total_slots, a.is_identity, a.slot_to_expert(), a.expert_offsets()) == (
        b.degrees, b.order, b.total_slots, b.is_identity, b.slot_to_expert(), b.expert_offsets())


def test_expert_replication_slot_layout():
    rep = ExpertReplication((2, 1, 3), order=(2, 0, 1))
    assert rep.n_experts == 3 and rep.total_slots == 6 and not rep.is_identity
    assert rep.slot_to_expert() == (2, 2, 2, 0, 0, 1)
    assert rep.expert_offsets() == (3, 5, 0)
    assert _same_rep(rep, JRep((2, 1, 3), order=(2, 0, 1)))


def test_expert_replication_identity_and_validation():
    assert ExpertReplication((1, 1)).is_identity
    assert ExpertReplication((1, 1)).order == (0, 1)
    assert not ExpertReplication((1, 1), order=(1, 0)).is_identity
    with pytest.raises(ValueError, match="permutation"):
        ExpertReplication((1, 1), order=(0, 0))
    with pytest.raises(ValueError, match=">= 1"):
        ExpertReplication((1, 0))
    # a replica set rides on the (hashable) plan, as in the reference
    plan = dataclasses.replace(NULL_PLAN, replication=ExpertReplication((2, 1)))
    assert plan.is_null and hash(plan) == hash(dataclasses.replace(NULL_PLAN, replication=ExpertReplication((2, 1))))


def _random_rep(rng, E=5):
    return ExpertReplication(tuple(int(d) for d in rng.integers(1, 4, size=E)), tuple(rng.permutation(E).tolist()))


@pytest.mark.parametrize("seed", SEEDS)
def test_replica_coords_equal_reference(seed):
    """Token copy p of expert e lands on replica p % degree(e) in the
    expert's slot block; the reference's round-robin example, then seeded
    random dispatches."""
    rep = ExpertReplication((2, 1), order=(0, 1))
    slot, pos = moe.replica_coords(torch.tensor([0, 0, 0, 0, 1, 1]), torch.tensor([0, 1, 2, 3, 0, 1]), rep)
    assert slot.tolist() == [0, 1, 0, 1, 2, 2] and pos.tolist() == [0, 0, 1, 1, 0, 1]
    rng = np.random.default_rng(seed)
    rep = _random_rep(rng)
    fe = rng.integers(0, 5, size=40)
    pe = rng.integers(0, 12, size=40)
    got = moe.replica_coords(torch.from_numpy(fe), torch.from_numpy(pe), rep)
    want = jmoe.replica_coords(jnp.asarray(fe), jnp.asarray(pe), JRep(rep.degrees, rep.order))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_slot_weights_equal_reference(seed):
    """Dense leaves and resident ``QuantizedExpert`` leaves alike."""
    rep = ExpertReplication((1, 2), order=(1, 0))
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(moe.slot_weights(torch.from_numpy(w), rep).numpy(), w[[1, 1, 0]])
    rng = np.random.default_rng(seed)
    rep = _random_rep(rng)
    w = rng.standard_normal((5, 4, 64)).astype(np.float32)
    got = moe.slot_weights(torch.from_numpy(w), rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmoe.slot_weights(jnp.asarray(w), JRep(rep.degrees,
                                                                                                  rep.order))))
    qe = ops.QuantizedExpert(torch.from_numpy(rng.integers(0, 255, (5, 4, 2, 16), dtype=np.uint8)),
                             torch.from_numpy(rng.random((5, 4, 2, 1), dtype=np.float32)),
                             torch.from_numpy(rng.random((5, 4, 2, 1), dtype=np.float32)))
    got = moe.slot_weights(qe, rep)
    for a in ("packed", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(got, a).numpy(), getattr(qe, a).numpy()[list(rep.slot_to_expert())])


@pytest.mark.parametrize("seed", SEEDS)
def test_reslot_one_device_equals_slot_weights(seed):
    """``TransitionExecutor.reslot`` (the engine's relayout at a rebalance)
    from expert layout equals ``slot_weights`` on the expert dim of a
    stacked leaf, from one slot layout to another equals the direct
    layout, and back to expert layout is the identity."""
    rng = np.random.default_rng(seed)
    a, b = _random_rep(rng), _random_rep(rng)
    w = torch.from_numpy(rng.standard_normal((3, 5, 4, 8)).astype(np.float32))
    E = tuple(range(5))
    sa, n = TransitionExecutor.reslot(w, E, a.slot_to_expert())
    assert n == 0 and torch.equal(sa, moe.slot_weights(w, a, dim=1))
    sb, _ = TransitionExecutor.reslot(sa, a.slot_to_expert(), b.slot_to_expert())
    assert torch.equal(sb, moe.slot_weights(w, b, dim=1))
    back, _ = TransitionExecutor.reslot(sb, b.slot_to_expert(), E)
    assert torch.equal(back, w)


# ---------------------------------------------------------------------------
# water-filling degrees and the one-hot ILP
# ---------------------------------------------------------------------------
def test_replication_degrees_water_filling():
    for freqs, extra, want in (([0.7, 0.1, 0.1, 0.1], 2, (3, 1, 1, 1)), ([0.6, 0.3, 0.1], 1, (2, 1, 1)),
                               ([0.6, 0.3, 0.1], 2, (3, 1, 1)), ([0.6, 0.3, 0.1], 3, (3, 2, 1)),
                               ([0.25] * 4, 0, (1, 1, 1, 1))):
        assert ilp.replication_degrees(freqs, extra) == want == jilp.replication_degrees(freqs, extra)


def test_replication_degrees_max_degree_and_degenerate():
    for args, kw, want in ((([0.9, 0.05, 0.05], 3), {"max_degree": 2}, (2, 2, 2)),
                           (([0.9, 0.1], 5), {"max_degree": 2}, (2, 2)), (([0.0, 0.0], 2), {}, (2, 2)),
                           (([], 3), {}, ())):
        assert ilp.replication_degrees(*args, **kw) == want == jilp.replication_degrees(*args, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_degrees_equal_reference_random(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        f = rng.dirichlet(np.full(8, 0.3))
        extra, cap = int(rng.integers(0, 9)), [None, 2, 3][int(rng.integers(0, 3))]
        assert ilp.replication_degrees(f, extra, cap) == jilp.replication_degrees(f, extra, cap)
        kw = dict(gain_scale=float(rng.random()), cost_per_replica=float(rng.random()) * 0.1, max_extra=extra,
                  max_degree=cap)
        assert ilp.searched_replication_degrees(f, **kw) == jilp.searched_replication_degrees(f, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_hot_ilp_equals_reference(seed):
    """The generic one-hot 0-1 ILP (exact branch and bound) on seeded random
    problems with couplings and forbidden pairs, and an infeasible one."""
    rng = np.random.default_rng(seed)
    blocks = [[0, 1, 2], [3, 4], [5, 6, 7]]
    c = rng.standard_normal(8)
    Q = rng.standard_normal((8, 8)) * 0.5
    forbidden = [(0, 3), (4, 5)]
    got = ilp.OneHotIlp(c, Q, blocks, forbidden).solve()
    want = jilp.OneHotIlp(c, Q, blocks, forbidden).solve()
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-12)
    assert ilp.OneHotIlp(c, None, blocks).solve()[0] == jilp.OneHotIlp(c, None, blocks).solve()[0]
    with pytest.raises(ValueError, match="infeasible"):
        ilp.OneHotIlp(c[:4], None, [[0, 1], [2, 3]], [(0, 2), (0, 3), (1, 2), (1, 3)]).solve()


# ---------------------------------------------------------------------------
# routing tracker, affinity order, replication plans
# ---------------------------------------------------------------------------
def _pair(L, E, ema=0.9):
    return repl.RoutingTracker(L, E, ema=ema), jrepl.RoutingTracker(L, E, ema=ema)


def _same_tracker(a, b):
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.affinity, b.affinity)
    np.testing.assert_array_equal(a.frequencies(), b.frequencies())
    np.testing.assert_array_equal(a.layer_frequencies(), b.layer_frequencies())
    assert a.steps == b.steps


def test_tracker_ema_decay_math():
    tr = repl.RoutingTracker(n_layers=1, n_experts=3, ema=0.5)
    tr.update(np.array([[[0, 1], [0, 2]]]))
    np.testing.assert_allclose(tr.counts[0], [1.0, 0.5, 0.5])
    tr.update(np.zeros((1, 2, 2), np.int64))
    np.testing.assert_allclose(tr.counts[0], [2.5, 0.25, 0.25])
    assert tr.steps == 2 and int(np.argmax(tr.frequencies())) == 0


def test_tracker_topk_ties_and_single_layer_block():
    tr = repl.RoutingTracker(n_layers=1, n_experts=2, ema=0.0)
    tr.update(np.array([[[0, 0], [0, 1]]]))
    np.testing.assert_allclose(tr.counts[0], [3.0, 1.0])
    tr = repl.RoutingTracker(n_layers=2, n_experts=2, ema=0.0)
    tr.update(np.array([[0, 1]]))
    np.testing.assert_allclose(tr.counts, [[1.0, 1.0], [0.0, 0.0]])
    with pytest.raises(ValueError):
        repl.RoutingTracker(1, 2, ema=1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_tracker_affinity_and_order_equal_reference(seed):
    """The reference's co-fire example, then seeded random top-k blocks:
    counts, affinity, frequencies and the greedy co-fire order equal."""
    t, j = _pair(2, 4, ema=0.0)
    block = np.array([[[2, 1], [2, 2]], [[0, 3], [0, 3]]])
    t.update(block)
    j.update(block)
    assert repl.affinity_order(t)[:2] == (2, 0) == jrepl.affinity_order(j)[:2]
    rng = np.random.default_rng(seed)
    t, j = _pair(3, 6, ema=0.8)
    for _ in range(6):
        block = rng.integers(0, 6, size=(3, 5, 2))
        t.update(block)
        j.update(block)
    _same_tracker(t, j)
    assert repl.affinity_order(t) == jrepl.affinity_order(j)


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_replication_equals_reference(seed):
    """Deterministic, aligned, capped and with searched degrees: the same
    replica sets as the reference's."""
    rng = np.random.default_rng(seed)
    t, j = _pair(2, 6)
    for _ in range(5):
        block = rng.integers(0, 6, size=(2, 6, 2))
        t.update(block)
        j.update(block)
    for kw in ({}, {"align": 4}, {"max_degree": 2}, {"degrees": (1, 3, 1, 1, 2, 1)}):
        for extra in (1, 2, 3):
            got, want = repl.plan_replication(t, extra, **kw), jrepl.plan_replication(j, extra, **kw)
            assert _same_rep(got, want)
            assert got == repl.plan_replication(t, extra, **kw)  # identical snapshot, identical plan
    assert repl.plan_replication(t, 1, align=4).total_slots % 4 == 0
    with pytest.raises(ValueError, match="degrees"):
        repl.plan_replication(t, 1, degrees=(0, 1, 1, 1, 1, 1))


def test_replication_summary_load_accounting():
    s = repl.replication_summary(ExpertReplication((2, 1)), [0.8, 0.2])
    assert s == jrepl.replication_summary(JRep((2, 1)), [0.8, 0.2])
    assert s["total_slots"] == 3 and s["max_load_replicated"] == pytest.approx(0.4)


# ---------------------------------------------------------------------------
# the MoE layer and the decode step under a replica set
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _skewed(capacity_factor=8.0):
    """The reference test's doctored router: expert 1 projects onto +v and
    everyone else onto -v, so expert 0 is in every token's top-2."""
    cfg_j = reduced("deepseek-moe-16b", capacity_factor=capacity_factor)
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32",
                                capacity_factor=capacity_factor)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    router = np.asarray(jparams["layers"]["moe"]["router"], np.float32)
    L, d, E = router.shape
    v = np.random.default_rng(3).normal(size=d).astype(np.float32)
    doctored = np.broadcast_to(-v[None, :, None], (L, d, E)).copy()
    doctored[:, :, 1] = v
    jparams["layers"]["moe"]["router"] = jnp.asarray(doctored)
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def _slot_params(params, rep):
    """The params tree with its expert leaves in ``rep``'s slot layout (as
    the engine lays them out at a rebalance)."""
    moe_p = dict(params["layers"]["moe"], **{k: moe.slot_weights(params["layers"]["moe"][k], rep, dim=1)
                                             for k in EXPERT_LEAVES})
    return dict(params, layers=dict(params["layers"], moe=moe_p))


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_apply_moe_replicated_equals_reference(cf):
    """The local path with a replica set: the port on slot-layout leaves,
    the reference gathering them in-jit. At capacity factor 8 nothing drops
    and it also equals the unreplicated layer; at 1 the per-slot capacity
    drops other copies than one expert's capacity would, in both packages
    alike."""
    cfg_j, cfg_t, jparams, tparams = _skewed(cf)
    rep = ExpertReplication((3, 1, 2, 1), order=(0, 2, 1, 3))
    x = np.random.default_rng(5).standard_normal((2, 12, cfg_t.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["moe"])
    lp_t = {k: v[0] for k, v in _slot_params(tparams, rep)["layers"]["moe"].items()}
    plan = dataclasses.replace(NULL_PLAN, replication=rep)
    got = moe.apply_moe(torch.from_numpy(x), lp_t, cfg_t, backend="ref", plan=plan)
    want = jmoe.apply_moe(jnp.asarray(x), lp_j, cfg_j,
                          dataclasses.replace(JNULL_PLAN, replication=JRep(rep.degrees, rep.order)), backend="ref")
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.route_idx.numpy(), np.asarray(want.route_idx))
    if cf == 8.0:
        plain = moe.apply_moe(torch.from_numpy(x), {k: v[0] for k, v in tparams["layers"]["moe"].items()}, cfg_t,
                              backend="ref")
        np.testing.assert_allclose(got.y.numpy(), plain.y.numpy(), rtol=1e-5, atol=1e-5)


def test_decode_step_collects_routing_and_replicated_logits():
    """Teacher-forced logits of prefill + decode steps under a replica set
    within 1e-4 of the reference's, and ``collect_routing``'s (L, B, k)
    int32 top-k equal to the reference's ``route_topk``."""
    cfg_j, cfg_t, jparams, tparams = _skewed()
    rep = ExpertReplication((2, 1, 1, 2), order=(3, 0, 1, 2))
    jplan = dataclasses.replace(JNULL_PLAN, replication=JRep(rep.degrees, rep.order))
    tplan = dataclasses.replace(NULL_PLAN, replication=rep)
    sp = _slot_params(tparams, rep)
    toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
    jl, jc = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(toks)}, max_len=16, plan=jplan, backend="ref")
    with torch.inference_mode():
        tl, tc = prefill(sp, cfg_t, {"tokens": torch.from_numpy(toks).long()}, 16, backend="ref", plan=tplan)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        for s in range(3):
            tok = toks[:, s:s + 1]
            jl, jc = jdecode_step(jparams, cfg_j, jnp.asarray(tok), jc, plan=jplan, backend="ref",
                                  collect_routing=True)
            tl, tc = decode_step(sp, cfg_t, torch.from_numpy(tok).long(), tc, backend="ref", plan=tplan,
                                 collect_routing=True)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
            assert tc.route_topk.dtype == torch.int32 and tuple(tc.route_topk.shape) == (2, 2, cfg_t.top_k)
            np.testing.assert_array_equal(tc.route_topk.numpy(), np.asarray(jc.route_topk))
            jc = jc._replace(route_topk=None)
        _, plain = decode_step(tparams, cfg_t, torch.from_numpy(toks[:, :1]).long(), tc, backend="ref")
        assert plain.route_topk is None


# ---------------------------------------------------------------------------
# the engine: the rebalance hook against the JAX engine
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(interval: int, continuous: bool, resident: bool = False, switching: bool = False):
    cfg_j, _, jparams, _ = _skewed()
    kw = dict(resident_int4=True) if resident else {}
    if switching:
        kw.update(hap_plan=jfixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), use_int4_transition=True)
    eng = JaxEngine(cfg_j, jparams, max_batch=2, replicate_experts=2, rebalance_interval=interval, **kw)
    for p in PROMPTS:
        eng.submit(JaxRequest(p, max_new_tokens=GEN))
    out = eng.serve_continuous() if continuous else eng.run()
    rep = eng._replication
    return ([c.tokens for c in out], eng.stats.routing_steps, eng.stats.replication_rebalances,
            None if rep is None else (rep.degrees, rep.order), eng._tracker.frequencies())


def _port_run(interval, continuous, resident=False, switching=False, **extra):
    _, cfg_t, _, tparams = _skewed()
    kw = dict(resident_int4=True) if resident else {}
    if switching:
        kw.update(hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"), use_int4_transition=True)
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, replicate_experts=2,
                          rebalance_interval=interval, **kw, **extra)
    for p in PROMPTS:
        eng.submit(Request(p, max_new_tokens=GEN))
    out = eng.serve_continuous() if continuous else eng.run()
    return eng, [c.tokens for c in out]


@pytest.mark.parametrize("continuous", [False, True], ids=["run", "continuous"])
@pytest.mark.parametrize("interval", [4, 6, 64])
def test_engine_rebalance_equals_jax_engine(interval, continuous):
    """Tokens, routing steps, rebalances and the final replica set equal
    the JAX engine's; the expert leaves are laid out in the replica set's
    slots (built at the rebalance, no per-step gather); the hot expert
    holds the highest degree."""
    toks, steps, rebalances, rep, freqs = _jax_run(interval, continuous)
    eng, got = _port_run(interval, continuous)
    assert got == toks
    assert eng.stats.routing_steps == steps and eng.stats.replication_rebalances == rebalances
    np.testing.assert_allclose(eng._tracker.frequencies(), freqs, rtol=1e-12)
    mine = eng._replication
    assert (None if mine is None else (mine.degrees, mine.order)) == rep
    assert eng._slots == mine
    slots = mine.total_slots if mine is not None else eng.cfg.n_routed_experts
    assert all(eng.params["layers"]["moe"][k].shape[1] == slots for k in EXPERT_LEAVES)
    if interval == 64:
        assert rebalances == 0 and mine is None and steps > 0
    else:
        assert rebalances >= 1 and mine.degrees[0] == max(mine.degrees) >= 2
    assert eng.stats.replication_search_errors == 0 and eng.stats.background_errors == 0
    if interval == 6 and not continuous:
        assert rebalances == 1 and 6 <= steps < 12  # one boundary in the budget
        plain = InferenceEngine(eng.cfg, _skewed()[3], device="cpu", max_batch=2)
        for p in PROMPTS:
            plain.submit(Request(p, max_new_tokens=GEN))
        assert [c.tokens for c in plain.run()] == got  # capacity never binds
    eng.close()


@pytest.mark.parametrize("switching", [False, True], ids=["fixed", "int4_switching"])
@pytest.mark.parametrize("resident", [False, True], ids=["dense", "resident"])
def test_engine_rebalance_resident_and_switching_equal_jax(resident, switching):
    """Resident INT4 slot leaves (packed, scales and zeros laid out alike),
    and the INT4 switching plan, whose restores land expert rows that are
    then laid out in slots: tokens and counters equal the JAX engine's."""
    toks, steps, rebalances, rep, _ = _jax_run(4, False, resident, switching)
    eng, got = _port_run(4, False, resident, switching)
    assert got == toks
    assert (eng.stats.routing_steps, eng.stats.replication_rebalances) == (steps, rebalances)
    assert (eng._replication.degrees, eng._replication.order) == rep
    if resident:
        assert isinstance(eng.params["layers"]["moe"]["wo"], ops.QuantizedExpert)
        assert eng.params["layers"]["moe"]["wo"].packed.shape[1] == eng._replication.total_slots
    eng.close()


def test_backup_from_slot_layout_is_expert_layout():
    """A backup taken while a replica set is live takes each expert from
    its first replica: bit-equal to a backup of the expert-layout leaf."""
    _, cfg_t, _, tparams = _skewed()
    eng, _ = _port_run(4, False)
    assert eng._slots is not None
    eng._backup_leaf("wi_up")
    ref = TransitionExecutor("cpu")
    ref.backup("w", tparams["layers"]["moe"]["wi_up"])
    for a in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(eng._tx._backups["moe/wi_up"], a), getattr(ref._backups["w"], a))
    eng.close()


def test_rebalance_fires_after_skipped_boundary():
    """Cadence is steps since the last rebalance, not ``steps % interval``."""
    _, cfg_t, _, tparams = _skewed()
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=1, replicate_experts=2, rebalance_interval=4)
    topk = np.zeros((cfg_t.num_layers, 2, 2), np.int64)
    for _ in range(5):
        eng._tracker.update(topk)
    assert eng._maybe_rebalance()
    assert eng.stats.replication_rebalances == 1 and eng._last_rebalance_step == 5
    assert eng._sharding_for("decode").replication == eng._replication  # a new plan, new step keys
    eng._tracker.update(topk)
    assert not eng._maybe_rebalance()
    for _ in range(3):
        eng._tracker.update(topk)
    assert eng._maybe_rebalance() or eng._last_rebalance_step == 9


def test_engine_replicate_requires_moe():
    dense = get_config("mistral-nemo-12b").reduced()
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(dense, {}, device="cpu", replicate_experts=2)
    _, cfg_t, _, tparams = _skewed()
    with pytest.raises(ValueError, match=">= 0"):
        InferenceEngine(cfg_t, tparams, device="cpu", replicate_experts=-1)


def test_rebalance_keys_steps_by_replica_set_and_drops_old_graphs():
    """A rebalance is a new plan and a new weights generation: the step
    graphs that read the expert-layout leaves are dropped, and the steps
    after it are keyed by a plan carrying the replica set (the reference's
    re-trace)."""
    _, cfg_t, _, tparams = _skewed()
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2, replicate_experts=2, rebalance_interval=4)
    eng.submit(Request(PROMPTS[0], max_new_tokens=GEN))
    eng.run()
    rep = eng._replication
    assert rep is not None and eng.steps.stats.dropped >= 1
    keys = eng.steps.keys()
    assert keys and all(k[1] is not None and k[1].replication == rep for k in keys)
    assert all(k[-3] == eng.steps.weights_gen for k in keys)
    eng.close()
