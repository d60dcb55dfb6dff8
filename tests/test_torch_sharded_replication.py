"""Hot-expert replication and predictive prefetch on two gloo ranks against
the JAX engine on a two-device mesh ``(1, 2)`` of ``('data', 'model')``.

One JAX subprocess serves every scenario below through
``HAPSession(..., mesh=mesh).engine(...)``; one pair of gloo ranks does the
same through the port, each rank from its shard of the same weights.
Tokens and the routing, replication and prefetch counters must equal the
JAX engine's, and the two ranks' results must be equal. Under EP2 the slot
count is padded to a multiple of two (``align=2``), each rank lays out its
half of the slots, and the experts of its slots that another rank holds
arrive by point-to-point exchange. Teacher-forced logits under a replica
set on EP2 within 1e-4 of the reference's. The prefetch scenarios mirror
``tests/test_prefetch.py:333`` (``test_ep2_mesh_prefetch_token_exact``).
Reduced DeepSeekMoE-16B in float32, capacity factor 8, with the doctored
router of ``tests/test_replication.py`` (expert 0 in every token's top-2).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_sharded import load_tree, run_jax, run_ranks  # noqa: E402

PROMPTS = ([1, 2, 3, 4, 5], list(range(2, 14)), [3, 1, 4])
GEN = 8
COUNTERS = ("batches", "decode_steps", "prefill_chunks", "fused_steps", "routing_steps", "replication_rebalances",
            "prefetch_predicted", "async_restores")
REP = {"replicate_experts": 2, "rebalance_interval": 4}
INT4 = {"use_int4_transition": True}
PREFETCH = {"prefetch": True, "prefetch_top_p": 0.9}

# name -> (plan (attn, prefill, decode, mechanism), engine keywords, continuous)
SCENARIOS = {
    "ep2_rep": (("TP2", "EP2", "", "reshard"), REP, False),
    "ep2_rep_continuous": (("TP2", "EP2", "", "reshard"), REP, True),
    "tp2_rep": (("TP2", "TP2", "", "reshard"), REP, False),
    "ep2_rep_resident": (("TP2", "EP2", "", "reshard"), {**REP, "resident_int4": True}, False),
    "ep2_prefetch_off": (("TP1", "TP2", "EP2", "int4_upload"), INT4, False),
    "ep2_prefetch": (("TP1", "TP2", "EP2", "int4_upload"), {**INT4, **PREFETCH}, False),
    "switch_rep_prefetch": (("TP2", "TP2", "EP2", "int4_upload"), {**INT4, **REP, **PREFETCH}, False),
}
# teacher-forced logits under a replica set: (attn, experts, degrees, order)
LOGITS = {"ep2": ("TP2", "EP2", (3, 1, 1, 1), (1, 0, 3, 2)), "tp2": ("TP2", "TP2", (2, 1, 1, 2), (3, 2, 1, 0))}
LOGIT_STEPS = 3

_JAX = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core import HAPSession
from repro.core.hap import fixed_plan
from repro.models import init_params
from repro.models.transformer import decode_step, prefill
from repro.serving import Request
from repro.sharding.specs import ExpertReplication
from torch_sharded import save_tree

out, scen, logit_scen = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
prompts, gen, counters, steps = json.loads(sys.argv[4])
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ('data', 'model'))
cfg = dataclasses.replace(get_config('deepseek-moe-16b').reduced(), dtype='float32', capacity_factor=8.0)
params = init_params(cfg, jax.random.PRNGKey(0))
router = np.asarray(params['layers']['moe']['router'], np.float32)
L, d, E = router.shape
v = np.random.default_rng(3).normal(size=d).astype(np.float32)
doctored = np.broadcast_to(-v[None, :, None], (L, d, E)).copy()
doctored[:, :, 1] = v
params['layers']['moe']['router'] = jnp.asarray(doctored)
save_tree(f"{out}/params.npz", params)

res = {}
for name, (plan, kw, cont) in scen.items():
    session = HAPSession(cfg, 'a6000', 2, source=fixed_plan(plan[0], plan[1], plan[2], mechanism=plan[3]),
                         mesh=mesh, prompt_bucket=16, gen_bucket=8)
    eng = session.engine(params, cfg=cfg, max_batch=2, **kw)
    if cont:
        eng.scheduler.bucket = 16
    for q in prompts:
        eng.submit(Request(prompt=q, max_new_tokens=gen))
    comps = eng.serve_continuous() if cont else eng.run()
    rep = eng._replication
    s = eng.stats
    res[name] = {"tokens": [c.tokens for c in comps], "stats": {k: getattr(s, k) for k in counters},
                 "barrier_rows": s.prefetch_hits + s.prefetch_misses,
                 "rep": None if rep is None else [list(rep.degrees), list(rep.order)]}

toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
logits = {}
for name, (attn, experts, degrees, order) in logit_scen.items():
    splan = fixed_plan(attn, experts).to_sharding_plan(mesh, cfg, phase='decode')
    splan = dataclasses.replace(splan, replication=ExpertReplication(tuple(degrees), tuple(order)))
    pf = jax.jit(lambda p, b: prefill(p, cfg, b, max_len=16, plan=splan))
    df = jax.jit(lambda p, t, c: decode_step(p, cfg, t, c, plan=splan))
    lg, cache = pf(params, {'tokens': jnp.asarray(toks)})
    seq = [np.asarray(lg)]
    for s in range(steps):
        lg, cache = df(params, jnp.asarray(toks[:, s:s + 1]), cache)
        seq.append(np.asarray(lg))
    logits[name] = np.stack(seq)
np.savez(f"{out}/logits.npz", **logits)
json.dump(res, open(f"{out}/serving.json", "w"))
print("OK")
"""


def _config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)


def ranks_replication(mesh, data: str, scenarios: dict, logit_scenarios: dict):
    """One rank: every scenario through the port's engine from this rank's
    shard of the JAX weights, and the teacher-forced logits under a replica
    set (the slot-layout leaves cut to this rank's shard)."""
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import decode_step, params_from_numpy, prefill
    from repro_torch.models.moe import slot_weights
    from repro_torch.models.params import shard_params
    from repro_torch.serving import Request
    from repro_torch.sharding.specs import ExpertReplication

    torch.set_num_threads(1)
    cfg = _config()
    whole = load_tree(f"{data}/params.npz")
    res = {}
    for name, (plan, kw, cont) in scenarios.items():
        hap = fixed_plan(plan[0], plan[1], plan[2], mechanism=plan[3])
        splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
        params = params_from_numpy(shard_params(whole, cfg, splan, mesh.rank), "cpu")
        session = HAPSession(cfg, "a6000", 2, source=hap, mesh=mesh, prompt_bucket=16, gen_bucket=8)
        eng = session.engine(params, device="cpu", max_batch=2, params_plan=splan, **kw)
        if cont:
            eng.scheduler.bucket = 16
        for q in PROMPTS:
            eng.submit(Request(prompt=q, max_new_tokens=GEN))
        comps = eng.serve_continuous() if cont else eng.run()
        rep = eng._replication
        s = eng.stats
        res[name] = {"tokens": [c.tokens for c in comps], "stats": dataclasses.asdict(s),
                     "barrier_rows": s.prefetch_hits + s.prefetch_misses,
                     "rep": None if rep is None else [list(rep.degrees), list(rep.order)],
                     "slots": None if eng._slots is None else eng._slots.total_slots,
                     "rows": int(eng.params["layers"]["moe"]["wi_gate"].shape[1])}
        eng.close()
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]])
    logits = {}
    for name, (attn, experts, degrees, order) in logit_scenarios.items():
        rep = ExpertReplication(tuple(degrees), tuple(order))
        splan = dataclasses.replace(fixed_plan(attn, experts).to_sharding_plan(mesh, cfg, phase="decode"),
                                    replication=rep)
        moe_p = dict(whole["layers"]["moe"])
        for k in ("wi_gate", "wi_up", "wo"):
            moe_p[k] = slot_weights(torch.from_numpy(moe_p[k]), rep, dim=1).numpy()
        slotted = dict(whole, layers=dict(whole["layers"], moe=moe_p))
        params = params_from_numpy(shard_params(slotted, cfg, splan, mesh.rank), "cpu")
        with torch.inference_mode():
            lg, cache = prefill(params, cfg, {"tokens": toks}, 16, plan=splan)
            seq = [lg.numpy()]
            for s in range(LOGIT_STEPS):
                lg, cache = decode_step(params, cfg, toks[:, s:s + 1], cache, plan=splan)
                seq.append(lg.numpy())
        logits[name] = np.stack(seq)
    return res, logits


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX engine's results, the port's two ranks' results)."""
    work = tmp_path_factory.mktemp("sharded_replication")
    run_jax(_JAX, str(work), json.dumps(SCENARIOS), json.dumps(LOGITS),
            json.dumps([PROMPTS, GEN, COUNTERS, LOGIT_STEPS]), timeout=600)
    with open(work / "serving.json") as f:
        jax_res = json.load(f)
    with np.load(work / "logits.npz") as z:
        jax_logits = {k: z[k] for k in z.files}
    ranks = run_ranks("test_torch_sharded_replication:ranks_replication", work / "ranks", timeout=600,
                      data=str(work), scenarios=SCENARIOS, logit_scenarios=LOGITS)
    return (jax_res, jax_logits), ranks


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_counters_equal_jax_engine(both, name):
    (jax_res, _), ranks = both
    got, other = ranks[0][0][name], ranks[1][0][name]
    assert got["tokens"] == other["tokens"] == jax_res[name]["tokens"]
    assert all(len(t) == GEN for t in got["tokens"])
    assert {k: got["stats"][k] for k in COUNTERS} == jax_res[name]["stats"]
    assert got["barrier_rows"] == jax_res[name]["barrier_rows"]
    assert got["rep"] == other["rep"] == jax_res[name]["rep"]
    if "replicate_experts" in SCENARIOS[name][1]:
        assert got["stats"]["replication_rebalances"] >= 1 and got["rep"][0][0] == max(got["rep"][0])
        slots = sum(got["rep"][0])
        assert got["slots"] == slots and slots % 2 == 0  # align=2
        # EP: this rank's half of the slots; TP: every slot, its d_ff shard
        assert got["rows"] == (slots if name == "tp2_rep" else slots // 2)
    if "prefetch" in SCENARIOS[name][1]:
        assert got["stats"]["prefetch_hits"] > 0 and got["stats"]["prefetch_errors"] == 0


def test_prefetch_and_replication_keep_tokens(both):
    """Prefetch on equals prefetch off; replication changes no token (the
    capacity never binds)."""
    _, ranks = both
    res = ranks[0][0]
    assert res["ep2_prefetch"]["tokens"] == res["ep2_prefetch_off"]["tokens"]
    assert res["ep2_prefetch_off"]["stats"]["routing_steps"] == 0


def test_ep2_rebalance_exchanges_rows(both):
    """Under EP2 a rebalance fetches the slots' experts that the other rank
    holds (here rank 1 receives a replica of expert 1 from rank 0), counted
    as reshard bytes; under TP2 every rank holds every
    expert's columns and exchanges nothing."""
    _, ranks = both
    assert sum(ranks[r][0]["ep2_rep"]["stats"]["reshard_bytes"] for r in (0, 1)) > 0
    assert all(ranks[r][0]["tp2_rep"]["stats"]["reshard_bytes"] == 0 for r in (0, 1))


@pytest.mark.parametrize("name", list(LOGITS))
def test_replicated_logits_equal_jax_model(both, name):
    (_, jax_logits), ranks = both
    got = ranks[0][1][name]
    np.testing.assert_array_equal(got, ranks[1][1][name])
    np.testing.assert_allclose(got, jax_logits[name], rtol=1e-4, atol=1e-4)
