"""The port's sharded serving on two gloo ranks against the JAX engine on a
two-device mesh ``(1, 2)`` of ``('data', 'model')``.

One JAX subprocess (two forced host devices) serves every scenario below
through ``HAPSession(..., mesh=mesh).engine(...)`` and writes the tokens,
the ``EngineStats`` counters and the teacher-forced logits of the model
under each plan; one pair of gloo ranks does the same through the port's
``HAPSession(..., mesh=RankMesh).engine(...)``, each rank holding only its
shard of the same weights (``shard_params``). Tokens and counters must be
equal, logits within 1e-4, and the two ranks' results equal. Reduced
DeepSeekMoE-16B (and reduced Mixtral-8x7B) in float32 with capacity factor
8, through ``run()``, the paged ``serve_continuous()`` and its contiguous
fallback (``paged=False``). The scenarios mirror ``tests/test_moe_pipeline.py:261``,
``tests/test_session.py:97`` and ``tests/test_sharding_multidevice.py:47``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_sharded import load_tree, run_jax, run_ranks  # noqa: E402

PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10], list(range(11, 31)))
GEN = 6
COUNTERS = ("batches", "replans", "plan_switches", "cache_hits", "planner_fallbacks", "async_restores",
            "restore_errors", "background_errors", "joins", "decode_steps", "prefill_chunks", "fused_steps",
            "prefix_hit_blocks", "prefix_hit_tokens", "cow_copies")

ADAPTIVE = ("adaptive",)

# name -> (model, config overrides, plan (attn, prefill, decode, mechanism), engine keywords, continuous)
SCENARIOS = {
    "tp2_tp2": ("deepseek-moe-16b", {}, ("TP2", "TP2", "", "reshard"), {}, False),
    "tp2_ep2_serial": ("deepseek-moe-16b", {}, ("TP2", "EP2", "", "reshard"), {"moe_pipeline": 1}, False),
    "tp2_ep2_pipelined": ("deepseek-moe-16b", {}, ("TP2", "EP2", "", "reshard"), {"moe_pipeline": 2}, False),
    "dp2_ep2": ("deepseek-moe-16b", {}, ("DP2", "EP2", "", "reshard"), {}, False),
    "switch_reshard": ("deepseek-moe-16b", {}, ("TP2", "EP2", "TP2", "reshard"), {}, False),
    "switch_int4": ("deepseek-moe-16b", {}, ("TP2", "EP2", "TP2", "int4_upload"), {"use_int4_transition": True},
                    False),
    "resident_int4": ("deepseek-moe-16b", {}, ("TP2", "EP2", "TP2", "int4_upload"),
                      {"use_int4_transition": True, "resident_int4": True}, False),
    "continuous_prefix": ("deepseek-moe-16b", {}, ("TP2", "EP2", "", "reshard"),
                          {"prefix_cache": True, "kv_block_size": 8, "prefill_chunk": 8}, True),
    "kv1_tp2": ("deepseek-moe-16b", {"num_kv_heads": 1}, ("TP2", "TP2", "", "reshard"), {}, False),
    "kv1_tp2_continuous": ("deepseek-moe-16b", {"num_kv_heads": 1}, ("TP2", "TP2", "", "reshard"),
                           {"kv_block_size": 8, "prefill_chunk": 8}, True),
    "mixtral_ep2": ("mixtral-8x7b", {}, ("TP2", "EP2", "", "reshard"), {}, False),
    # the contiguous continuous fallback: whole-prompt admissions merged into
    # slots, under TP2 attention and EP2 experts, then under the switching
    # INT4 plan (an expert transition at every admission)
    "contiguous_tp2_ep2": ("deepseek-moe-16b", {}, ("TP2", "EP2", "", "reshard"), {"paged": False}, True),
    "contiguous_switch_int4": ("deepseek-moe-16b", {}, ("TP2", "EP2", "TP2", "int4_upload"),
                               {"paged": False, "use_int4_transition": True}, True),
    # a capacity that drops tokens: EP2 routes each rank's half of the tokens with
    # the capacity of that half, so it drops other tokens than one device does
    "ep2_drops": ("deepseek-moe-16b", {"capacity_factor": 0.5}, ("TP2", "EP2", "", "reshard"), {}, False),
    # a source that plans TP2/TP2 for a batch of 2 and DP2/EP2 for a batch of 1: the
    # second batch switches plans, resharding attention (heads -> whole) and experts (d_ff -> E)
    "adaptive": ("deepseek-moe-16b", {}, ADAPTIVE, {}, False),
}

# teacher-forced logits of the model functions: (model, overrides, attn, experts, pipeline)
LOGITS = {
    "tp2_tp2": ("deepseek-moe-16b", {}, "TP2", "TP2", 0),
    "tp2_ep2_k2": ("deepseek-moe-16b", {}, "TP2", "EP2", 2),
    "dp2_ep2": ("deepseek-moe-16b", {}, "DP2", "EP2", 0),
    "kv1_tp2": ("deepseek-moe-16b", {"num_kv_heads": 1}, "TP2", "TP2", 0),
    "mixtral_ep2": ("mixtral-8x7b", {}, "TP2", "EP2", 1),
    "ep2_drops": ("deepseek-moe-16b", {"capacity_factor": 0.5}, "TP2", "EP2", 1),
}
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
from torch_sharded import save_tree

out, scen, logit_scen = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
prompts, gen, counters, steps = json.loads(sys.argv[4])
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ('data', 'model'))

def config(model, over):
    return dataclasses.replace(get_config(model).reduced(), dtype='float32', **{'capacity_factor': 8.0, **over})

params = {}
def params_for(model, over):
    key = json.dumps([model, over])
    if key not in params:
        params[key] = init_params(config(model, over), jax.random.PRNGKey(0))
        save_tree(f"{out}/params_{len(params) - 1}.npz", params[key])
    return list(params).index(key), params[key]

class ByBatch:
    def plan_for(self, w):
        return fixed_plan('TP2', 'TP2') if w.batch == 2 else fixed_plan('DP2', 'EP2')

res = {}
for name, (model, over, plan, kw, cont) in scen.items():
    cfg = config(model, over)
    idx, p = params_for(model, over)
    source = ByBatch() if plan == ['adaptive'] else fixed_plan(plan[0], plan[1], plan[2], mechanism=plan[3])
    session = HAPSession(cfg, 'a6000', 2, source=source, mesh=mesh, prompt_bucket=16, gen_bucket=8)
    session.transition_between = lambda old, new, w: ('reshard', 0.0)
    eng = session.engine(p, cfg=cfg, max_batch=2, **kw)
    if cont:
        eng.scheduler.bucket = 16
    for q in prompts:
        eng.submit(Request(prompt=q, max_new_tokens=gen))
    comps = eng.serve_continuous() if cont else eng.run()
    res[name] = {"params": idx, "tokens": [c.tokens for c in comps],
                 "stats": {k: getattr(eng.stats, k) for k in counters}}

toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
logits = {}
for name, (model, over, attn, experts, k) in logit_scen.items():
    cfg = config(model, over)
    _, p = params_for(model, over)
    splan = fixed_plan(attn, experts).to_sharding_plan(mesh, cfg, phase='decode')
    splan = dataclasses.replace(splan, moe_pipeline=k)
    pf = jax.jit(lambda p, b: prefill(p, cfg, b, max_len=16, plan=splan))
    df = jax.jit(lambda p, t, c: decode_step(p, cfg, t, c, plan=splan))
    lg, cache = pf(p, {'tokens': jnp.asarray(toks)})
    seq = [np.asarray(lg)]
    for s in range(steps):
        lg, cache = df(p, jnp.asarray(toks[:, s:s + 1]), cache)
        seq.append(np.asarray(lg))
    logits[name] = np.stack(seq)
np.savez(f"{out}/logits.npz", **logits)
json.dump(res, open(f"{out}/serving.json", "w"))
print("OK")
"""


def _config(model, over):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(model).reduced(), dtype="float32", **{"capacity_factor": 8.0, **over})


class ByBatch:
    """TP2/TP2 for a batch of 2, DP2/EP2 for a batch of 1."""

    def plan_for(self, w):
        from repro_torch.core import fixed_plan

        return fixed_plan("TP2", "TP2") if w.batch == 2 else fixed_plan("DP2", "EP2")


def ranks_serving(mesh, data: str, scenarios: dict, logit_scenarios: dict, trees: dict):
    """One rank: every scenario through the port's engine, each from this
    rank's shard of the JAX weights, and the teacher-forced logits."""
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import decode_step, params_from_numpy, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import Request

    torch.set_num_threads(1)
    whole = {i: load_tree(f"{data}/params_{i}.npz") for i in set(trees.values())}
    res = {}
    for name, (model, over, plan, kw, cont) in scenarios.items():
        cfg = _config(model, over)
        hap = fixed_plan("TP2", "TP2") if plan == ADAPTIVE else fixed_plan(plan[0], plan[1], plan[2],
                                                                           mechanism=plan[3])
        splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
        params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
        session = HAPSession(cfg, "a6000", 2, source=ByBatch() if plan == ADAPTIVE else hap, mesh=mesh,
                             prompt_bucket=16, gen_bucket=8)
        session.transition_between = lambda old, new, w: ("reshard", 0.0)  # no latency model to fit
        eng = session.engine(params, device="cpu", max_batch=2, params_plan=splan, **kw)
        if cont:
            eng.scheduler.bucket = 16
        for q in PROMPTS:
            eng.submit(Request(prompt=q, max_new_tokens=GEN))
        comps = eng.serve_continuous() if cont else eng.run()
        res[name] = {"tokens": [c.tokens for c in comps], "stats": dataclasses.asdict(eng.stats),
                     "layout": dataclasses.replace(eng._sharding_for("decode"), mesh=None)}
        eng.close()
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]])
    logits = {}
    for name, (model, over, attn, experts, k) in logit_scenarios.items():
        cfg = _config(model, over)
        splan = dataclasses.replace(fixed_plan(attn, experts).to_sharding_plan(mesh, cfg, phase="decode"),
                                    moe_pipeline=k)
        params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
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
    work = tmp_path_factory.mktemp("sharded_serving")
    run_jax(_JAX, str(work), json.dumps(SCENARIOS), json.dumps(LOGITS),
            json.dumps([PROMPTS, GEN, COUNTERS, LOGIT_STEPS]), timeout=600)
    with open(work / "serving.json") as f:
        jax_res = json.load(f)
    with np.load(work / "logits.npz") as z:
        jax_logits = {k: z[k] for k in z.files}
    trees = {name: jax_res[name]["params"] for name in SCENARIOS}
    keyed = {json.dumps([m, o]): jax_res[n]["params"] for n, (m, o, *_) in SCENARIOS.items()}
    trees.update({name: keyed[json.dumps([m, o])] for name, (m, o, *_) in LOGITS.items()})
    ranks = run_ranks("test_torch_sharded_serving:ranks_serving", work / "ranks", timeout=600,
                      data=str(work), scenarios=SCENARIOS, logit_scenarios=LOGITS, trees=trees)
    return (jax_res, jax_logits), ranks


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_stats_equal_jax_engine(both, name):
    (jax_res, _), ranks = both
    got = ranks[0][0][name]
    assert got["tokens"] == ranks[1][0][name]["tokens"]
    assert got["tokens"] == jax_res[name]["tokens"]
    assert all(len(t) == GEN for t in got["tokens"])
    assert {k: got["stats"][k] for k in COUNTERS} == jax_res[name]["stats"]


@pytest.mark.parametrize("name", list(LOGITS))
def test_logits_equal_jax_model(both, name):
    (_, jax_logits), ranks = both
    got = ranks[0][1][name]
    np.testing.assert_array_equal(got, ranks[1][1][name])
    np.testing.assert_allclose(got, jax_logits[name], rtol=1e-4, atol=1e-4)


def test_layouts_and_reshard_bytes(both):
    """The plans' layouts on two ranks, and the reshard's bytes: under the
    switching plan each prefill->decode and decode->prefill move of the
    three expert leaves receives half of each rank's shard."""
    _, ranks = both
    res = ranks[0][0]
    assert res["kv1_tp2"]["layout"].kv_shard == "none"  # the reference keeps a seq-sharded cache here
    assert res["tp2_tp2"]["layout"].kv_shard == "heads"
    assert res["dp2_ep2"]["layout"].attn_mode == "replicated" and res["dp2_ep2"]["layout"].kv_shard == "none"
    assert res["switch_reshard"]["layout"].ffn_mode == "tp"
    cfg = _config("deepseek-moe-16b", {})
    leaf = cfg.num_layers * cfg.n_routed_experts * cfg.d_model * cfg.moe_d_ff * 4  # float32, one leaf
    moves = 3  # into decode for each of the two batches, back to prefill between them
    assert res["switch_reshard"]["stats"]["reshard_bytes"] == moves * 3 * leaf // 4
    assert all(res[n]["stats"]["reshard_bytes"] == 0 for n in res if n not in ("switch_reshard", "adaptive"))
    # the plan switch: attention's heads gathered whole, the experts' d_ff columns exchanged for experts
    attn = cfg.num_layers * cfg.d_model * cfg.num_heads * cfg.head_dim * 4 // 2  # a rank's half of wq
    assert res["adaptive"]["stats"]["plan_switches"] == 1
    assert res["adaptive"]["stats"]["reshard_bytes"] == 4 * attn + 3 * leaf // 4
    assert res["adaptive"]["layout"].attn_mode == "replicated" and res["adaptive"]["layout"].ffn_mode == "ep"
