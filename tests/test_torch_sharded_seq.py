"""The sequence-sharded decode cache (``kv_shard="seq"``), the live
relayout on a re-plan and the static ``plan=`` keyword, on two gloo ranks
against the JAX engine on a two-device mesh ``(1, 2)`` of
``('data', 'model')``.

The resolver must pick the reference's layout for every config and plan.
Under attention-DP (``dp2_ep2``) and under TP2 heads whose one kv head does
not divide the axis (``kv1_tp2``) the contiguous cache holds half the
positions on each rank; ``run()`` and the contiguous fallback
(``paged=False``) give the JAX engine's tokens and ``EngineStats``. A
source that plans TP2/TP2 for short prompts and DP2/EP2 once a long one is
live switches the attention layout while requests are live, in both
directions: the paged pool moves between heads-sharded and whole, the
contiguous cache between heads and seq. A static ``plan=`` serves as the
reference engine's ``plan=`` does. Reduced DeepSeekMoE-16B in float32,
capacity factor 8.
"""

import dataclasses
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")

from torch_sharded import run_jax, run_ranks  # noqa: E402

COUNTERS = ("batches", "replans", "plan_switches", "cache_hits", "planner_fallbacks", "joins", "decode_steps",
            "prefill_chunks", "fused_steps", "prefix_hit_blocks", "cow_copies")
BASE = ((list(range(1, 5)), 6), (list(range(5, 11)), 6), (list(range(11, 31)), 6))
# the re-plan traffic: r1 retires early and r2 (a 32-token bucket) joins while
# r0 is live (TP2 -> DP2); r2 retires and r3 joins while r0 is still live
# (DP2 -> TP2)
SWITCH = ((list(range(1, 5)), 12), (list(range(5, 11)), 2), (list(range(11, 31)), 2), (list(range(31, 36)), 4))

# name -> (config overrides, source, engine keywords, continuous, traffic); a
# source is [attn, experts] (pinned), "by_prompt" or ["static", attn override]
SCENARIOS = {
    "dp2_ep2": ({}, ["DP2", "EP2"], {}, False, BASE),
    "dp2_ep2_contiguous": ({}, ["DP2", "EP2"], {"paged": False}, True, BASE),
    "kv1_tp2": ({"num_kv_heads": 1}, ["TP2", "TP2"], {}, False, BASE),
    "kv1_tp2_contiguous": ({"num_kv_heads": 1}, ["TP2", "TP2"], {"paged": False}, True, BASE),
    "switch_paged": ({}, "by_prompt", {"kv_block_size": 8, "prefill_chunk": 8}, True, SWITCH),
    "switch_contiguous": ({}, "by_prompt", {"paged": False}, True, SWITCH),
    "static_plan": ({}, ["static", ""], {}, False, BASE),
    "static_plan_replicated": ({}, ["static", "replicated"], {"paged": False}, True, BASE),
}

_JAX = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core import HAPSession
from repro.core.hap import fixed_plan
from repro.models import init_params
from repro.serving import InferenceEngine, Request
from repro.sharding.specs import make_plan
from torch_sharded import save_tree

out, scen, counters = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ('data', 'model'))

def config(over):
    return dataclasses.replace(get_config('deepseek-moe-16b').reduced(), dtype='float32',
                               **{'capacity_factor': 8.0, **over})

class ByPrompt:
    def plan_for(self, w):
        return fixed_plan('TP2', 'TP2') if w.prompt <= 16 else fixed_plan('DP2', 'EP2')

params = {}
res = {}
for name, (over, source, kw, cont, traffic) in scen.items():
    cfg = config(over)
    key = json.dumps(over)
    if key not in params:
        params[key] = init_params(cfg, jax.random.PRNGKey(0))
        save_tree(f"{out}/params_{len(params) - 1}.npz", params[key])
    p = params[key]
    if source[0] == 'static':
        eng = InferenceEngine(cfg, p, plan=make_plan(mesh, cfg, attn_override=source[1]), max_batch=2, **kw)
    else:
        src = ByPrompt() if source == 'by_prompt' else fixed_plan(*source)
        session = HAPSession(cfg, 'a6000', 2, source=src, mesh=mesh, prompt_bucket=16, gen_bucket=8)
        session.transition_between = lambda old, new, w: ('reshard', 0.0)
        eng = session.engine(p, cfg=cfg, max_batch=2, **kw)
    if cont:
        eng.scheduler.bucket = 16
    for q, g in traffic:
        eng.submit(Request(prompt=q, max_new_tokens=g))
    comps = eng.serve_continuous() if cont else eng.run()
    res[name] = {"params": list(params).index(key), "tokens": [c.tokens for c in comps],
                 "stats": {k: getattr(eng.stats, k) for k in counters}}
json.dump(res, open(f"{out}/serving.json", "w"))
print("OK")
"""


def _config(over):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32",
                               **{"capacity_factor": 8.0, **over})


class ByPrompt:
    """TP2/TP2 while every live prompt fits one 16-token bucket, DP2/EP2
    once a longer one is live."""

    def plan_for(self, w):
        from repro_torch.core import fixed_plan

        return fixed_plan("TP2", "TP2") if w.prompt <= 16 else fixed_plan("DP2", "EP2")


def ranks_seq(mesh, data: str, scenarios: dict, trees: dict):
    """One rank: every scenario through the port's engine from this rank's
    shard of the JAX weights; the tokens, the counters, the decode layout,
    the shape of this rank's KV cache and the layouts a live cache went
    through."""
    from torch_sharded import load_tree

    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import params_from_numpy
    from repro_torch.models.params import shard_params
    from repro_torch.serving import InferenceEngine, Request
    from repro_torch.sharding.specs import make_plan

    torch.set_num_threads(1)
    whole = {i: load_tree(f"{data}/params_{i}.npz") for i in set(trees.values())}
    res = {}
    for name, (over, source, kw, cont, traffic) in scenarios.items():
        cfg = _config(over)
        if source[0] == "static":
            splan = make_plan(mesh, cfg, attn_override=source[1])
            params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
            eng = InferenceEngine(cfg, params, plan=splan, device="cpu", max_batch=2, **kw)
        else:
            hap = fixed_plan("TP2", "TP2") if source == "by_prompt" else fixed_plan(*source)
            splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
            params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
            session = HAPSession(cfg, "a6000", 2, source=ByPrompt() if source == "by_prompt" else hap, mesh=mesh,
                                 prompt_bucket=16, gen_bucket=8)
            session.transition_between = lambda old, new, w: ("reshard", 0.0)  # no latency model to fit
            eng = session.engine(params, device="cpu", max_batch=2, params_plan=splan, **kw)
        if cont:
            eng.scheduler.bucket = 16
        layouts = []
        relayout = eng._relayout_live

        def spy(plan, _relayout=relayout, _eng=eng, _layouts=layouts):
            before = _eng._live.layout if _eng._live is not None else None
            ms = _relayout(plan)
            if _eng._live is not None and _eng._live.layout != before:
                _layouts.append([before, _eng._live.layout, tuple(_eng._live.cache.k.shape)])
            return ms

        eng._relayout_live = spy
        for q, g in traffic:
            eng.submit(Request(prompt=q, max_new_tokens=g))
        comps = eng.serve_continuous() if cont else eng.run()
        cache = eng._static[1] if eng._static is not None else None
        res[name] = {"tokens": [c.tokens for c in comps], "stats": dataclasses.asdict(eng.stats),
                     "layout": dataclasses.replace(eng._sharding_for("decode"), mesh=None),
                     "static_k": tuple(cache.k.shape) if cache is not None else None,
                     "relayouts": layouts, "relayout_ms": list(eng.kv_relayout_ms)}
        eng.close()
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX engine's results, the port's two ranks' results)."""
    work = tmp_path_factory.mktemp("sharded_seq")
    run_jax(_JAX, str(work), json.dumps(SCENARIOS), json.dumps(COUNTERS), timeout=600)
    with open(work / "serving.json") as f:
        jax_res = json.load(f)
    trees = {name: jax_res[name]["params"] for name in SCENARIOS}
    ranks = run_ranks("test_torch_sharded_seq:ranks_seq", work / "ranks", timeout=600, data=str(work),
                      scenarios=SCENARIOS, trees=trees)
    return jax_res, ranks


def _mesh(tp, dp=1):
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": dp, "model": tp})


def test_resolver_picks_the_reference_layout():
    """Every config, every attention x expert strategy on 1, 2 and 4 ranks:
    the same plan as the reference's resolver, ``seq`` included, and only
    a data axis of size > 1 left unported."""
    from repro.configs import get_config as jget_config
    from repro.core.strategy import AttnStrategy as JAttn
    from repro.core.strategy import ExpertStrategy as JExpert
    from repro.sharding import specs as jspecs

    from repro_torch.configs import get_config, list_configs
    from repro_torch.core.strategy import AttnStrategy, ExpertStrategy
    from repro_torch.sharding import specs

    fields = ("dp_axes", "attn_mode", "attn_tp_axis", "kv_shard", "ffn_mode", "ffn_tp_axis", "ep_axis", "seq_axis")
    for name in list_configs():
        cfg, jcfg = get_config(name), jget_config(name)
        for tp in (1, 2, 4):
            mesh = _mesh(tp)
            for attn_tp in (True, False):
                for ep in (True, False):
                    a = AttnStrategy(dp=1, tp=tp) if attn_tp else AttnStrategy(dp=tp, tp=1)
                    e = ExpertStrategy(tp=1, ep=tp) if ep else ExpertStrategy(tp=tp, ep=1)
                    ja = JAttn(dp=1, tp=tp) if attn_tp else JAttn(dp=tp, tp=1)
                    je = JExpert(tp=1, ep=tp) if ep else JExpert(tp=tp, ep=1)
                    got = specs.strategy_sharding_plan(mesh, cfg, a, e)
                    want = jspecs.strategy_sharding_plan(mesh, jcfg, ja, je)
                    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}, (name, tp)
                    assert specs.unported_layout(got) is None
        assert "data" in specs.unported_layout(specs.make_plan(_mesh(2, dp=2), cfg))


@pytest.mark.parametrize("max_len", [15, 16, 17])
def test_seq_cache_holds_its_share_of_the_positions(max_len):
    """``init_cache`` under seq: ``ceil(max_len / n)`` positions of every kv
    head a rank; under heads: the rank's kv heads at every position."""
    from repro_torch.core import fixed_plan
    from repro_torch.models import init_cache

    mesh = types.SimpleNamespace(axis_names=("model",), shape={"model": 2}, rank=1, size=2)
    cfg = _config({})
    dp = fixed_plan("DP2", "EP2").to_sharding_plan(mesh, cfg, phase="decode")
    tp = fixed_plan("TP2", "TP2").to_sharding_plan(mesh, cfg, phase="decode")
    assert (dp.kv_shard, tp.kv_shard) == ("seq", "heads")
    seq, heads = init_cache(cfg, 3, max_len, device="cpu", plan=dp), init_cache(cfg, 3, max_len, device="cpu",
                                                                                   plan=tp)
    assert tuple(seq.k.shape) == (cfg.num_layers, 3, math.ceil(max_len / 2), cfg.num_kv_heads, cfg.head_dim)
    assert tuple(heads.k.shape) == (cfg.num_layers, 3, max_len, cfg.num_kv_heads // 2, cfg.head_dim)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_stats_equal_jax_engine(both, name):
    jax_res, ranks = both
    got = ranks[0][name]
    assert got["tokens"] == ranks[1][name]["tokens"]
    assert got["tokens"] == jax_res[name]["tokens"]
    assert [len(t) for t in got["tokens"]] == [g for _, g in SCENARIOS[name][4]]
    assert {k: got["stats"][k] for k in COUNTERS} == jax_res[name]["stats"]


def test_seq_layouts_hold_half_the_positions(both):
    """The plans the runs served under, and each rank's static cache: half
    the positions of every kv head under seq."""
    _, ranks = both
    cfg = _config({})
    for r in ranks:
        assert r["dp2_ep2"]["layout"].kv_shard == "seq" and r["dp2_ep2"]["layout"].attn_mode == "replicated"
        assert r["kv1_tp2"]["layout"].kv_shard == "seq" and r["kv1_tp2"]["layout"].attn_mode == "tp_heads"
        assert r["static_plan"]["layout"].kv_shard == "heads"
        assert r["static_plan_replicated"]["layout"].kv_shard == "seq"
        # the last batch: one request of 20 tokens (bucket 32) + 6 new + 1
        L, B, S, H, hd = r["dp2_ep2"]["static_k"]
        assert (L, S, H, hd) == (cfg.num_layers, math.ceil((32 + 6 + 1) / 2), cfg.num_kv_heads, cfg.head_dim)
        assert r["kv1_tp2"]["static_k"][2:4] == (math.ceil((32 + 6 + 1) / 2), 1)


def test_live_relayout_both_ways(both):
    """The re-plan traffic moved the live cache away from TP2's heads and
    back while r0 was live: the paged pool heads -> whole -> heads, the
    contiguous cache heads -> seq -> heads (half the positions, every head,
    in between)."""
    _, ranks = both
    cfg = _config({})
    for r in ranks:
        paged = [step[:2] for step in r["switch_paged"]["relayouts"]]
        assert paged == [["heads", "none"], ["none", "heads"]]
        cont = r["switch_contiguous"]["relayouts"]
        assert [step[:2] for step in cont] == [["heads", "seq"], ["seq", "heads"]]
        L, B, S, H, hd = cont[0][2]
        assert (H, cont[1][2][2]) == (cfg.num_kv_heads, 2 * S) and cont[1][2][3] == cfg.num_kv_heads // 2
        assert r["switch_paged"]["stats"]["plan_switches"] == 2
        assert len(r["switch_contiguous"]["relayout_ms"]) == 2
