"""The serving engine on a ``(data, model)`` mesh of four ranks: the shared
machinery of ``tests/test_torch_sharded_data*.py``.

One JAX subprocess (four forced host devices, ``Mesh(devices.reshape(2,
2), ('data', 'model'))``) serves each scenario through the reference's
engine; four gloo ranks on ``RankMesh(group, data=2)`` serve it through the
port's, each rank from its shard of the same weights. A scenario is
``(model, config overrides, source, engine keywords, continuous, traffic,
doctored router)``; ``source`` is a pinned plan ``[attn, prefill, decode,
mechanism]``, ``"by_prompt"`` (TP2/TP2 while every live prompt fits one
16-token bucket, DP2/EP2 once a longer one is live: a re-plan with live
requests), or a static ``plan=``: ``"static_fsdp"`` (ZeRO-3 over both
axes) or ``"static_sp"`` (``make_plan`` with ``seq_shard_acts``). Reduced
configs in float32, capacity factor 8 unless overridden."""

import json

import numpy as np

from torch_sharded import load_tree, run_jax, run_ranks

COUNTERS = ("batches", "replans", "plan_switches", "cache_hits", "planner_fallbacks", "async_restores",
            "restore_errors", "background_errors", "joins", "decode_steps", "prefill_chunks", "fused_steps",
            "prefix_hit_blocks", "prefix_hit_tokens", "cow_copies", "routing_steps", "replication_rebalances",
            "preemptions", "preempted_tokens", "cancelled", "deadline_expired")

SHARED = list(range(1, 21))
TRAFFIC = {
    "base": (([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), (list(range(11, 25)), 6), ([7, 7, 7], 6)),
    # six prompts of 23 tokens, five sharing their first 20, padded to 32:
    # shared blocks, copy-on-write forks, joins as rows retire
    "shared": tuple((SHARED + [40 + i, 50 + i, 60 + i], g) for i, g in enumerate((6, 4, 8, 6, 5)))
    + (([9, 8, 7] * 7 + [6, 5], 6),),
    # five prompts of 70 tokens (padded to 80): a 64-token chunk beside live rows
    "long": tuple((list(range(100 + 7 * i, 170 + 7 * i)), g) for i, g in enumerate((6, 4, 8, 6, 5))),
    # r1 retires early and r2 (a 32-token bucket) joins while r0 is live
    # (TP2 -> DP2); r2 retires and r3 joins while r0 is still live (DP2 -> TP2)
    "switch": ((list(range(1, 5)), 12), (list(range(5, 11)), 2), (list(range(11, 31)), 2), (list(range(31, 36)), 4)),
    # an overcommitted pool of 4-token blocks: growth preempts rows
    "overcommit": ((list(range(1, 13)), 8), (list(range(3, 12)), 8), ([5, 4, 3, 2, 1], 8),
                   ([2, 4, 6, 8, 10, 12, 14], 8)),
    # deadlines (ms of the engine's clock, one ms a decode step on rank 0's)
    # and a cancel of uid 1 after CANCEL_AFTER steps (``lifecycle``)
    "lifecycle": (([1, 2, 3], 8, 4.0), ([4, 5, 6, 7], 8), ([8, 9], 8), ([10, 11, 12], 8, 20.0)),
    # one batch of four rows whose rows 0 and 2, one in each data block, are the same prompt
    "twins": (([1, 2, 3, 4], 8), ([5, 6, 7, 8, 9, 10], 8), ([1, 2, 3, 4], 8), ([7, 7, 7], 8)),
}
# the sampling of the ``sampled`` scenarios, which only the port's ranks serve
# (the JAX engine's draws are ``jax.random``'s)
SAMPLED = {"temperature": 1.0, "seed": 5}
CANCEL_UID, CANCEL_AFTER = 1, 6


def lifecycle(eng, me: int) -> None:
    """Rank ``me``'s clock runs at ``1 + 2 * me`` ms a decode step, and only
    rank 0 cancels ``CANCEL_UID`` at step ``CANCEL_AFTER``: the engine takes
    rank 0's verdicts, so every rank retires what the JAX engine retires on
    rank 0's clock."""
    rate = 1.0 + 2.0 * me
    eng.clock = lambda: rate * eng.stats.decode_steps / 1e3
    step, steps = eng.step, [0]

    def counted(*a):
        steps[0] += 1
        if steps[0] == CANCEL_AFTER and me == 0:
            eng.cancel(CANCEL_UID)
        return step(*a)

    eng.step = counted


def engine_kw(kw: dict, FaultInjector) -> dict:
    """A scenario's engine keywords, its ``faults`` ([site, "at" or
    "times", n] rules) made into a ``FaultInjector`` of the given class."""
    kw = dict(kw)
    if "faults" in kw:
        fi = FaultInjector()
        for site, how, n in kw["faults"]:
            fi.fail(site, **{how: n})
        kw["faults"] = fi
    return kw


def submit(eng, traffic: str, Request) -> None:
    for q, g, *deadline in TRAFFIC[traffic]:
        eng.submit(Request(prompt=q, max_new_tokens=g, deadline_ms=deadline[0] if deadline else None))

_JAX = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core import HAPSession
from repro.core.hap import fixed_plan
from repro.models import init_params
from repro.serving import InferenceEngine, Request
from repro.serving.faults import FaultInjector
from repro.sharding.specs import ShardingPlan, make_plan
from torch_sharded import save_tree
from torch_sharded_data import COUNTERS, doctor, engine_kw, lifecycle, submit

out, scen = sys.argv[1], json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('data', 'model'))

def config(model, over):
    return dataclasses.replace(get_config(model).reduced(), dtype='float32', **{'capacity_factor': 8.0, **over})

class ByPrompt:
    def plan_for(self, w):
        return fixed_plan('TP2', 'TP2') if w.prompt <= 16 else fixed_plan('DP2', 'EP2')

params = {}
def params_for(model, over, doctored):
    key = json.dumps([model, over, doctored])
    if key not in params:
        p = init_params(config(model, over), jax.random.PRNGKey(0))
        if doctored:
            p['layers']['moe']['router'] = jnp.asarray(doctor(np.asarray(p['layers']['moe']['router'])))
        params[key] = p
        save_tree(f"{out}/params_{len(params) - 1}.npz", p)
    return list(params).index(key), params[key]

res = {}
for name, (model, over, source, kw, cont, traffic, doctored) in scen.items():
    cfg = config(model, over)
    idx, p = params_for(model, over, doctored)
    kw = engine_kw(kw, FaultInjector)
    if source == 'static_fsdp':
        plan = ShardingPlan(mesh=mesh, dp_axes=mesh.axis_names, attn_mode='replicated', kv_shard='none',
                            ffn_mode='tp', ffn_tp_axis=None, ep_axis=None, fsdp=True)
        eng = InferenceEngine(cfg, p, plan=plan, **kw)
    elif source == 'static_sp':
        eng = InferenceEngine(cfg, p, plan=dataclasses.replace(make_plan(mesh, cfg), seq_shard_acts=True), **kw)
    else:
        src = ByPrompt() if source == 'by_prompt' else fixed_plan(source[0], source[1], source[2],
                                                                  mechanism=source[3])
        session = HAPSession(cfg, 'a6000', 4, source=src, mesh=mesh, prompt_bucket=16, gen_bucket=8)
        session.transition_between = lambda old, new, w: ('reshard', 0.0)
        eng = session.engine(p, cfg=cfg, **kw)
    if cont:
        eng.scheduler.bucket = 16
    if traffic == 'lifecycle':
        lifecycle(eng, 0)
    submit(eng, traffic, Request)
    comps = eng.serve_continuous() if cont else eng.run()
    rep = eng._replication
    res[name] = {"params": idx, "done": [[c.uid, c.tokens, c.status, c.preemptions] for c in comps],
                 "stats": {k: getattr(eng.stats, k) for k in COUNTERS},
                 "rep": None if rep is None else [list(rep.degrees), list(rep.order)]}
json.dump(res, open(f"{out}/serving.json", "w"))
print("OK")
"""


def doctor(router: np.ndarray) -> np.ndarray:
    """The router of ``tests/test_replication.py``: every token's logits put
    expert 1 first, expert 0 second (a hot pair to replicate)."""
    L, d, E = router.shape
    v = np.random.default_rng(3).normal(size=d).astype(np.float32)
    out = np.broadcast_to(-v[None, :, None], (L, d, E)).copy()
    out[:, :, 1] = v
    return out


def _config(model, over):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(model).reduced(), dtype="float32", **{"capacity_factor": 8.0, **over})


class ByPrompt:
    def plan_for(self, w):
        from repro_torch.core import fixed_plan

        return fixed_plan("TP2", "TP2") if w.prompt <= 16 else fixed_plan("DP2", "EP2")


def _static_plan(source, mesh, cfg):
    import dataclasses

    from repro_torch.sharding.specs import ShardingPlan, make_plan

    if source == "static_fsdp":
        return ShardingPlan(mesh=mesh, dp_axes=tuple(mesh.axis_names), attn_mode="replicated", kv_shard="none",
                            ffn_mode="tp", ffn_tp_axis=None, ep_axis=None, fsdp=True)
    return dataclasses.replace(make_plan(mesh, cfg), seq_shard_acts=True)


def ranks_data(mesh, data: str, scenarios: dict, trees: dict, sampled=()):
    """One of the four ranks: every scenario through the port's engine on
    ``RankMesh(data=2)``, from this rank's shard of the JAX weights. Besides
    the JAX side's results: the (batch rows, cache rows) of every static
    batch, the mesh coordinates and the final layout's data axes. The
    ``sampled`` scenarios are served at ``SAMPLED``, and also by one
    process's engine from the whole weights (``one``)."""
    import torch

    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import params_from_numpy
    from repro_torch.models.params import shard_params
    from repro_torch.serving import InferenceEngine, Request, SamplingParams
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.sharding.mesh import RankMesh

    torch.set_num_threads(1)
    grid = RankMesh(data=2)
    whole = {i: load_tree(f"{data}/params_{i}.npz") for i in set(trees.values())}
    res = {}
    for name, (model, over, source, kw, cont, traffic, _) in scenarios.items():
        cfg = _config(model, over)
        kw = engine_kw(kw, FaultInjector)
        if source in ("static_fsdp", "static_sp"):
            splan = _static_plan(source, grid, cfg)
            params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, grid.coords), "cpu")
            eng = InferenceEngine(cfg, params, plan=splan, device="cpu", **kw)
        else:
            hap = fixed_plan("TP2", "TP2") if source == "by_prompt" else fixed_plan(*source[:3], mechanism=source[3])
            splan = hap.to_sharding_plan(grid, cfg, phase="prefill")
            params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, grid.coords), "cpu")
            session = HAPSession(cfg, "a6000", 4, source=ByPrompt() if source == "by_prompt" else hap, mesh=grid,
                                 prompt_bucket=16, gen_bucket=8)
            session.transition_between = lambda old, new, w: ("reshard", 0.0)  # no latency model to fit
            eng = session.engine(params, device="cpu", params_plan=splan, **kw)
        if cont:
            eng.scheduler.bucket = 16
        rows, static = [], eng._static_cache

        def spy(B, max_len):
            cache = static(B, max_len)
            rows.append((B, (cache.k if cache.k is not None else cache.conv).shape[1]))
            return cache

        eng._static_cache = spy
        if traffic == "lifecycle":
            lifecycle(eng, grid.index)
        submit(eng, traffic, Request)
        sampling = SamplingParams(**SAMPLED) if name in sampled else None
        comps = eng.serve_continuous(sampling) if cont else eng.run(sampling)
        rep = eng._replication
        res[name] = {"done": [[c.uid, c.tokens, c.status, c.preemptions] for c in comps],
                     "stats": {k: getattr(eng.stats, k) for k in COUNTERS},
                     "rep": None if rep is None else [list(rep.degrees), list(rep.order)],
                     "rows": sorted(set(rows)), "coords": dict(grid.coords),
                     "dp_axes": list(eng._sharding_for("decode").dp_axes), "relayouts": len(eng.kv_relayout_ms)}
        eng.close()
        del eng, params
        if name in sampled:
            one = InferenceEngine(cfg, params_from_numpy(whole[trees[name]], "cpu"), device="cpu", **kw)
            one.scheduler.bucket = 16
            submit(one, traffic, Request)
            comps = one.serve_continuous(sampling) if cont else one.run(sampling)
            res[name]["one"] = [[c.uid, c.tokens, c.status, c.preemptions] for c in comps]
            one.close()
    return res


def serve_both(work, scenarios: dict, sampled: dict = None):
    """(the JAX engine's results, the four ranks' results) of every
    scenario. The ranks alone serve ``sampled`` (scenarios at ``SAMPLED``),
    each from the weights of a scenario of the same model, overrides and
    router."""
    sampled = sampled or {}
    run_jax(_JAX, str(work), json.dumps(scenarios), timeout=900, devices=4)
    with open(work / "serving.json") as f:
        jax_res = json.load(f)
    trees = {name: jax_res[name]["params"] for name in scenarios}

    def weights(s):
        return json.dumps([s[0], s[1], s[6]])

    for name, s in sampled.items():
        trees[name] = next(trees[n] for n, t in scenarios.items() if weights(t) == weights(s))
    ranks = run_ranks("torch_sharded_data:ranks_data", work / "ranks", timeout=900, world_size=4, data=str(work),
                      scenarios={**scenarios, **sampled}, trees=trees, sampled=list(sampled))
    return jax_res, ranks


def check_scenario(jax_res, ranks, name: str) -> dict:
    """Tokens, statuses, preemptions and counters equal the JAX engine's,
    and the four ranks agree; returns rank 0's result."""
    got = ranks[0][name]
    for r in ranks[1:]:
        assert {k: r[name][k] for k in ("done", "stats", "rep")} == {k: got[k] for k in ("done", "stats", "rep")}
    assert got["done"] == jax_res[name]["done"]
    assert got["stats"] == jax_res[name]["stats"]
    assert got["rep"] == jax_res[name]["rep"]
    return got
