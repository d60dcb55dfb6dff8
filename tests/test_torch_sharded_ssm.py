"""Mamba and hybrid models on two gloo ranks against the JAX engine on a
two-device mesh ``(1, 2)`` of ``('data', 'model')``.

The mixer runs tensor-parallel over d_inner: each rank's ``in_proj`` holds
its channels of the x half and of the z half, its conv window and SSM
state are its channels, and ``x_proj`` and ``out_proj`` complete with an
all-reduce. Reduced Falcon-Mamba-7B (no attention, no FFN) and reduced
Hymba-1.5B (parallel attention and mamba heads, a dense FFN, sliding
windows): under TP2 heads, and with five heads, which do not divide the
axis, so that attention is replicated and the contiguous cache is
sequence-sharded, as full Hymba's 25 heads make it. ``run()`` and the
contiguous continuous fallback give the JAX engine's tokens and
``EngineStats``; the teacher-forced logits of ``prefill`` and
``decode_step`` agree at 1e-4. Float32.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_sharded import load_tree, run_jax, run_ranks  # noqa: E402

PROMPTS = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10], list(range(11, 31)))
GEN = 5
COUNTERS = ("batches", "replans", "plan_switches", "cache_hits", "joins", "decode_steps", "prefill_chunks")
HYMBA5 = {"num_heads": 5, "num_kv_heads": 5}

# name -> (model, config overrides, (attn, experts), continuous)
SCENARIOS = {
    "falcon_run": ("falcon-mamba-7b", {}, ("TP2", "TP2"), False),
    "falcon_contiguous": ("falcon-mamba-7b", {}, ("TP2", "TP2"), True),
    "hymba_tp2_run": ("hymba-1.5b", {}, ("TP2", "TP2"), False),
    "hymba_tp2_contiguous": ("hymba-1.5b", {}, ("TP2", "TP2"), True),
    "hymba5_run": ("hymba-1.5b", HYMBA5, ("TP2", "TP2"), False),
    "hymba5_contiguous": ("hymba-1.5b", HYMBA5, ("TP2", "TP2"), True),
}
LOGITS = {
    "falcon": ("falcon-mamba-7b", {}, ("TP2", "TP2")),
    "hymba_tp2": ("hymba-1.5b", {}, ("TP2", "TP2")),
    "hymba5": ("hymba-1.5b", HYMBA5, ("TP2", "TP2")),
}
LOGIT_STEPS = 4

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
    return dataclasses.replace(get_config(model).reduced(), dtype='float32', **over)

params = {}
def params_for(model, over):
    key = json.dumps([model, over])
    if key not in params:
        params[key] = init_params(config(model, over), jax.random.PRNGKey(0))
        save_tree(f"{out}/params_{len(params) - 1}.npz", params[key])
    return list(params).index(key), params[key]

res = {}
for name, (model, over, plan, cont) in scen.items():
    cfg = config(model, over)
    idx, p = params_for(model, over)
    session = HAPSession(cfg, 'a6000', 2, source=fixed_plan(*plan), mesh=mesh, prompt_bucket=16, gen_bucket=8)
    eng = session.engine(p, cfg=cfg, max_batch=2)
    if cont:
        eng.scheduler.bucket = 16
    for q in prompts:
        eng.submit(Request(prompt=q, max_new_tokens=gen))
    comps = eng.serve_continuous() if cont else eng.run()
    res[name] = {"params": idx, "tokens": [c.tokens for c in comps],
                 "stats": {k: getattr(eng.stats, k) for k in counters}}

toks = np.array([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], np.int32)
logits = {}
for name, (model, over, plan) in logit_scen.items():
    cfg = config(model, over)
    _, p = params_for(model, over)
    splan = fixed_plan(*plan).to_sharding_plan(mesh, cfg, phase='decode')
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

    return dataclasses.replace(get_config(model).reduced(), dtype="float32", **over)


def ranks_ssm(mesh, data: str, scenarios: dict, logit_scenarios: dict, trees: dict):
    """One rank: every scenario through the port's engine from this rank's
    shard of the JAX weights; the teacher-forced logits; this rank's cache
    shapes and ``in_proj``."""
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import decode_step, params_from_numpy, prefill
    from repro_torch.models.params import shard_params
    from repro_torch.serving import Request

    torch.set_num_threads(1)
    whole = {i: load_tree(f"{data}/params_{i}.npz") for i in set(trees.values())}
    res = {}
    for name, (model, over, plan, cont) in scenarios.items():
        cfg = _config(model, over)
        hap = fixed_plan(*plan)
        splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
        params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
        session = HAPSession(cfg, "a6000", 2, source=hap, mesh=mesh, prompt_bucket=16, gen_bucket=8)
        eng = session.engine(params, device="cpu", max_batch=2)
        if cont:
            eng.scheduler.bucket = 16
        for q in PROMPTS:
            eng.submit(Request(prompt=q, max_new_tokens=GEN))
        comps = eng.serve_continuous() if cont else eng.run()
        cache = eng._live.cache if cont and eng._live is not None else eng._static[1] if eng._static else None
        res[name] = {"tokens": [c.tokens for c in comps], "stats": dataclasses.asdict(eng.stats),
                     "layout": dataclasses.replace(eng._sharding_for("decode"), mesh=None)}
        eng.close()
    toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]])
    logits, shapes = {}, {}
    for name, (model, over, plan) in logit_scenarios.items():
        cfg = _config(model, over)
        splan = fixed_plan(*plan).to_sharding_plan(mesh, cfg, phase="decode")
        params = params_from_numpy(shard_params(whole[trees[name]], cfg, splan, mesh.rank), "cpu")
        with torch.inference_mode():
            lg, cache = prefill(params, cfg, {"tokens": toks}, 16, plan=splan)
            seq = [lg.numpy()]
            for s in range(LOGIT_STEPS):
                lg, cache = decode_step(params, cfg, toks[:, s:s + 1], cache, plan=splan)
                seq.append(lg.numpy())
        logits[name] = np.stack(seq)
        shapes[name] = {k: tuple(getattr(cache, k).shape) for k in ("k", "conv", "ssm") if getattr(cache, k) is not None}
        shapes[name]["in_proj"] = params["layers"]["mamba"]["in_proj"].numpy()
    return res, logits, shapes


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX engine's results, the port's two ranks' results, the whole
    JAX trees by name)."""
    work = tmp_path_factory.mktemp("sharded_ssm")
    run_jax(_JAX, str(work), json.dumps(SCENARIOS), json.dumps(LOGITS), json.dumps([PROMPTS, GEN, COUNTERS,
                                                                                   LOGIT_STEPS]), timeout=600)
    with open(work / "serving.json") as f:
        jax_res = json.load(f)
    with np.load(work / "logits.npz") as z:
        jax_logits = {k: z[k] for k in z.files}
    trees = {name: jax_res[name]["params"] for name in SCENARIOS}
    keyed = {json.dumps([m, o]): jax_res[n]["params"] for n, (m, o, *_) in SCENARIOS.items()}
    trees.update({name: keyed[json.dumps([m, o])] for name, (m, o, *_) in LOGITS.items()})
    ranks = run_ranks("test_torch_sharded_ssm:ranks_ssm", work / "ranks", timeout=600, data=str(work),
                      scenarios=SCENARIOS, logit_scenarios=LOGITS, trees=trees)
    wholes = {name: load_tree(f"{work}/params_{trees[name]}.npz") for name in LOGITS}
    return (jax_res, jax_logits), ranks, wholes


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_stats_equal_jax_engine(both, name):
    (jax_res, _), ranks, _ = both
    got = ranks[0][0][name]
    assert got["tokens"] == ranks[1][0][name]["tokens"]
    assert got["tokens"] == jax_res[name]["tokens"]
    assert all(len(t) == GEN for t in got["tokens"])
    assert {k: got["stats"][k] for k in COUNTERS} == jax_res[name]["stats"]


@pytest.mark.parametrize("name", list(LOGITS))
def test_logits_equal_jax_model(both, name):
    (_, jax_logits), ranks, _ = both
    got = ranks[0][1][name]
    np.testing.assert_array_equal(got, ranks[1][1][name])
    np.testing.assert_allclose(got, jax_logits[name], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(LOGITS))
def test_each_rank_holds_its_channels_and_positions(both, name):
    """A rank's conv window and SSM state hold half of d_inner; its
    ``in_proj`` is its half of the x columns beside its half of the z
    columns; Hymba's five-head cache holds half the positions of every kv
    head (seq), its four-head cache half the kv heads."""
    _, ranks, wholes = both
    model, over, _ = LOGITS[name]
    cfg = _config(model, over)
    di, h = cfg.ssm_d_inner, cfg.ssm_d_inner // 2
    x, z = np.split(wholes[name]["layers"]["mamba"]["in_proj"], 2, axis=-1)
    for r in (0, 1):
        shapes = ranks[r][2][name]
        assert shapes["conv"] == (cfg.num_layers, 2, cfg.ssm_conv - 1, di // 2)
        assert shapes["ssm"] == (cfg.num_layers, 2, di // 2, cfg.ssm_state)
        want = np.concatenate([x[..., r * h:(r + 1) * h], z[..., r * h:(r + 1) * h]], axis=-1)
        np.testing.assert_array_equal(shapes["in_proj"], want)
        if name == "hymba5":
            assert shapes["k"] == (cfg.num_layers, 2, 8, 5, cfg.head_dim)
        elif name == "hymba_tp2":
            assert shapes["k"] == (cfg.num_layers, 2, 16, cfg.num_kv_heads // 2, cfg.head_dim)


def test_sharded_init_of_the_split_leaf():
    """``init_params(shard=)`` draws the same shard as ``shard_params`` of
    the whole init, ``in_proj`` block by block."""
    from repro_torch.core import fixed_plan
    from repro_torch.models.params import init_params, shard_params

    mesh = type("M", (), {"axis_names": ("model",), "shape": {"model": 2}})()
    for model in ("falcon-mamba-7b", "hymba-1.5b"):
        cfg = _config(model, {})
        splan = fixed_plan("TP2", "TP2").to_sharding_plan(mesh, cfg, phase="prefill")
        whole = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
        for rank in (0, 1):
            part = init_params(cfg, torch.Generator().manual_seed(5), "cpu", shard=(splan, rank))
            cut = shard_params(whole, cfg, splan, rank)
            for k in part["layers"]["mamba"]:
                assert torch.equal(part["layers"]["mamba"][k], cut["layers"]["mamba"][k]), (model, k)
