"""The port's training on a ``(data, model)`` mesh of four gloo ranks against
the JAX reference on four forced host devices, the same mesh built with
``Mesh(devices.reshape(d, m), ('data', 'model'))`` (``jax.make_mesh``
makes Explicit axes, on which the reference's constraints raise).

One JAX subprocess computes, for every case below, ``loss_and_aux`` and
``jax.grad`` of it under the case's plan on its mesh, and for two cases
three ``make_train_step`` steps; it also runs the reference's train
launcher on four devices. One spawn of four ranks runs the port on the
same weights (each rank its shard, ``shard_params``) and the same batch
(each rank its data rows, ``local_rows``). Reduced configs in float32:

- the loss (ce and aux too, where they are the same function) within rel
  1e-5; every gradient leaf, gathered from the ranks' shards, within rel
  L2 1e-4 of the reference's; three AdamW steps' parameters within 1e-5;
- Mistral-NeMo TP on (2, 2); DeepSeekMoE EP on (2, 2) at capacity factor
  1.25, at batches that hit the reference's three EP token splits (over
  data x ep, over data alone, whole on every EP rank), and on (4, 1); TP
  experts with a data axis (the global drop order); ``seq_shard_acts`` on
  (1, 2) and (2, 2) (DeepSeek and Hymba's hybrid layers); ``fsdp`` on
  four ranks under ``remat``;
- under EP with a data axis the two packages differentiate the same
  function, ce plus the mean of every (data, ep) shard's aux, but the
  reference reports data shard 0's EP mean (ROADMAP C): both values are
  pinned against the shards' aux computed from one device's hidden
  states;
- a checkpoint written on four ranks loads on one and back on four;
- the train launcher on four ranks prints the reference launcher's mesh
  line and step lines.
"""

import dataclasses
import io
import json
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_sharded import flatten, load_tree, run_jax, run_ranks  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
STEPS = 3
LAUNCH = ["--arch", "gemma-7b", "--steps", "3"]

# name -> (model, config overrides, mesh (data, model), layout, (batch, seq), train steps, port remat)
CASES = {
    "tp_mistral_2x2": ("mistral-nemo-12b", {}, (2, 2), "make", (4, 8), STEPS, False),
    "ep_2x2": ("deepseek-moe-16b", {}, (2, 2), "make", (4, 8), STEPS, False),
    # T = 14 tokens: 14 % (2 x 2) != 0, 14 % 2 == 0: split over data alone
    "ep_data_split": ("deepseek-moe-16b", {}, (2, 2), "make", (2, 7), 0, False),
    # T = 21 tokens on (1, 2): whole on both EP ranks (on (2, 2) three rows
    # would split unevenly over the data axis, where the reference's GSPMD
    # padding gives the embedding a gradient 0.68 (rel L2) off one device's;
    # the port refuses such a batch)
    "ep_whole": ("deepseek-moe-16b", {}, (1, 2), "make", (3, 7), 0, False),
    "ep_4x1": ("deepseek-moe-16b", {}, (4, 1), "make", (4, 8), 0, False),
    "tp_experts_2x2": ("deepseek-moe-16b", {}, (2, 2), "tp", (4, 8), 0, "dots"),
    "sp_1x2": ("deepseek-moe-16b", {}, (1, 2), "sp_tp", (2, 8), 0, False),
    "sp_2x2": ("deepseek-moe-16b", {}, (2, 2), "sp", (4, 8), 0, False),
    "sp_hymba_2x2": ("hymba-1.5b", {}, (2, 2), "sp", (2, 8), 0, False),
    "fsdp_2x2": ("deepseek-moe-16b", {}, (2, 2), "fsdp", (4, 8), 0, True),
}
# the reference's aux figures: DeepSeek reduced, capacity factor 8, make_batch(cfg, 32, 8), EP plans
AUX_MESHES = ((2, 2), (4, 1), (1, 2))

_JAX = """
import contextlib, dataclasses, io, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import init_params, loss_and_aux, make_batch
from repro.models import moe as moe_mod
from repro.sharding.specs import ShardingPlan, make_plan
from repro.training.optimizer import adamw_init
from repro.training.train_loop import TrainState, make_train_step
from torch_sharded import save_tree

out, cases, aux_meshes, launch = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), json.loads(sys.argv[4])

def mesh_of(d, m):
    return Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ('data', 'model'))

def config(model, over):
    return dataclasses.replace(get_config(model).reduced(), dtype='float32', **over)

def plan_for(layout, mesh, cfg):
    if layout == 'fsdp':
        return ShardingPlan(mesh=mesh, dp_axes=mesh.axis_names, attn_mode='replicated', kv_shard='none',
                            ffn_mode='tp', ffn_tp_axis=None, ep_axis=None, fsdp=True)
    plan = make_plan(mesh, cfg, expert_mode='tp' if layout in ('tp', 'sp_tp') else '')
    return dataclasses.replace(plan, seq_shard_acts=layout.startswith('sp'))

res, params = {}, {}
for name, (model, over, (d, m), layout, (B, S), steps, _) in cases.items():
    cfg = config(model, over)
    if model not in params:
        params[model] = init_params(cfg, jax.random.PRNGKey(0))
        save_tree(f"{out}/params_{model}.npz", params[model])
    p = params[model]
    batch = make_batch(cfg, S, B, key=jax.random.PRNGKey(1))
    np.savez(f"{out}/batch_{name}.npz", **{k: np.asarray(v) for k, v in batch.items()})
    mesh = mesh_of(d, m)
    plan = plan_for(layout, mesh, cfg)
    with mesh:
        (loss, mets), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_and_aux(p, cfg, b, plan, remat=False), has_aux=True))(p, batch)
    save_tree(f"{out}/grads_{name}.npz", grads)
    r = {"loss": float(loss), "ce": float(mets['ce']), "aux": float(mets['aux']), "ffn": plan.ffn_mode,
         "attn": plan.attn_mode}
    if steps:
        step = jax.jit(make_train_step(cfg, plan, total_steps=steps, remat=False))
        state = TrainState(p, adamw_init(p))
        hist = []
        with mesh:
            for _ in range(steps):
                state, mt = step(state, batch)
                hist.append({k: float(mt[k]) for k in ('loss', 'grad_norm', 'ce', 'aux')})
        save_tree(f"{out}/trained_{name}.npz", state.params)
        r["history"] = hist
    res[name] = r

# the EP aux: what the reference reports on each mesh, and every token shard's
# local aux from one device's hidden states (capacity 8: nothing drops)
cfg = config('deepseek-moe-16b', {'capacity_factor': 8.0})
p = init_params(cfg, jax.random.PRNGKey(0))
batch = make_batch(cfg, 32, 8)
np.savez(f"{out}/aux_batch.npz", **{k: np.asarray(v) for k, v in batch.items()})
aux = {"reported": {}}
for d, m in aux_meshes:
    mesh = mesh_of(d, m)
    plan = make_plan(mesh, cfg, expert_mode='ep')
    with mesh:
        _, mets = jax.jit(lambda p, b: loss_and_aux(p, cfg, b, plan, remat=False))(p, batch)
    aux["reported"][f"{d}x{m}"] = float(mets['aux'])
seen = []
real = moe_mod.apply_moe
def spy(x, moe_p, cfg, plan, backend=None):
    seen.append((np.asarray(x), moe_p['router']))
    return real(x, moe_p, cfg, plan, backend=backend)
moe_mod.apply_moe = spy
from repro.models.transformer import embed_inputs, layer_full
x = embed_inputs(p, cfg, batch, None)
for layer, flag in enumerate(cfg.global_layer_flags()):
    x = layer_full(x, jax.tree.map(lambda a: a[layer], p['layers']), flag, cfg, None)[0]
moe_mod.apply_moe = real
shards = []
for n in (4, 2):
    per = []
    for i in range(n):
        total = 0.0
        for x, router in seen:
            flat = x.reshape(-1, x.shape[-1])
            part = flat[i * len(flat) // n:(i + 1) * len(flat) // n]
            total += float(moe_mod.route(jnp.asarray(part), router, cfg)[2]) * cfg.router_aux_loss_coef
        per.append(total)
    shards.append(per)
aux["shards4"], aux["shards2"] = shards
json.dump(aux, open(f"{out}/aux.json", "w"))

# the reference launcher on four devices, its host mesh built with Auto axes
import repro.launch.mesh as launch_mesh
from repro.launch import train as jtrain
launch_mesh.make_host_mesh = lambda model_axis=2: mesh_of(len(jax.devices()) // model_axis, model_axis)
gcfg = config('gemma-7b', {})
save_tree(f"{out}/params_launcher.npz", init_params(gcfg, jax.random.PRNGKey(0)))
sys.argv = ['train'] + launch
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    jtrain.main()
res["launcher"] = buf.getvalue()
json.dump(res, open(f"{out}/train.json", "w"))
print("OK")
"""


def _config(model, over):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(model).reduced(), dtype="float32", **over)


def _plan(layout, mesh, cfg):
    from repro_torch.sharding.specs import ShardingPlan, make_plan

    if layout == "fsdp":
        return ShardingPlan(mesh=mesh, dp_axes=mesh.axis_names, attn_mode="replicated", kv_shard="none",
                            ffn_mode="tp", ffn_tp_axis=None, ep_axis=None, fsdp=True)
    plan = make_plan(mesh, cfg, expert_mode="tp" if layout in ("tp", "sp_tp") else "")
    return dataclasses.replace(plan, seq_shard_acts=layout.startswith("sp"))


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _meshes():
    """A mesh per (data, model) shape: the four ranks, or ranks 0 and 1
    (every rank makes the subgroup; the others get None)."""
    import torch.distributed as dist

    from repro_torch.sharding.mesh import RankMesh

    pair = dist.new_group([0, 1])
    meshes = {(2, 2): RankMesh(data=2), (4, 1): RankMesh(data=4)}
    meshes[(1, 2)] = RankMesh(pair) if dist.get_rank() < 2 else None
    return meshes


def ranks_train(mesh, data: str, cases: dict, launch: list):
    """One rank's runs of every case; rank 0 returns the gathered results."""
    from repro_torch.data.pipeline import local_rows
    from repro_torch.models import loss_and_aux
    from repro_torch.models.params import SPLIT_LEAVES, gather_leaf, leaf_specs, shard_params
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainState, leaf_axes, leaf_grads, make_train_step, sync_grads
    from repro_torch.training.tree import tree_items, tree_leaves

    torch.set_num_threads(1)
    meshes = _meshes()
    out = {}

    def gathered(items, cfg, plan):
        """{leaf name: the whole leaf} from this rank's (name, shard) pairs."""
        specs = leaf_specs(cfg, plan)
        return {n: gather_leaf(t.detach(), specs[n], plan.mesh, SPLIT_LEAVES.get(n.rsplit("/", 1)[-1], 1)).numpy()
                for n, t in items}

    for name, (model, over, dm, layout, (B, S), steps, remat) in cases.items():
        m = meshes[tuple(dm)]
        if m is None:
            continue
        cfg = _config(model, over)
        plan = _plan(layout, m, cfg)
        whole = load_tree(f"{data}/params_{model}.npz")
        with np.load(f"{data}/batch_{name}.npz") as z:
            batch = local_rows({k: z[k] for k in z.files}, plan)
        params = _tensors(shard_params(whole, cfg, plan, m.coords))
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, mets = loss_and_aux(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, plan, remat=remat)
        grads = leaf_grads(loss, leaves)
        grads = sync_grads(grads, leaf_axes(params, cfg, plan)[1], m)
        r = {"loss": float(loss), "ce": float(mets["ce"]), "aux": float(mets["aux"]), "ffn": plan.ffn_mode,
             "attn": plan.attn_mode}
        r["grads"] = gathered(zip([n for n, _ in tree_items(params)], grads), cfg, plan)
        r["shapes"] = {n: tuple(p.shape) for n, p in tree_items(params)}
        if steps:
            params = _tensors(shard_params(whole, cfg, plan, m.coords))
            state = TrainState(params, adamw_init(params))
            step = make_train_step(cfg, plan, total_steps=steps, remat=remat)
            hist = []
            for _ in range(steps):
                state, mt = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
                hist.append({k: float(mt[k]) for k in ("loss", "grad_norm", "ce", "aux")})
            r["history"] = hist
            r["trained"] = gathered(tree_items(state.params), cfg, plan)
            if name == "ep_2x2":  # written on four ranks, then read back on each
                checkpoint.save_checkpoint(f"{data}/ckpt", state, STEPS, cfg=cfg, plan=plan)
                like = TrainState(_tensors(shard_params(whole, cfg, plan, m.coords)),
                                  adamw_init(_tensors(shard_params(whole, cfg, plan, m.coords))))
                back = checkpoint.load_checkpoint(f"{data}/ckpt", like, cfg=cfg, plan=plan)
                r["ckpt_equal"] = all(torch.equal(a, b.detach()) for a, b in zip(tree_leaves(back), tree_leaves(state)))
        out[name] = r
    # the EP aux on each mesh (capacity factor 8)
    aux = {}
    cfg = _config("deepseek-moe-16b", {"capacity_factor": 8.0})
    whole = load_tree(f"{data}/params_deepseek-moe-16b.npz")
    with np.load(f"{data}/aux_batch.npz") as z:
        gb = {k: z[k] for k in z.files}
    for dm in ((2, 2), (4, 1), (1, 2)):
        m = meshes[dm]
        if m is None:
            continue
        from repro_torch.sharding.specs import make_plan

        plan = make_plan(m, cfg, expert_mode="ep")
        params = _tensors(shard_params(whole, cfg, plan, m.coords))
        with torch.no_grad():
            _, mets = loss_and_aux(params, cfg, {k: torch.from_numpy(v) for k, v in local_rows(gb, plan).items()},
                                   plan, remat=False)
        aux[f"{dm[0]}x{dm[1]}"] = float(mets["aux"])
    out["aux"] = aux
    # the launcher, on the reference's initial weights
    from repro_torch.launch import train as launch_train

    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_train.main(launch + ["--device", "cpu"], params=load_tree(f"{data}/params_launcher.npz"))
    out["launcher"] = buf.getvalue()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_train")
    run_jax(_JAX, str(work), json.dumps(CASES), json.dumps(AUX_MESHES), json.dumps(LAUNCH), devices=4, timeout=900)
    with open(work / "train.json") as f:
        jax_res = json.load(f)
    with open(work / "aux.json") as f:
        jax_aux = json.load(f)
    ranks = run_ranks("test_torch_sharded_train:ranks_train", work / "ranks", timeout=900, world_size=4,
                      data=str(work), cases=CASES, launch=LAUNCH)
    return work, jax_res, jax_aux, ranks


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ep_with_data(name) -> bool:
    """EP with a data axis > 1 splitting the tokens: the reported aux differs (ROADMAP C)."""
    return name in ("ep_2x2", "ep_data_split", "ep_4x1", "sp_2x2")


@pytest.mark.parametrize("name", list(CASES))
def test_loss_equals_reference(both, name):
    """ce always; loss and aux where both packages report the same function."""
    _, jax_res, _, ranks = both
    got, want = ranks[0][name], jax_res[name]
    assert (got["ffn"], got["attn"]) == (want["ffn"], want["attn"])
    np.testing.assert_allclose(got["ce"], want["ce"], rtol=TOL)
    if not _ep_with_data(name):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=TOL)
    for r in ranks[1:]:  # every rank holds the same global loss
        if name in r:
            assert r[name]["loss"] == pytest.approx(got["loss"], rel=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_equal_reference(both, name):
    work, _, _, ranks = both
    want = flatten(load_tree(work / f"grads_{name}.npz"))
    got = ranks[0][name]["grads"]
    assert sorted(got) == sorted(want)
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) < GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[5]])
def test_train_steps_equal_reference(both, name):
    """Three AdamW steps under the plan: the parameters (gathered) at 1e-5,
    the grad norm each step at 1e-4 (and the loss where it is the same)."""
    work, jax_res, _, ranks = both
    got, want = ranks[0][name], jax_res[name]
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(g["ce"], w["ce"], rtol=TOL)
        if not _ep_with_data(name):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=TOL)
    trained = flatten(load_tree(work / f"trained_{name}.npz"))
    for k, w in trained.items():
        np.testing.assert_allclose(got["trained"][k], w, rtol=TOL, atol=TOL, err_msg=k)


def test_shards_hold_their_part(both):
    """Each case's per-rank leaves: the FSDP leaves a quarter of their
    largest dividing dimension (L included), EP's experts half of E."""
    _, _, _, ranks = both
    fsdp = ranks[1]["fsdp_2x2"]["shapes"]
    assert fsdp["embed"] == (512 // 4, 256) and fsdp["layers/moe/wi_gate"] == (2, 4, 256 // 4, 128)
    assert fsdp["layers/ln1"] == (2, 256 // 4)
    ep = ranks[3]["ep_2x2"]["shapes"]
    assert ep["layers/moe/wi_gate"] == (2, 2, 256, 128) and ep["layers/moe/router"] == (2, 256, 4)
    assert ep["embed"] == (256, 256)


def test_ep_aux_is_the_mean_of_every_shard(both):
    """ROADMAP C: under EP with a data axis the port reports the mean of
    every (data, ep) token shard's aux; the reference reports data shard
    0's EP mean. Both against the shards' aux from one device's hidden
    states (DeepSeek reduced, capacity factor 8, make_batch(cfg, 32, 8))."""
    _, _, jax_aux, ranks = both
    four, two = jax_aux["shards4"], jax_aux["shards2"]
    ref, port = jax_aux["reported"], ranks[0]["aux"]
    np.testing.assert_allclose(ref["2x2"], np.mean(four[:2]), rtol=1e-4)
    np.testing.assert_allclose(ref["4x1"], four[0], rtol=1e-4)
    np.testing.assert_allclose(ref["1x2"], np.mean(two), rtol=1e-4)
    for mesh in ("2x2", "4x1"):
        np.testing.assert_allclose(port[mesh], np.mean(four), rtol=1e-4)
    np.testing.assert_allclose(port["1x2"], ref["1x2"], rtol=1e-5)
    # the figures the difference was found with
    assert (round(ref["2x2"], 6), round(ref["4x1"], 6), round(np.mean(four), 6)) == (0.024523, 0.027664, 0.023929)


def test_checkpoint_written_on_four_ranks_loads_on_one(both):
    from repro_torch.models import params_from_numpy
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainState
    from repro_torch.training.tree import tree_items

    work, _, _, ranks = both
    assert all(r["ep_2x2"]["ckpt_equal"] for r in ranks)
    params = params_from_numpy(load_tree(work / "params_deepseek-moe-16b.npz"), "cpu")
    state = checkpoint.load_checkpoint(str(work / "ckpt"), TrainState(params, adamw_init(params)))
    assert int(state.opt.step) == STEPS
    trained = ranks[0]["ep_2x2"]["trained"]
    for n, t in tree_items(state.params):
        assert np.array_equal(t.numpy(), trained[n]), n


def _masked(text: str):
    """The mesh line and the step lines, the seconds per step masked."""
    keep = [ln for ln in text.splitlines() if ln.startswith(("mesh ", "step "))]
    return [re.sub(r"\(\d+\.\d+s/step\)", "(s/step)", ln) for ln in keep]


def test_train_launcher_on_four_ranks_prints_the_reference_lines(both):
    _, jax_res, _, ranks = both
    got, want = _masked(ranks[0]["launcher"]), _masked(jax_res["launcher"])
    assert want[0] == "mesh {'data': 2, 'model': 2} plan: attn=tp_heads ffn=tp"
    assert len(want) == 3 and got == want
    assert "process group: gloo, 4 ranks" in ranks[0]["launcher"]
    assert all(not r["launcher"].strip() for r in ranks[1:])  # rank 0 alone prints
