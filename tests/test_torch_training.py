"""The port's training path against the JAX package.

On the bridged weights of the reduced configs, in float32 on the CPU:
``loss_and_aux`` (loss, ce, aux) equals the reference's for every
registered architecture at 1e-5; every gradient leaf equals
``jax.grad(loss_and_aux)`` at rel L2 1e-4 (DeepSeekMoE-16B's router and
experts, HuBERT's plain FFN and frontend, LLaVA's patches, Hymba's mamba
heads), and the layer recomputation (``remat=True``, ``"dots"``) leaves
them unchanged at 1e-6; a float64 ``gradcheck`` finds no cut in the graph;
three ``make_train_step`` steps from one bridged state give the reference's
parameters at 1e-5; ``cosine_lr`` and ``adamw_update`` (a tree with a
bfloat16 leaf and a 1-D leaf) give its values. The reference's own
training tests run on the port: AdamW converges on a quadratic, and the
loss of reduced Mistral-Nemo falls by more than 0.3 in 60 steps on the
Markov data. The data pipeline's copy gives the reference's batches bit
for bit; checkpoints round-trip a bfloat16 state bit for bit and read a
float32 state across the two packages both ways; ``train_loop`` writes
its checkpoints; the launcher runs.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import loss_and_aux as jloss_and_aux  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import TrainState as JTrainState  # noqa: E402
from repro.training.train_loop import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import loss_and_aux, params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint, optimizer  # noqa: E402
from repro_torch.training.train_loop import TrainState, init_train_state, make_train_step, train_loop  # noqa: E402
from repro_torch.training.tree import tree_items, tree_leaves, tree_map  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5
GRAD_TOL = 1e-4  # rel L2 per leaf
GRAD_MODELS = ("deepseek-moe-16b", "hubert-xlarge", "llava-next-mistral-7b", "hymba-1.5b")
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    return reduced(name), dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _setup(name, seed=0):
    cfg_j, cfg_t = _configs(name)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(seed))
    batch = next(jpipeline.synthetic_lm_data(cfg_j, B, S, seed=seed))
    return cfg_j, cfg_t, jparams, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_loss_and_aux_equals_reference(name):
    """Every registered architecture, one batch of its modality from the
    data pipeline: loss, ce and aux at 1e-5."""
    cfg_j, cfg_t, jparams, batch = _setup(name)
    jloss, jm = jloss_and_aux(jparams, cfg_j, _jax_batch(batch))
    loss, m = loss_and_aux(params_from_numpy(jparams, "cpu"), cfg_t, _torch_batch(batch))
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]), (m["aux"], jm["aux"])):
        _close(got.detach(), want)
    assert (float(jm["aux"]) > 0) == cfg_t.is_moe


def _grads(params, cfg, batch, remat):
    """Every leaf's gradient; zeros for a leaf the loss does not read (an
    audio model's token embedding), as ``jax.grad`` gives."""
    leaves = [p.requires_grad_(True) for _, p in tree_items(params)]
    loss, _ = loss_and_aux(params, cfg, _torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(leaves, grads)]


@pytest.fixture(scope="module", params=GRAD_MODELS)
def grad_setup(request):
    cfg_j, cfg_t, jparams, batch = _setup(request.param)
    jgrads = jax.grad(lambda p: jloss_and_aux(p, cfg_j, _jax_batch(batch), remat=False)[0])(jparams)
    return cfg_t, jparams, batch, [g for _, g in tree_items(jgrads)]


def test_gradients_equal_reference(grad_setup):
    """Each leaf's gradient against ``jax.grad`` at rel L2 1e-4 (the
    stacked leaves take their layers' gradients through the slice views)."""
    cfg, jparams, batch, want = grad_setup
    got = _grads(params_from_numpy(jparams, "cpu"), cfg, batch, remat=False)
    names = [n for n, _ in tree_items(jparams)]
    errs = {n: _rel_l2(g, w) for n, g, w in zip(names, got, want)}
    assert max(errs.values()) < GRAD_TOL, errs
    unread = {"embed"} if cfg.frontend == "audio" else set()
    assert {n for n, w in zip(names, want) if not np.abs(np.asarray(w)).max()} == unread


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_equals_no_remat(grad_setup, remat):
    cfg, jparams, batch, _ = grad_setup
    plain = _grads(params_from_numpy(jparams, "cpu"), cfg, batch, remat=False)
    again = _grads(params_from_numpy(jparams, "cpu"), cfg, batch, remat=remat)
    for g, w in zip(again, plain):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("name", ("deepseek-moe-16b", "hymba-1.5b", "hubert-xlarge"))
def test_gradcheck_finds_no_cut(name):
    """float64 ``gradcheck`` of the loss in a few scalars, each scaling one
    part of the model (the input embedding, every norm, the attention or
    mamba mixer's output, the FFN or the experts' output projection, the
    router): a tensor written in place after autograd saved it, a host
    read or an integer cast on the way would break the analytic gradient.
    The layers compute their softmax, router and scan in float32, so the
    finite differences take eps 1e-3 and a tolerance of 1e-3 (a cut gives
    an error of order one)."""
    cfg_j, cfg_t, jparams, batch = _setup(name)
    cfg_t = dataclasses.replace(cfg_t, num_layers=1)
    base = params_from_numpy(jax.tree.map(lambda a: a[:1] if a.ndim > 1 and a.shape[0] == 2 else a, jparams),
                             "cpu", dtype="float32")
    small = {k: v[:1, :8] for k, v in _torch_batch(batch).items()}
    layer = base["layers"]
    targets = ["ln1"] + [k for k in ("attn", "mamba", "ffn", "moe") if k in layer]
    out_leaf = {"attn": "wo", "mamba": "out_proj", "ffn": "wo", "moe": "wo"}

    def loss(scales):
        p = dict(base, layers=dict(layer), embed=base["embed"].double() * scales[0])
        p = tree_map(torch.Tensor.double, p)
        for i, t in enumerate(targets, 1):
            if t == "ln1":
                p["layers"]["ln1"] = p["layers"]["ln1"] * scales[i]
            else:
                sub = dict(p["layers"][t])
                sub[out_leaf[t]] = sub[out_leaf[t]] * scales[i]
                if t == "moe":
                    sub["router"] = sub["router"] * scales[i]
                p["layers"][t] = sub
        return loss_and_aux(p, cfg_t, small, remat=False)[0]

    scales = torch.ones(len(targets) + 1, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(loss, (scales,), eps=1e-3, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", ("deepseek-moe-16b", "hubert-xlarge", "llava-next-mistral-7b"))
def test_three_train_steps_equal_reference(name):
    """Three ``make_train_step`` steps (warm-up 2, so the third decays the
    rate) from one bridged state, on the pipeline's batches: the
    parameters and both moments at 1e-5, the metrics at 1e-5. The rate
    (5e-5 to 1e-4) moves the parameters by ~3e-4, well past the
    tolerance, while an element whose gradient is at rounding level (its
    Adam direction then of either sign) moves by less than it."""
    cfg_j, cfg_t, jparams, _ = _setup(name)
    kw = dict(base_lr=1e-4, warmup=2, total_steps=10, remat=True)
    jstate = JTrainState(jparams, jopt.adamw_init(jparams))
    state = TrainState(params_from_numpy(jparams, "cpu"), optimizer.adamw_init(params_from_numpy(jparams, "cpu")))
    jstep, step = jax.jit(jmake_train_step(cfg_j, None, **kw)), make_train_step(cfg_t, None, **kw)
    data = jpipeline.synthetic_lm_data(cfg_j, B, S, seed=5)
    for _ in range(3):
        batch = next(data)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr", "ce", "aux"):
            _close(m[k], jm[k])
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for (_, a), (_, b) in
                zip(tree_items(jstate.params), tree_items(jparams)))
    assert moved > 10 * TOL
    for tree, jtree in ((state.params, jstate.params), (state.opt.mu, jstate.opt.mu), (state.opt.nu, jstate.opt.nu)):
        for (n, got), (_, want) in zip(tree_items(tree), tree_items(jtree)):
            _close(got.detach(), want)


def test_cosine_lr_equals_reference():
    for s in range(100):
        got = optimizer.cosine_lr(torch.tensor(s, dtype=torch.int32), 1e-3, warmup=10, total=100)
        np.testing.assert_allclose(float(got), float(jopt.cosine_lr(jnp.int32(s), 1e-3, warmup=10, total=100)),
                                   rtol=1e-6)


def test_adamw_update_equals_reference():
    """Three updates of a tree holding a bfloat16 matrix, a float32 stacked
    leaf and a float32 1-D leaf (not decayed): bf16 parameters bit for bit,
    the rest and the moments at 1e-6."""
    rng = np.random.default_rng(0)
    vals = {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"n": rng.standard_normal(7).astype(np.float32),
                  "s": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    jp = {"a": jnp.asarray(vals["a"], jnp.bfloat16), "b": {k: jnp.asarray(v) for k, v in vals["b"].items()}}
    tp = params_from_numpy(jp, "cpu")
    jstate, tstate = jopt.adamw_init(jp), optimizer.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * (i + 1), a.dtype), jp)
        jp, jstate, jn = jopt.adamw_update(jp, g, jstate, lr=1e-2)
        tp, tstate, tn = optimizer.adamw_update(tp, params_from_numpy(g, "cpu"), tstate, lr=1e-2)
        _close(tn, jn, 1e-6)
    assert tp["a"].dtype == torch.bfloat16 and tstate.mu["a"].dtype == torch.float32
    np.testing.assert_array_equal(tp["a"].view(torch.int16).numpy(), np.asarray(jp["a"]).view(np.int16))
    for tree, jtree in ((tp["b"], jp["b"]), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        for (_, got), (_, want) in zip(tree_items(tree), tree_items(jtree)):
            _close(got, want, 1e-6)
    # from zero moments a zero gradient moves only what decays: the 1-D
    # leaf stays put, the stacked leaf shrinks by lr * weight_decay
    before = tree_map(torch.clone, tp)
    optimizer.adamw_update(tp, tree_map(torch.zeros_like, tp), optimizer.adamw_init(tp), lr=1e-2)
    assert torch.equal(tp["b"]["n"], before["b"]["n"])
    torch.testing.assert_close(tp["b"]["s"], before["b"]["s"] * (1 - 1e-2 * 0.1))


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optimizer.adamw_init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = optimizer.adamw_update(params, grads, state, lr=5e-2, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_loss_decreases_on_learnable_data():
    _, cfg = _configs("mistral-nemo-12b")
    data = pipeline.synthetic_lm_data(cfg, batch=4, seq=64, seed=0)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu", dtype="float32")
    step = make_train_step(cfg, None, base_lr=3e-3, warmup=5, total_steps=60, remat=False)
    losses = []
    for _ in range(60):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.3, (first, last)


@pytest.mark.parametrize("name", ("mistral-nemo-12b", "hubert-xlarge", "llava-next-mistral-7b"))
def test_data_pipeline_equals_reference(name):
    """Text (Markov tokens), audio (frames, codebook labels) and vision
    (patches, text): three batches bit for bit, keys and dtypes too."""
    cfg = get_config(name).reduced()
    got, want = pipeline.synthetic_lm_data(cfg, 2, 40, seed=3), jpipeline.synthetic_lm_data(cfg, 2, 40, seed=3)
    for _ in range(3):
        g, w = next(got), next(want)
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(pipeline._markov_tokens(np.random.default_rng(1), 97, 50),
                                  jpipeline._markov_tokens(np.random.default_rng(1), 97, 50))
    assert [list(b) for b in pipeline.synthetic_batches(cfg, 1, 40, 2)] == \
        [list(b) for b in jpipeline.synthetic_batches(cfg, 1, 40, 2)]


def _state(cfg, dtype, seed=1):
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), "cpu", dtype=dtype)
    for m in tree_leaves(state.opt.mu):
        m.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return state._replace(opt=state.opt._replace(step=torch.tensor(7, dtype=torch.int32)))


def test_checkpoint_bf16_round_trip_bit_for_bit(tmp_path):
    _, cfg = _configs("gemma-7b")
    state = _state(cfg, "bfloat16")
    checkpoint.save_checkpoint(str(tmp_path), state, step=7)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    like = _state(cfg, "bfloat16", seed=9)
    restored = checkpoint.load_checkpoint(str(tmp_path), like)
    assert isinstance(restored, TrainState) and int(restored.opt.step) == 7
    pairs = list(zip(tree_items(state), tree_items(restored)))
    assert any(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
    for (n, a), (m, b) in pairs:
        assert n == m and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.detach().view(torch.int16) if a.dtype == torch.bfloat16 else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), n


def test_checkpoint_float32_reads_across_packages(tmp_path):
    """The port reads the reference's float32 checkpoint, and the reference
    the port's, leaf for leaf, under the same names."""
    cfg_j, cfg_t = _configs("deepseek-moe-16b")
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(2))
    jstate = JTrainState(jparams, jopt.adamw_init(jparams))
    jstate = jstate._replace(opt=jstate.opt._replace(step=jnp.int32(4), mu=jax.tree.map(lambda a: a + 0.5,
                                                                                        jparams)))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, step=4)
    like = _state(cfg_t, "float32")
    mine = checkpoint.load_checkpoint(str(tmp_path / "jax"), like)
    for (_, got), want in zip(tree_items(mine), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    checkpoint.save_checkpoint(str(tmp_path / "torch"), like, step=5)
    back = jckpt.load_checkpoint(str(tmp_path / "torch"), jstate)
    for want, got in zip(tree_items(like), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(got), want[1].detach().numpy())
    names = [n for n, _ in tree_items(like)]
    jnames = [n for n, _ in jckpt._flatten_with_names(jstate)[0]]
    assert names == jnames


def test_train_loop_runs_with_checkpointing(tmp_path):
    _, cfg = _configs("hubert-xlarge")
    data = pipeline.synthetic_lm_data(cfg, batch=2, seq=32, seed=1)
    hist = []
    state = train_loop(cfg, data, steps=4, log_every=0, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       remat=False, device="cpu", history=hist)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002", "step_00000004"]
    assert int(state.opt.step) == 4 and [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_training_on_a_mesh_is_not_ported(tmp_path):
    """Named for what it once checked: training on a mesh is ported now.
    The same calls (the loss and the train step) under a plan on a
    one-rank ``(1, 1)`` mesh, whose collectives are all the identity, give
    the one-device values; ``tests/test_torch_sharded_train.py`` holds
    four ranks to the reference."""
    import torch.distributed as dist

    from repro_torch.sharding.mesh import RankMesh
    from repro_torch.sharding.specs import make_plan

    cfg_j, cfg, jparams, batch = _setup("deepseek-moe-16b")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh_plan = make_plan(RankMesh(), cfg)
        assert mesh_plan.ffn_mode == "ep" and mesh_plan.attn_mode == "tp_heads"
        want, wm = loss_and_aux(params_from_numpy(jparams, "cpu"), cfg, _torch_batch(batch))
        params = params_from_numpy(jparams, "cpu")
        got, m = loss_and_aux(params, cfg, _torch_batch(batch), mesh_plan)
        for g, w in ((got, want), (m["ce"], wm["ce"]), (m["aux"], wm["aux"])):
            _close(g.detach(), w.detach())
        one = params_from_numpy(jparams, "cpu")
        _, m1 = make_train_step(cfg)(TrainState(one, optimizer.adamw_init(one)), batch)
        _, m2 = make_train_step(cfg, mesh_plan)(TrainState(params, optimizer.adamw_init(params)), batch)
        _close(m2["grad_norm"], m1["grad_norm"])
        for a, b in zip(tree_leaves(params), tree_leaves(one)):
            _close(a.detach(), b.detach())
    finally:
        dist.destroy_process_group()


def test_train_launcher_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
                          "--arch", "hubert-xlarge", "--seq", "32", "--ckpt", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step     2 loss=" in res.stdout and checkpoint.latest_step(str(tmp_path)) == 3
    # two ranks from torchrun's environment: the launcher makes a gloo group
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                          "--standalone", "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "2",
                          "--seq", "16"], capture_output=True, text=True, env=dict(env, OMP_NUM_THREADS="1"),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "process group: gloo, 2 ranks" in res.stdout
    assert "mesh {'data': 1, 'model': 2} plan: attn=tp_heads ffn=tp" in res.stdout
    assert res.stdout.count("step     1 loss=") == 1  # rank 0 alone logs
