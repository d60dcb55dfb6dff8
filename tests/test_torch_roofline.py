"""The dry run's plans, bytes and roofline arithmetic against the reference.

``repro_torch.launch.dryrun`` traces one rank of the production mesh over a
fake process group (256 ranks, or 512 with ``"pod"`` folded into the data
axis). The reference's side needs no devices: its plans, parameter specs and
input specs are read on ``jax.sharding.AbstractMesh`` meshes of the same
shapes, and each shard's shape from ``NamedSharding.shard_shape``. For every
assigned architecture, input shape, mesh and plan variant the two must agree
exactly on the skipped shapes, the plan's layout, the bytes a rank holds
(parameters, AdamW state, batch, cache) and the model FLOPs.

No test here imports ``repro.launch.dryrun`` or calls the reference's
``make_production_mesh``: the first sets ``XLA_FLAGS`` on import, which in a
worker whose JAX has not started would give every later test 512 devices.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import input_specs as jinput_specs  # noqa: E402
from repro.models import supported_shapes as jsupported  # noqa: E402
from repro.models.params import abstract_params, param_pspecs as jparam_pspecs  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.core import hardware, latency  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, release_fake_mesh  # noqa: E402
from repro_torch.models.io import INPUT_SHAPES, supported_shapes  # noqa: E402
from repro_torch.sharding.specs import dp_size  # noqa: E402

VARIANTS = {
    "baseline": {},
    "fsdp": {"fsdp": True},
    "ep": {"expert_mode": "ep"},
    "tp": {"expert_mode": "tp"},
    "replicated": {"attn_mode": "replicated"},
    "kv_seq": {"kv_shard": "seq"},
}


_MESH = {}


@pytest.fixture(scope="module", autouse=True)
def _release_group():
    """The meshes' fake default group does not outlive this file."""
    yield
    _MESH.clear()
    release_fake_mesh()


def _mesh(multi_pod: bool):
    """Rank 0 of the production mesh, made again only when another file's
    mesh (or the other shape) took the fake default group."""
    import torch.distributed as dist

    m = _MESH.get("mesh")
    if m is None or _MESH.get("multi_pod") != multi_pod or not dist.is_initialized():
        m = make_production_mesh(multi_pod=multi_pod)
        _MESH.update(mesh=m, multi_pod=multi_pod)
    return m


def _ref_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _ref_plan(cfg, shape, mesh, fsdp=False, expert_mode="", attn_mode="", kv_shard=""):
    """The reference dry run's plan selection (``dryrun.lower_one`` and
    ``main``) on an abstract mesh."""
    seq, batch, kind = INPUT_SHAPES[shape]
    if fsdp:
        return jspecs.ShardingPlan(mesh=mesh, dp_axes=mesh.axis_names, attn_mode="replicated", kv_shard="none",
                                   ffn_mode="tp", ffn_tp_axis=None, ep_axis=None, fsdp=True)
    plan = jspecs.make_plan(mesh, cfg, expert_mode=expert_mode, attn_override=attn_mode, kv_shard=kv_shard)
    return jspecs.adapt_plan_for_batch(plan, cfg, batch, kind)


def _is_spec(x):
    return isinstance(x, P)


def _shard_bytes(mesh, shapes, specs) -> int:
    """The bytes one device holds of the leaves ``shapes`` under ``specs``
    (raises where a spec does not divide its dimension)."""
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=_is_spec)
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(leaves, spec_leaves))


def _ref_bytes(cfg, shape, mesh, plan) -> dict:
    """The reference's bytes a device (``build_lowerable``'s shardings):
    parameters, the AdamW state for train, the batch (a decode step's
    tokens) and the decode cache; None where a shard does not divide."""
    seq, batch, kind = INPUT_SHAPES[shape]
    aparams = abstract_params(cfg)
    pspecs = jparam_pspecs(cfg, plan)
    out = {"params": _shard_bytes(mesh, aparams, pspecs)}
    specs = jinput_specs(cfg, shape)
    dp = plan.dp
    try:
        if kind in ("train", "prefill"):
            out["batch"] = sum(_shard_bytes(mesh, v, P(dp, *([None] * (len(v.shape) - 1))))
                               for v in specs["batch"].values())
        else:
            out["token"] = _shard_bytes(mesh, specs["token"], P(dp, None))
            c = specs["cache"]
            pairs = [(c.pos, P())]
            if cfg.has_attention:
                pairs += [(c.k, plan.kv_cache_spec()), (c.v, plan.kv_cache_spec())]
            if cfg.has_mamba:
                pairs += [(c.conv, plan.conv_cache_spec()), (c.ssm, plan.ssm_cache_spec())]
            out["cache"] = sum(_shard_bytes(mesh, a, s) for a, s in pairs)
    except ValueError:
        out["unsharded_batch"] = True
    if kind == "train":
        n = sum(math.prod(NamedSharding(mesh, s).shard_shape(a.shape))
                for a, s in zip(jax.tree.leaves(aparams), jax.tree.leaves(pspecs, is_leaf=_is_spec)))
        out["opt"] = 2 * 4 * n + 4  # float32 mu and nu, the int32 step
    return out


def _layout(plan, dp_sizes):
    return (plan.attn_mode, plan.kv_shard, plan.ffn_mode, plan.seq_shard_acts, plan.fsdp, dp_sizes)


def _ref_dp(plan, mesh):
    return math.prod(mesh.shape[a] for a in plan.dp_axes)


def test_the_port_assigns_the_reference_archs():
    assert tuple(ASSIGNED_ARCHS) == tuple(J_ARCHS)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_plans_bytes_and_model_flops_equal_the_reference(arch, multi_pod, variant):
    """Every input shape of ``arch`` on the mesh under the variant's plan:
    the skipped shapes, the layout, the bytes a rank holds and the model
    FLOPs equal the reference's. Where the reference cannot shard the batch
    (an FSDP plan's data axes do not divide it; its jit refuses such
    shardings), the port refuses a training batch as well and serves the
    rows whole (``specs.serving_rows``: the data axes dropped)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert supported_shapes(cfg) == jsupported(jcfg)
    mesh, jmesh = _mesh(multi_pod), _ref_mesh(multi_pod)
    assert mesh.world == jmesh.size == (512 if multi_pod else 256)
    assert mesh.name == ("2x16x16" if multi_pod else "16x16")
    kw = VARIANTS[variant]
    for shape, (seq, batch, kind) in INPUT_SHAPES.items():
        assert roofline.model_flops_for(cfg, shape) == jroof.model_flops_for(jcfg, shape)
        if supported_shapes(cfg)[shape] != "ok":
            continue
        plan = dryrun.select_plan(cfg, shape, mesh, **kw)
        jplan = _ref_plan(jcfg, shape, jmesh, **kw)
        assert _layout(plan, dp_size(plan)) == _layout(jplan, _ref_dp(jplan, jmesh)), shape
        want = _ref_bytes(jcfg, shape, jmesh, jplan)
        if want.pop("unsharded_batch", False):
            if kind == "train":
                with roofline.fake_tensors(), pytest.raises(ValueError, match="does not split"):
                    dryrun.build_step(cfg, seq, batch, kind, plan)
                continue
            with roofline.fake_tensors():
                step = dryrun.build_step(cfg, seq, batch, kind, plan)
            assert step.rows == batch and step.arg_bytes["params"] == want["params"], shape
            continue
        with roofline.fake_tensors():
            step = dryrun.build_step(cfg, seq, batch, kind, plan)
        assert step.arg_bytes == want, (shape, step.arg_bytes, want)


DEEPSEEK_PARAM_BYTES = 2_090_831_872  # a device's parameters on 16x16 and 2x16x16 (AbstractMesh, the reference)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_deepseek_bytes_a_rank(multi_pod):
    """The figures the reference's specs give on both meshes: DeepSeekMoE-16B
    holds 2,090,831,872 parameter bytes a device, prefill_32k's model
    FLOPs 5.4967e15."""
    cfg = get_config("deepseek-moe-16b")
    mesh = _mesh(multi_pod)
    plan = dryrun.select_plan(cfg, "prefill_32k", mesh)
    with roofline.fake_tensors():
        step = dryrun.build_step(cfg, *INPUT_SHAPES["prefill_32k"], plan)
    assert step.arg_bytes["params"] == DEEPSEEK_PARAM_BYTES
    assert roofline.model_flops_for(cfg, "prefill_32k") == pytest.approx(5.4967e15, rel=1e-4)


@pytest.fixture(scope="module")
def _fits():
    """40-sample a6000 latency fits in each package's memo (a full fit takes
    about a minute)."""
    n = 40
    jm = jlat.LatencyModel(jhw.get_chip("a6000"), n_samples=n)
    tm = latency.LatencyModel(hardware.get_chip("a6000"), n_samples=n)
    saved = (jlat._MODEL_CACHE.get(("a6000", 0)), latency._MODEL_CACHE.get(("a6000", 0)))
    jlat._MODEL_CACHE[("a6000", 0)], latency._MODEL_CACHE[("a6000", 0)] = jm, tm
    yield jm, tm
    for cache, old in zip((jlat._MODEL_CACHE, latency._MODEL_CACHE), saved):
        if old is None:
            cache.pop(("a6000", 0), None)
        else:
            cache[("a6000", 0)] = old


@pytest.mark.parametrize("source,arch,shape", [("tp", "qwen3-moe-30b-a3b", "decode_32k"),
                                               ("ep", "qwen3-moe-30b-a3b", "prefill_32k"),
                                               ("ilp", "qwen3-moe-30b-a3b", "decode_32k")])
def test_strategy_sources_plan_as_the_reference(_fits, source, arch, shape):
    """``--source``: the session's plan on the mesh (``HAPSession.sharding_plan``
    with the chip's cached latency model, then ``adapt_plan_for_batch``),
    against the reference's session on the abstract mesh; layout and bytes
    equal."""
    seq, batch, kind = INPUT_SHAPES[shape]
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh, jmesh = _mesh(False), _ref_mesh(False)
    plan = dryrun.select_plan(cfg, shape, mesh, source=source, chip="a6000")
    jplan = jspecs.adapt_plan_for_batch(_ref_session_plan(jcfg, shape, jmesh, source), jcfg, batch, kind)
    assert _layout(plan, dp_size(plan)) == _layout(jplan, _ref_dp(jplan, jmesh))
    with roofline.fake_tensors():
        step = dryrun.build_step(cfg, seq, batch, kind, plan)
    assert step.arg_bytes == _ref_bytes(jcfg, shape, jmesh, jplan)


def _ref_session_plan(cfg, shape, mesh, source):
    from repro.core import HAPSession as JSession
    from repro.core import Workload as JWorkload

    seq, batch, kind = INPUT_SHAPES[shape]
    session = JSession(cfg, "a6000", mesh.size, source=source, model=jlat.cached_latency_model("a6000"), mesh=mesh,
                       prompt_bucket=max(seq, 1))
    return session.sharding_plan(JWorkload(batch=batch, prompt=seq, gen=64),
                                 phase="decode" if kind == "decode" else "prefill")


@pytest.mark.parametrize("source", ["tp", "ep"])
def test_deepseek_has_no_session_plan_on_256_ranks_in_either_package(_fits, source):
    """A fault of the reference that the port keeps: on 256 devices the
    planner finds no DeepSeekMoE-16B plan and its static fallback
    (``HAPPlanner.tp_plan``) no expert strategy; both raise StopIteration."""
    cfg, jcfg = get_config("deepseek-moe-16b"), jget_config("deepseek-moe-16b")
    with pytest.raises(StopIteration):
        dryrun.select_plan(cfg, "decode_32k", _mesh(False), source=source, chip="a6000")
    with pytest.raises(StopIteration):
        _ref_session_plan(jcfg, "decode_32k", _ref_mesh(False), source)


# -- the wire factors ------------------------------------------------------------
_HLO = {
    "all-gather": "  %x = bf16[{n},128]{{1,0}} all-gather(bf16[8,128]{{1,0}} %p), replica_groups={{{{{g}}}}}, "
                  "dimensions={{0}}",
    "all-reduce": "  %x = f32[{n},128]{{1,0}} all-reduce(f32[{n},128]{{1,0}} %p), replica_groups={{{{{g}}}}}, "
                  "to_apply=%add",
    "reduce-scatter": "  %x = bf16[{n},128]{{1,0}} reduce-scatter(bf16[64,128]{{1,0}} %p), "
                      "replica_groups={{{{{g}}}}}, dimensions={{0}}, to_apply=%add",
    "all-to-all": "  %x = bf16[{n},128]{{1,0}} all-to-all(bf16[{n},128]{{1,0}} %p), replica_groups={{{{{g}}}}}, "
                  "dimensions={{0}}",
    "collective-permute": "  %x = f32[{n},128]{{1,0}} collective-permute(f32[{n},128]{{1,0}} %p), "
                          "source_target_pairs={{{{0,1}},{{1,0}}}}",
}


@pytest.mark.parametrize("group", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("kind", list(_HLO))
def test_wire_bytes_equal_the_reference_factors(kind, group):
    """``wire_bytes`` against the reference's ``collective_bytes`` on one
    synthetic HLO line (``f32_as_bf16=False``: no upcast to undo)."""
    n = 24
    line = _HLO[kind].format(n=n, g=",".join(str(i) for i in range(group)))
    want = jroof.collective_bytes(line, f32_as_bf16=False)[kind]
    payload = n * 128 * (4 if line.split("= ")[1].startswith("f32") else 2)
    g = 2 if kind == "collective-permute" else group  # the reference's group size of a permute line
    assert roofline.wire_bytes(kind, payload, g) == pytest.approx(want, rel=1e-12, abs=0.0)


def test_costs_arithmetic_and_report():
    a = roofline.Costs(10.0, 20.0, {"all-reduce": 4.0})
    b = roofline.Costs(3.0, 30.0, {"all-reduce": 1.0, "all-gather": 2.0})
    d = (a - b).clamp()
    assert (d.flops, d.bytes_accessed, d.coll["all-reduce"], d.coll["all-gather"]) == (7.0, 0.0, 3.0, 0.0)
    s = (a + b).scale(2.0)
    assert (s.flops, s.bytes_accessed, s.coll["all-gather"]) == (26.0, 100.0, 4.0)
    cfg = get_config("deepseek-moe-16b")
    rep = roofline.build_report(arch="deepseek-moe-16b", shape="decode_32k", mesh_name="16x16", n_devices=256, cfg=cfg,
                                full=roofline.Costs(989e9, 3.35e9, {"all-reduce": 375e6}), peak_mem=2.0**30)
    h100 = hardware.get_chip("h100")
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12, 375e9)
    assert rep.t_compute == pytest.approx(1e-3) and rep.t_memory == pytest.approx(1e-3)
    assert rep.t_collective == pytest.approx(1e-3)
    assert rep.flops_ratio == pytest.approx(roofline.model_flops_for(cfg, "decode_32k") / (989e9 * 256))
    assert rep.row().startswith("deepseek-moe-16b,decode_32k,16x16,1.000,1.000,1.000,")
    with pytest.raises(ValueError, match="unknown collective"):
        roofline.wire_bytes("broadcast", 1.0, 2)
