"""The port's sharding plans against ``repro.sharding.specs`` and
``repro.models.params``, on the CPU and without a process group.

The resolver copy must give the reference's fields for every registered
config x model-axis size {1, 2, 4} x the HAP strategy pairs, on a stand-in
mesh (``axis_names`` and ``shape`` are all either resolver reads). One
field differs by design: where the reference keeps the decode cache
sequence-sharded (``seq``), the port keeps it whole on every rank
(``none``). ``param_pspecs`` must give the reference's specs, each rank's
shard its shape, and ``init_params(..., shard=...)`` the same values as
the whole init cut to the shard. The grouped-matmul launch plans must cover
the per-rank shapes the sharded path sends (TP2's d_ff of 704 and TP4's
352, which do not fill a 128-wide tile; EP2's 32 experts).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec  # noqa: E402

from repro.core.strategy import AttnStrategy as JAttn  # noqa: E402
from repro.core.strategy import ExpertStrategy as JExpert  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.params import param_pspecs as jparam_pspecs  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core import fixed_plan  # noqa: E402
from repro_torch.core.strategy import AttnStrategy, ExpertStrategy  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.models.params import init_params, param_pspecs, param_shapes, shard_params  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

FIELDS = ("dp_axes", "attn_mode", "attn_tp_axis", "ffn_mode", "ffn_tp_axis", "ep_axis", "seq_axis", "moe_pipeline")
PAIRS = [("TP", "TP"), ("TP", "EP"), ("DP", "EP"), ("DP", "TP")]


def _mesh(tp, dp=1):
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": dp, "model": tp})


def _strategies(attn, expert, tp, jax_side):
    A, E = (JAttn, JExpert) if jax_side else (AttnStrategy, ExpertStrategy)
    a = A(dp=1, tp=tp) if attn == "TP" else A(dp=tp, tp=1)
    e = E(tp=tp, ep=1) if expert == "TP" else E(tp=1, ep=tp)
    return a, e


@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list_configs())
def test_resolver_equals_reference(name, tp, pair):
    cfg, jcfg = get_config(name), jget_config(name)
    mesh = _mesh(tp)
    got = specs.strategy_sharding_plan(mesh, cfg, *_strategies(*pair, tp, False))
    want = jspecs.strategy_sharding_plan(mesh, jcfg, *_strategies(*pair, tp, True))
    assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}
    assert got.kv_shard == want.kv_shard
    for kv in ("", "heads", "seq"):
        base = specs.make_plan(mesh, cfg, kv_shard=kv)
        jbase = jspecs.make_plan(mesh, jcfg, kv_shard=kv)
        assert {f: getattr(base, f) for f in FIELDS} == {f: getattr(jbase, f) for f in FIELDS}
        assert base.kv_shard == jbase.kv_shard
    # the kernel-seam axes resolve as the reference's (the port's carry the global extent)
    a, ja = got.attn_kernel_axes(cfg.num_heads, cfg.num_kv_heads), want.attn_kernel_axes(cfg.num_heads,
                                                                                          cfg.num_kv_heads)
    assert (a is None) == (ja is None)
    if cfg.is_moe:
        e, je = got.expert_kernel_axes(cfg.moe_d_ff), want.expert_kernel_axes(cfg.moe_d_ff)
        assert (e is None) == (je is None) and (e is None or (e.axis, e.dim) == (je.axis, cfg.moe_d_ff))


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_adapt_plan_for_batch_equals_reference(batch):
    cfg, jcfg = get_config("deepseek-moe-16b"), jget_config("deepseek-moe-16b")
    mesh = _mesh(2, dp=2)
    for kind in ("prefill", "decode"):
        got = specs.adapt_plan_for_batch(specs.make_plan(mesh, cfg), cfg, batch, kind)
        want = jspecs.adapt_plan_for_batch(jspecs.make_plan(mesh, jcfg), jcfg, batch, kind)
        assert (got.dp_axes, got.kv_shard) == (want.dp_axes, want.kv_shard)
        # a data axis of 2 in the mesh: the port names it, whether the plan
        # shards the batch over it or, seq_all, the cache's positions
        assert specs.unported_layout(got) is not None and "data" in specs.unported_layout(got)


def _spec_tree(tree):
    return {k: _spec_tree(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}


@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list_configs())
def test_param_pspecs_equal_reference(name, tp, pair):
    cfg, jcfg = get_config(name), jget_config(name)
    mesh = _mesh(tp)
    got = param_pspecs(cfg, specs.strategy_sharding_plan(mesh, cfg, *_strategies(*pair, tp, False)))
    jplan = jspecs.strategy_sharding_plan(mesh, jcfg, *_strategies(*pair, tp, True))
    want = _spec_tree(jparam_pspecs(jcfg, jplan))

    def pad(t, shape):
        return {k: pad(v, shape[k]) if isinstance(v, dict) else tuple(v) + (None,) * (len(shape[k]) - len(v))
                for k, v in t.items()}

    assert got == pad(want, param_shapes(cfg))
    assert isinstance(jparam_pspecs(jcfg, jplan)["embed"], PartitionSpec)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def test_per_rank_shapes_at_full_width():
    """DeepSeekMoE-16B's shard shapes on two ranks, each rank's a half of
    every sharded leaf: heads, vocabulary, d_ff (TP) or experts (EP)."""
    cfg = get_config("deepseek-moe-16b")
    whole = _meta(param_shapes(cfg))
    for experts, moe in (("TP2", (28, 64, 2048, 704)), ("EP2", (28, 32, 2048, 1408))):
        plan = fixed_plan("TP2", experts).to_sharding_plan(_mesh(2), cfg, phase="prefill")
        shapes = [dict((k, tuple(v.shape)) for k, v in _leaves(shard_params(whole, cfg, plan, r))) for r in (0, 1)]
        assert shapes[0] == shapes[1]
        s = shapes[0]
        assert s["embed"] == (51200, 2048) and "lm_head" not in s  # tied: the logits come from the embedding
        assert s["layers/attn/wq"] == (28, 2048, 1024) and s["layers/attn/wo"] == (28, 1024, 2048)
        assert s["layers/moe/wi_gate"] == moe and s["layers/moe/router"] == (28, 2048, 64)
        assert s["layers/moe/shared_wi_gate"] == (28, 2048, 1408) and s["layers/moe/shared_wo"] == (28, 1408, 2048)
        half = sum(torch.Size(v).numel() for v in s.values())
        full = sum(torch.Size(v).numel() for _, v in _leaves(param_shapes(cfg)))
        assert 0.5 * full < half < 0.51 * full  # only the norms and the router are whole on each rank


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta") for k, v in tree.items()}


def test_packed_spec_drops_the_group_axis_that_does_not_divide():
    """DeepSeek's wi has 11 groups of 128 on its last dim: TP2 cannot split
    them, so its packed leaf is whole on both ranks; wo's contraction dim
    splits; under EP the experts split."""
    sizes = {"model": 2}
    assert specs.packed_spec_for((None, None, None, "model"), (28, 64, 2048, 11, 64), sizes) == (None,) * 5
    assert specs.packed_spec_for((None, None, "model", None), (28, 64, 1408, 16, 64), sizes) == (
        None, None, "model", None, None)
    assert specs.packed_spec_for((None, "model", None, None), (28, 64, 2048, 11, 64), sizes)[1] == "model"
    assert jspecs.quantized_pspec(PartitionSpec(None, None, "model")) == PartitionSpec(
        *specs.quantized_pspec((None, None, "model")))


@pytest.mark.parametrize("plan", [("TP2", "TP2"), ("TP2", "EP2"), ("DP2", "EP2")])
def test_sharded_init_equals_the_whole_init_cut(plan):
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32")
    splan = fixed_plan(*plan).to_sharding_plan(_mesh(2), cfg, phase="prefill")
    whole = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for rank in (0, 1):
        part = dict(_leaves(init_params(cfg, torch.Generator().manual_seed(3), "cpu", shard=(splan, rank))))
        cut = dict(_leaves(shard_params(whole, cfg, splan, rank)))
        assert part.keys() == cut.keys()
        for k in part:
            assert torch.equal(part[k], cut[k]), k


def test_unported_layouts_are_named():
    cfg = get_config("deepseek-moe-16b")
    assert specs.unported_layout(specs.make_plan(_mesh(2), cfg)) is None
    assert specs.unported_layout(specs.make_plan(_mesh(2), cfg, kv_shard="seq")) is None
    assert specs.unported_layout(specs.make_plan(_mesh(2), cfg, kv_shard="seq_all")) is None
    assert "data" in specs.unported_layout(specs.make_plan(_mesh(2, dp=2), cfg))
    assert specs.unported_layout(None) is None


# the grouped matmul at the per-rank shapes of the sharded path: TP2 / TP4
# (wi: d_ff 704 / 352 columns; wo: a 704 / 352 contraction) at the decode,
# fused and prefill capacities, and EP2's 32 local experts at the exchanged
# capacities (decode: 2 x 8; prefill: 2 x 32 serial, 2 x 8 in four slabs)
SHARDED_GMM_SHAPES = (
    [(64, C, 2048, f) for C in (8, 16, 64) for f in (704, 352)]
    + [(64, C, K, 2048) for C in (8, 16, 64) for K in (704, 352)]
    + [(32, C, *dims) for C in (8, 16, 64) for dims in ((2048, 1408), (1408, 2048))]
)


@pytest.mark.parametrize("shape", SHARDED_GMM_SHAPES, ids=lambda s: "E{}_C{}_{}x{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gmm_plan_covers_the_sharded_shapes(shape, dtype):
    E, C, d, f = shape
    plan = gm.gmm_plan(E, C, d, f, dtype, True, 132)
    blocks = plan.grid[0] * plan.grid[1]
    seen = [item for b in range(blocks) for item in plan.block_items(b)]
    assert len(seen) == len(set(seen))
    assert set(seen) == {(e, t, p) for e in range(E) for t in range(plan.f_tiles) for p in range(plan.passes)}
    assert (plan.f_tiles - 1) * plan.bm < f <= plan.f_tiles * plan.bm  # 704 = 5.5 tiles of 128
    assert (plan.passes - 1) * plan.n < C <= plan.passes * plan.n
    assert plan.variant == ("wgmma" if dtype == torch.bfloat16 else "simt")
