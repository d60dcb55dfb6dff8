"""The launch plans of the port's two tensor-core kernels, on the CPU.

``grouped_matmul`` and ``flash_attention`` work out, in Python and before
the launch, which kernel variant runs (``wgmma`` or ``simt``), its tiles,
stages, rows per pass, grid and dynamic shared memory; the CUDA launchers
only check the plan. These tests hold every plan on the main path
(DeepSeekMoE-16B: E = 64 experts, wi 2048 x 1408 and wo 1408 x 2048, at the
decode, fused-step and prefill capacities; flash at B=4 S=128 H=16 hd=128)
and the card tests' shapes to the kernels' contracts: every work item is
covered exactly once, shared memory fits a block, the wgmma width N is a
multiple of 8 in 8..256, and the variant follows the dtype and the layout.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402

SMEM_MAX = 232_448
H100_SMS = 132

# (E, C, d, f): the main path's expert matmuls at every capacity the serving
# paths give (8: decode and the continuous chunk; 16: a fused chunk + decode
# step; 64: static prefill), the capacities the card tests add, and the card
# tests' own shapes
WI, WO = (2048, 1408), (1408, 2048)
GMM_SHAPES = (
    [(64, C, *dims) for C in (8, 16, 64) for dims in (WI, WO)]
    + [(64, C, *WI) for C in (1, 65, 256, 300)]
    + [(4, 5, 40, 33), (8, 24, 256, 200), (3, 100, 96, 130), (1, 8, 16, 64), (2, 300, 96, 1400)]
)
# the other MoE families' expert grids, wi and wo, at the serve cell's
# decode capacity (4 rows: the minimum, 8) and its prefill capacity (4 x 128
# tokens): Qwen3-30B-A3B (E=128, top-8, 2048 x 768: C=40), Mixtral-8x7B
# (E=8, top-2, 4096 x 14336: C=2 as given, 8, 160), Qwen1.5-MoE-A2.7B
# (E=60, top-4, 2048 x 1408: C=48), Qwen2-57B-A14B (E=64, top-8,
# 3584 x 2560: C=80)
FAMILY_GMM_SHAPES = (
    [(128, C, *dims) for C in (1, 8, 40) for dims in ((2048, 768), (768, 2048))]
    + [(8, C, *dims) for C in (2, 8, 160) for dims in ((4096, 14336), (14336, 4096))]
    + [(60, C, *dims) for C in (8, 48) for dims in (WI, WO)]
    + [(64, C, *dims) for C in (8, 80) for dims in ((3584, 2560), (2560, 3584))]
)


def _gmm_ids(shape):
    return "E{}_C{}_{}x{}".format(*shape)


def _covered_once(plan, blocks, expect):
    seen = [item for b in range(blocks) for item in plan.block_items(b)]
    assert len(seen) == len(set(seen)), "a work item is computed twice"
    assert set(seen) == expect, "the plan misses work items or adds some"


@pytest.mark.parametrize("shape", GMM_SHAPES + FAMILY_GMM_SHAPES, ids=_gmm_ids)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_gmm_plan_covers_every_item_once(shape, dtype):
    E, C, d, f = shape
    plan = gm.gmm_plan(E, C, d, f, dtype, True, H100_SMS)
    blocks = plan.grid[0] * plan.grid[1]
    _covered_once(plan, blocks, {(e, t, p) for e in range(E) for t in range(plan.f_tiles) for p in range(plan.passes)})
    # the row passes tile [0, C) and the f tiles tile [0, f)
    assert (plan.passes - 1) * plan.n < C <= plan.passes * plan.n
    assert (plan.f_tiles - 1) * plan.bm < f <= plan.f_tiles * plan.bm
    assert 0 <= plan.smem_bytes <= SMEM_MAX
    assert 8 <= plan.n <= 256 and plan.n % 8 == 0
    if plan.variant == "wgmma":
        # persistent: at most one block per SM, each given its share
        assert blocks == min(plan.items, H100_SMS)
        assert max(len(plan.block_items(b)) for b in range(blocks)) == -(-plan.items // blocks)
        assert plan.stages >= 2
        assert plan.smem_bytes >= 1024 + plan.stages * (gm.wgmma_stage_bytes(plan.n, plan.bm) + 16)


@pytest.mark.parametrize("shape", GMM_SHAPES + FAMILY_GMM_SHAPES, ids=_gmm_ids)
def test_gmm_plan_variant(shape):
    """bf16 with d and f multiples of 8 on aligned operands takes wgmma;
    float32, unaligned operands and ragged rows take simt."""
    E, C, d, f = shape
    tma_ok = d % 8 == 0 and f % 8 == 0
    assert gm.gmm_plan(E, C, d, f, torch.bfloat16, True, H100_SMS).variant == ("wgmma" if tma_ok else "simt")
    assert gm.gmm_plan(E, C, d, f, torch.bfloat16, False, H100_SMS).variant == "simt"
    assert gm.gmm_plan(E, C, d, f, torch.float32, True, H100_SMS).variant == "simt"


@pytest.mark.parametrize("C,n,passes", [(1, 8, 1), (8, 8, 1), (16, 16, 1), (64, 64, 1), (65, 80, 1), (256, 128, 2),
                                        (300, 128, 3)])
def test_gmm_plan_rows_per_pass(C, n, passes):
    """N is the capacity rounded up to a width the kernel has (8..128);
    larger capacities walk in passes of 128 rows. A decode step (C = 8) is
    m64n8k16 and multiplies no padding row."""
    plan = gm.gmm_plan(64, C, *WI, torch.bfloat16, True, H100_SMS)
    assert (plan.variant, plan.n, plan.passes) == ("wgmma", n, passes)


@pytest.mark.parametrize(
    "change",
    [
        {"smem_bytes": SMEM_MAX + 1},
        {"n": 260},
        {"n": 12},
        {"n": 0},
        {"variant": "wmma"},
        {"stages": 1},
        {"grid": (H100_SMS, 2)},
        {"bm": 96},
        {"passes": 0},
    ],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()),
)
def test_gmm_bad_plan_raises(change):
    plan = gm.gmm_plan(64, 8, *WI, torch.bfloat16, True, H100_SMS)
    gm.check_plan(plan)
    with pytest.raises(ValueError):
        gm.check_plan(dataclasses.replace(plan, **change))


@pytest.mark.parametrize("change", [{"n": 24}, {"grid": (2, 64)}, {"smem_bytes": 4096}, {"bm": 64}])
def test_gmm_bad_simt_plan_raises(change):
    plan = gm.gmm_plan(64, 8, *WI, torch.float32, True, H100_SMS)
    gm.check_plan(plan)
    with pytest.raises(ValueError):
        gm.check_plan(dataclasses.replace(plan, **change))


@pytest.mark.parametrize("shape", FAMILY_GMM_SHAPES, ids=_gmm_ids)
def test_gmm_plan_at_the_families_grids(shape):
    """A wgmma plan at every family's expert grid, with more items than
    SMs: Mixtral's 8 experts still give 8 x 112 (wi) or 8 x 32 (wo) f
    tiles per pass. Capacities above 128 walk in passes of 128 rows, each
    reading the whole weight again (Mixtral's prefill, C=160: two)."""
    E, C, d, f = shape
    plan = gm.gmm_plan(E, C, d, f, torch.bfloat16, True, H100_SMS)
    assert plan.variant == "wgmma" and plan.bm == 128 and plan.stages == gm.WG_STAGES
    assert plan.items == E * -(-f // 128) * plan.passes > H100_SMS
    assert plan.grid == (H100_SMS, 1)
    assert plan.n == next(w for w in gm.WGMMA_N if w >= min(C, 128)) and plan.passes == -(-C // 128)


def test_gmm_plan_refuses_an_empty_product():
    with pytest.raises(ValueError):
        gm.gmm_plan(64, 0, *WI, torch.bfloat16, True, H100_SMS)


# (B, Hq, Sq, hd): the main path's prefill, the long-prompt row of the chip
# smoke test, and the card tests' cases
FLASH_SHAPES = [
    (4, 16, 128, 128),
    (1, 16, 2048, 128),
    (2, 4, 37, 32),
    (1, 4, 70, 64),
    (3, 8, 1, 16),
    (2, 4, 100, 96),
    (1, 2, 130, 48),
    (2, 4, 37, 40),
    # the other families' prefills (serve cell: B=4, S=128): Gemma-2-9B and
    # Gemma-7B (16 heads of 256), and at an 8192-token prompt; Qwen3-30B,
    # Mixtral-8x7B, Mistral-Nemo and Gemma-3 (32 heads of 128); Qwen2-57B (28)
    (4, 16, 128, 256),
    (1, 16, 8192, 256),
    (4, 32, 128, 128),
    (4, 28, 128, 128),
]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "B{}_H{}_S{}_hd{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_plan_covers_every_item_once(shape, dtype):
    B, Hq, Sq, hd = shape
    plan = fa.flash_plan(B, Hq, Sq, hd, dtype, True)
    qt = -(-Sq // plan.block_q)
    _covered_once(plan, plan.items, {(t, h, b) for t in range(qt) for h in range(Hq) for b in range(B)})
    assert 0 < plan.smem_bytes <= SMEM_MAX
    assert 8 <= plan.block_k <= 256 and plan.block_k % 8 == 0
    assert plan.variant == ("wgmma" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt")
    if plan.variant == "wgmma":
        assert plan.smem_bytes == 1024 + 5 * 64 * hd * 2 + 64
        # the causal q tiles with the most keys start first
        assert plan.block_items(0)[0][0] == qt - 1


def test_flash_plan_at_head_dim_256():
    """Head dim 256 has a wgmma instance: the q tile and two stages of K
    and V (64 x 256 bf16 each) plus alignment and barriers, 164,928 bytes;
    its float32 simt body keeps 140,672 bytes. A head dim without a wgmma
    instance (144) takes simt in bf16 too."""
    plan = fa.flash_plan(4, 16, 128, 256, torch.bfloat16, True)
    assert plan.variant == "wgmma" and plan.smem_bytes == fa.wgmma_smem_bytes(256) == 164_928 <= SMEM_MAX
    f32 = fa.flash_plan(4, 16, 128, 256, torch.float32, True)
    assert f32.variant == "simt" and f32.smem_bytes == fa.simt_smem_bytes(256) == 140_672
    assert fa.flash_plan(4, 16, 128, 144, torch.bfloat16, True).variant == "simt"
    assert fa.HD_MAX == 256 and 256 in fa.WGMMA_HDS and 144 not in fa.WGMMA_HDS


def _tma_ok(t):
    return fa._aligned((t.data_ptr(),), t.stride()[:3], t.element_size())


def test_flash_plan_simt_for_unaligned_layouts():
    assert fa.flash_plan(4, 16, 128, 128, torch.bfloat16, False).variant == "simt"
    q = torch.zeros(2, 9, 4, 32)[:, 1:].transpose(1, 2)  # 16-byte aligned rows
    assert _tma_ok(q)
    odd = torch.zeros(2, 9, 4, 33)[..., :32].transpose(1, 2)  # rows 132 bytes apart
    assert not _tma_ok(odd)
    shifted = torch.zeros(2 * 8 * 4 * 32 + 1)[1:].view(2, 8, 4, 32).transpose(1, 2)  # start 4 bytes in
    assert not _tma_ok(shifted)


@pytest.mark.parametrize(
    "change",
    [{"smem_bytes": SMEM_MAX + 1}, {"block_k": 260}, {"block_k": 20}, {"variant": "mma"}, {"stages": 3},
     {"grid": (1, 16, 4)}, {"hd": 40}, {"smem_bytes": 1024}],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()),
)
def test_flash_bad_plan_raises(change):
    plan = fa.flash_plan(4, 16, 128, 128, torch.bfloat16, True)
    fa.check_plan(plan)
    with pytest.raises(ValueError):
        fa.check_plan(dataclasses.replace(plan, **change))


def test_variant_counter_is_apart_from_launch_counts():
    _build.reset_launch_counts()
    _build.count_launch("grouped_matmul", "wgmma")
    _build.count_launch("grouped_matmul", "simt")
    _build.count_launch("int4_dequant")
    assert dict(_build.LAUNCH_COUNTS) == {"grouped_matmul": 2, "int4_dequant": 1}
    assert dict(_build.VARIANT_COUNTS) == {("grouped_matmul", "wgmma"): 1, ("grouped_matmul", "simt"): 1}
    _build.reset_launch_counts()
    assert not _build.LAUNCH_COUNTS and not _build.VARIANT_COUNTS


def test_cpu_calls_make_no_plan_and_count_nothing():
    _build.reset_launch_counts()
    lhs, rhs = torch.ones(2, 3, 8), torch.ones(2, 8, 16)
    assert torch.equal(gm.grouped_matmul(lhs, rhs), gm.grouped_matmul_plain(lhs, rhs))
    q = torch.ones(1, 2, 5, 16)
    assert torch.equal(fa.flash_attention(q, q, q), fa.flash_attention_plain(q, q, q))
    assert not _build.LAUNCH_COUNTS and not _build.VARIANT_COUNTS
