"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides inside its body whether a CUDA sm_90 card
is present and skips otherwise, so every pytest worker collects the same
tests. On the card, run ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest``: the suite's conftest imports
JAX, which the card's machine need not have). Tolerances: float32 kernels sum
in another order than PyTorch's CPU/cuBLAS paths (1e-4); bfloat16 outputs
are rounded once from float32 on both sides, so they may differ by one
bfloat16 step (2^-8 relative) on top of that (2e-2).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

DTYPES = ["float32", "bfloat16"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")
    return torch.device("cuda")


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _randn(rng, shape, dtype, dev, std=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * std).to(dev, getattr(torch, dtype))


def _variant(dtype, wgmma_shape):
    """The variant a launch plan picks: wgmma for bfloat16 on a shape TMA
    can describe, simt otherwise."""
    return "wgmma" if dtype == "bfloat16" and wgmma_shape else "simt"


def _decode_variant(dtype, hd):
    """The paged kernels' variant: split for bfloat16 at the head dims the
    split kernels are built for (aligned operands), simt otherwise."""
    from repro_torch.kernels.paged_attention import SPLIT_HDS

    return "split" if dtype == "bfloat16" and hd in SPLIT_HDS else "simt"


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,hd,window,softcap",
    [
        (2, 4, 2, 37, 37, 32, 0, 0.0),
        (1, 4, 4, 70, 100, 64, 16, 30.0),
        (3, 8, 2, 1, 65, 16, 0, 0.0),
        (4, 16, 16, 128, 128, 128, 0, 0.0),  # main path: DeepSeekMoE-16B prefill
        (2, 4, 4, 1, 50, 128, 0, 0.0),  # one query row
        (2, 4, 4, 100, 300, 96, 0, 0.0),  # Sq < Sk, 64-byte swizzle in three column blocks
        (1, 2, 1, 130, 200, 48, 40, 0.0),  # GQA, window, a ragged third q tile
        (1, 2, 2, 300, 300, 128, 100, 20.0),  # window + softcap over five key tiles
        (2, 4, 2, 37, 37, 40, 0, 0.0),  # head dim not a multiple of 16: simt in bf16 too
        (4, 16, 8, 128, 128, 256, 0, 50.0),  # Gemma-2-9B prefill: hd 256, G=2, softcap 50
        (1, 16, 8, 300, 300, 256, 100, 50.0),  # hd 256, window + softcap over five key tiles
        (2, 7, 1, 70, 70, 256, 0, 0.0),  # hd 256, G=7 (Qwen2-57B's group)
        (1, 8, 1, 65, 100, 256, 16, 0.0),  # hd 256, G=8, Sq < Sk, window
        (2, 4, 4, 1, 50, 256, 0, 0.0),  # hd 256, one query row
        (2, 32, 4, 100, 100, 128, 0, 0.0),  # Qwen3-30B-A3B's G=8 at hd 128
        (2, 4, 2, 37, 37, 144, 0, 0.0),  # hd 144: no wgmma instance, simt in bf16 too
        (4, 25, 5, 128, 128, 64, 0, 0.0),  # Hymba-1.5B prefill: hd 64, G=5
        (4, 25, 5, 128, 128, 64, 1024, 0.0),  # Hymba's local layers (window 1024)
        (1, 25, 5, 132, 132, 64, 1024, 0.0),  # Hymba, a ragged last q tile
        (1, 32, 8, 2917, 2917, 128, 0, 0.0),  # LLaVA: 2,880 patches + 37 text tokens, a partial last q tile
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(B, Hq, Hkv, Sq, Sk, hd, window, softcap, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import LAUNCH_COUNTS, VARIANT_COUNTS

    dev = _card()
    rng = np.random.default_rng(0)
    # model layout (B, S, H, hd) seen through transposed views, as on the path
    q, k, v = (
        _randn(rng, (B, S, H, hd), dtype, dev).transpose(1, 2)
        for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))
    )
    n0 = LAUNCH_COUNTS["flash_attention"]
    key = ("flash_attention", _variant(dtype, hd in fa.WGMMA_HDS))
    v0 = VARIANT_COUNTS[key]
    out = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention"] == n0 + 1 and VARIANT_COUNTS[key] == v0 + 1
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=softcap)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "B,C,Hq,Hkv,hd,bs,nb,window,is_global,softcap",
    [
        (4, 1, 16, 16, 128, 145, 1, 0, True, 0.0),  # main path: identity table, Smax 145
        (3, 5, 4, 2, 32, 16, 4, 6, False, 25.0),  # block pool, chunk, window, softcap
        (2, 40, 4, 2, 64, 8, 12, 0, True, 0.0),  # C*G = 80 rows: two row chunks
        (4, 1, 25, 5, 64, 145, 1, 0, True, 0.0),  # Hymba-1.5B's static decode: hd 64, G=5
        (4, 1, 25, 5, 64, 145, 1, 1024, False, 0.0),  # its local layers
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_kernel(B, C, Hq, Hkv, hd, bs, nb, window, is_global, softcap, dtype):
    from repro_torch.kernels import paged_attention as pa

    dev = _card()
    rng = np.random.default_rng(1)
    if nb == 1:
        N, tables = B, torch.arange(B, dtype=torch.int32)[:, None]
        pos = torch.full((B,), 135, dtype=torch.int32)
    else:
        N = B * nb + 1  # page 0 is the trash page
        t = np.arange(1, B * nb + 1).reshape(B, nb)
        t[0, -1] = 0  # a row whose last table entry is the trash page
        tables = torch.from_numpy(t.astype(np.int32))
        pos = torch.from_numpy(np.array([(3 + 7 * i) % ((nb - 1) * bs - C) for i in range(B)], np.int32))
    q = _randn(rng, (B, C, Hq, hd), dtype, dev)
    kp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    vp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    kn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    vn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    tables, pos = tables.to(dev), pos.to(dev)
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    kp2, vp2 = kp.clone(), vp.clone()
    out, kp_out, vp_out = pa.paged_attention(q, kp, vp, tables, kn, vn, pos, is_global, **kw)
    torch.cuda.synchronize()
    want, kp_w, vp_w = pa.paged_attention_plain(q, kp2, vp2, tables, kn, vn, pos, is_global, **kw)
    assert kp_out is kp and vp_out is vp  # in place
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    live = slice(0, N) if nb == 1 else slice(1, N)
    assert torch.equal(kp[live], kp_w[live]) and torch.equal(vp[live], vp_w[live])


@pytest.mark.parametrize("Hq,Hkv,hd", [(25, 5, 64), (16, 16, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_contiguous_per_row_positions(Hq, Hkv, hd, dtype):
    """The contiguous continuous decode step: 8 rows of a (8, 320) cache
    through the identity table, each at its own position (40-300), one
    row at position 0 (a slot no request has used); Hymba-1.5B's and
    DeepSeekMoE-16B's heads."""
    from repro_torch.kernels import paged_attention as pa

    dev = _card()
    rng = np.random.default_rng(2)
    B, Smax = 8, 320
    pos = torch.tensor([40, 300, 77, 0, 256, 129, 288, 191], dtype=torch.int32, device=dev)
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    q = _randn(rng, (B, 1, Hq, hd), dtype, dev)
    kc, vc = (_randn(rng, (B, Smax, Hkv, hd), dtype, dev) for _ in range(2))
    kn, vn = (_randn(rng, (B, 1, Hkv, hd), dtype, dev) for _ in range(2))
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = pa.paged_attention(q, kc, vc, tables, kn, vn, pos, True, scale=hd**-0.5)
    torch.cuda.synchronize()
    want, kw, vw = pa.paged_attention_plain(q, kc2, vc2, tables, kn, vn, pos, True, scale=hd**-0.5)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(kc, kw) and torch.equal(vc, vw)
    assert torch.equal(out, pa.paged_attention(q, kc, vc, tables, kn, vn, pos, True, scale=hd**-0.5)[0])


def _scattered(rng, B, nb, N):
    """Each row's table: nb distinct pages of 1..N-1 in random order."""
    return rng.permutation(np.arange(1, N))[: B * nb].reshape(B, nb).astype(np.int32)


# B, C, Hq, Hkv, hd, bs, nb, pos, window: the split variant's edges
# (64-key splits aligned at 0), the identity table with a 145-token page,
# the continuous chunk on scattered pages, a grid of 70 rows, and a
# 4,096-token context
SPLIT_CASES = {
    "pos_split_minus_1": (3, 1, 8, 2, 128, 16, 8, [63, 63, 62], 0),
    "pos_split": (3, 1, 8, 2, 128, 16, 8, [64, 64, 0], 0),
    "pos_split_plus_1": (3, 1, 8, 2, 128, 16, 8, [65, 1, 127], 0),
    "chunk_across_split": (2, 3, 4, 4, 64, 16, 8, [62, 127], 0),
    "identity_bs145": (4, 1, 16, 16, 128, 145, 1, [135, 0, 64, 144], 0),
    "chunk64_scattered": (1, 64, 16, 16, 128, 16, 20, [192], 0),
    "chunk64_window": (1, 64, 16, 16, 128, 16, 20, [150], 70),
    "large_batch": (70, 1, 4, 2, 64, 8, 12, [(13 * b) % 95 for b in range(70)], 0),
    # 64 splits x 8 rows x 16 heads: many more blocks than fit on the card at once
    "long_context": (8, 1, 16, 16, 128, 16, 256, [4095 - 37 * b for b in range(8)], 0),
    # head dim 256 (Gemma-7B, Gemma-2-9B): decode past a 4,096-token window
    # (Gemma-2's), G=2; a chunk across a split; a G=8 group
    "hd256_window_4096": (4, 1, 16, 8, 256, 16, 400, [6000, 5000, 4100, 64], 4096),
    "hd256_chunk_across_split": (2, 5, 4, 2, 256, 16, 8, [62, 100], 0),
    "hd256_g8": (3, 1, 8, 1, 256, 16, 8, [63, 64, 127], 0),
    # the families' groups at hd 128: Qwen3-30B-A3B (32/4), Qwen2-57B (28/4)
    "g8_qwen3": (4, 1, 32, 4, 128, 16, 20, [100, 200, 300, 319], 0),
    "g7_chunk": (2, 3, 28, 4, 128, 16, 8, [10, 60], 0),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_split_edges(name, dtype):
    """Against the plain version, pages included, and two calls bit-equal."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels._build import VARIANT_COUNTS

    dev = _card()
    B, C, Hq, Hkv, hd, bs, nb, pos, window = SPLIT_CASES[name]
    rng = np.random.default_rng(9)
    if nb == 1:
        N, tables = B, np.arange(B, dtype=np.int32)[:, None]
    else:
        N = B * nb + 1
        tables = _scattered(rng, B, nb, N)
    q = _randn(rng, (B, C, Hq, hd), dtype, dev)
    kp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    vp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    kn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    vn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    tables = torch.from_numpy(tables).to(dev)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(scale=hd**-0.5, window=window)
    is_global = window == 0
    pages = {k: (kp.clone(), vp.clone()) for k in ("kernel", "again", "plain")}
    key = ("paged_attention", _decode_variant(dtype, hd))
    v0 = VARIANT_COUNTS[key]
    out, _, _ = pa.paged_attention(q, *pages["kernel"], tables, kn, vn, posv, is_global, **kw)
    torch.cuda.synchronize()
    assert VARIANT_COUNTS[key] == v0 + 1
    again, _, _ = pa.paged_attention(q, *pages["again"], tables, kn, vn, posv, is_global, **kw)
    want, _, _ = pa.paged_attention_plain(q, *pages["plain"], tables, kn, vn, posv, is_global, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    live = slice(0, N) if nb == 1 else slice(1, N)
    for i in (0, 1):
        assert torch.equal(pages["kernel"][i][live], pages["plain"][i][live])
        assert torch.equal(pages["kernel"][i], pages["again"][i])


@pytest.mark.parametrize(
    "E,C,d,f",
    [
        (4, 5, 40, 33),  # ragged C, d and f tiles (simt in bf16 too: f % 8)
        (8, 24, 256, 200),  # ragged f tile
        (3, 100, 96, 130),  # C > 64: two row passes
        (64, 8, 2048, 1408),  # main path: decode wi_gate / wi_up
        (64, 64, 1408, 2048),  # main path: prefill wo
        (1, 8, 16, 64),  # one wgmma atom: m64n8k16
        (2, 1, 1400, 136),  # C = 1; d not a multiple of the 64-deep stage
        (8, 16, 2048, 1408),  # fused chunk + decode capacity
        (2, 65, 96, 1400),  # C = 65 (N = 80), d = 96, ragged f
        (2, 256, 128, 200),  # two passes of 128 rows
        (2, 300, 1400, 64),  # three passes, the last ragged; one 64-column f tile
        (128, 8, 2048, 768),  # Qwen3-30B-A3B decode wi
        (128, 8, 768, 2048),  # Qwen3-30B-A3B decode wo
        (8, 2, 4096, 14336),  # Mixtral-8x7B decode wi: 8 experts, C=2
        (8, 160, 14336, 4096),  # Mixtral-8x7B prefill wo: two row passes
        (60, 8, 2048, 1408),  # Qwen1.5-MoE-A2.7B: 60 experts
        (64, 8, 3584, 2560),  # Qwen2-57B-A14B
        (68, 8, 2048, 1408),  # DeepSeekMoE-16B with 4 replica slots: decode wi over 68 slots
        (34, 16, 1408, 2048),  # an EP2 rank's half of the 68 slots: decode wo
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_kernel(E, C, d, f, dtype):
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels._build import VARIANT_COUNTS

    dev = _card()
    rng = np.random.default_rng(2)
    lhs = _randn(rng, (E, C, d), dtype, dev)
    lhs[:, C - 1] = 0  # the empty-slot sentinel row
    rhs = _randn(rng, (E, d, f), dtype, dev, std=d**-0.5)
    key = ("grouped_matmul", _variant(dtype, d % 8 == 0 and f % 8 == 0))
    v0 = VARIANT_COUNTS[key]
    out = gm.grouped_matmul(lhs, rhs)
    torch.cuda.synchronize()
    assert VARIANT_COUNTS[key] == v0 + 1
    want = gm.grouped_matmul_plain(lhs, rhs)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[:, C - 1]) == 0


def test_tensor_core_kernels_are_deterministic():
    """Two calls on the same inputs give the same bits: each output element
    is summed by one warpgroup in one order (no split-K, no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm

    dev = _card()
    rng = np.random.default_rng(8)
    lhs = _randn(rng, (64, 64, 1408), "bfloat16", dev)
    rhs = _randn(rng, (64, 1408, 2048), "bfloat16", dev, std=1408**-0.5)
    assert torch.equal(gm.grouped_matmul(lhs, rhs), gm.grouped_matmul(lhs, rhs))
    q, k, v = (_randn(rng, (4, 128, 16, 128), "bfloat16", dev).transpose(1, 2) for _ in range(3))
    assert torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))


def test_flash_hd256_two_calls_bit_equal():
    """The hd 256 wgmma instance (two m64n128 halves of P V) gives the same
    bits twice, and the bf16 plain version's result within tolerance."""
    from repro_torch.kernels import flash_attention as fa

    dev = _card()
    q, k, v = (_randn(np.random.default_rng(12), (2, 256, 8, 256), "bfloat16", dev).transpose(1, 2)
               for _ in range(3))
    k, v = k[:, :4], v[:, :4]  # G = 2
    out = fa.flash_attention(q, k, v, softcap=50.0, scale=224.0**-0.5)
    assert torch.equal(out, fa.flash_attention(q, k, v, softcap=50.0, scale=224.0**-0.5))
    want = fa.flash_attention_plain(q, k, v, softcap=50.0, scale=224.0**-0.5)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_backend_resolves_hopper_on_the_card():
    from repro_torch.kernels import ops

    dev = _card()
    assert ops.resolve_backend(None, dev) is ops.KernelBackend.HOPPER
    with pytest.raises(ValueError):
        ops.resolve_backend("hopper", "cpu")


def test_engine_hopper_matches_ref_on_the_card():
    """Reduced DeepSeekMoE-16B in float32: the hopper path's logits agree
    with the ref path's, every kernel launches, and no ref op runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 64))).to(dev)
    runs = {}
    for be in ("hopper", "ref"):
        ops.reset_counts()
        logits, cache = prefill(params, cfg, {"tokens": toks}, 64 + 5, backend=be)
        seq = [logits]
        for step in range(4):
            nxt = runs["hopper"][1][step] if be == "ref" else seq[-1].argmax(-1)
            logits, cache = decode_step(params, cfg, nxt[:, None], cache, backend=be)
            seq.append(logits)
        runs[be] = (seq, [s.argmax(-1) for s in seq])
        if be == "hopper":
            assert all(ops.LAUNCH_COUNTS[k] > 0 for k in ("flash_attention", "paged_attention", "grouped_matmul"))
            assert not any(".ref" in k or k.startswith("prefill.ref") for k in ops.DISPATCH_COUNTS)
    for a, b in zip(runs["hopper"][0], runs["ref"][0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _prefix_inputs(rng, B, C, Hq, Hkv, hd, bs, nb, groups, dtype, dev):
    """A block pool where each row owns nb pages, then each group
    ``(rep, members, n_shared)`` gives its members the representative's
    first n_shared pages. Every row writes past its shared run."""
    N = B * nb + 1  # page 0 is the trash page
    tables = np.arange(1, N, dtype=np.int32).reshape(B, nb)
    reps, nsh = np.arange(B, dtype=np.int32), np.zeros((B,), np.int32)
    pos = np.zeros((B,), np.int32)
    free = nb * bs - C  # the last position a chunk may start at
    for b in range(B):
        pos[b] = free - (7 * b) % (bs + 3)
    for rep, members, n_shared in groups:
        for m in members:
            tables[m, :n_shared] = tables[rep, :n_shared]
            reps[m], nsh[m] = rep, n_shared
        assert pos[[rep, *members]].min() >= n_shared * bs
    q = _randn(rng, (B, C, Hq, hd), dtype, dev)
    kp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    vp = _randn(rng, (N, bs, Hkv, hd), dtype, dev)
    kn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    vn = _randn(rng, (B, C, Hkv, hd), dtype, dev)
    tables, pos, reps, nsh = (torch.from_numpy(a).to(dev) for a in (tables, pos, reps, nsh))
    return q, kp, vp, tables, kn, vn, pos, reps, nsh


# (B, C, Hq, Hkv, hd, bs, nb), groups, window, is_global, softcap
PREFIX_CASES = {
    # main path: 7 rows share 12 pages (192 keys, whole 32-key tiles) with rep 1
    "decode_main": ((8, 1, 16, 16, 128, 16, 20), [(1, range(2, 8), 12)], 0, True, 0.0),
    # a shared run of 40 keys: the tile over keys 32..63 straddles its end
    "straddle": ((4, 1, 4, 2, 64, 8, 10), [(0, (1, 2), 5)], 0, True, 0.0),
    # chunk + GQA: 5 members x 5 tokens x 4 heads = 100 rows, two blocks
    "chunk_gqa_two_blocks": ((5, 5, 8, 2, 32, 16, 6), [(0, range(1, 5), 3)], 0, True, 0.0),
    # 70 decode rows in one group, more than a block's 64
    "large_group": ((70, 1, 2, 2, 32, 4, 8), [(3, [b for b in range(70) if b != 3], 5)], 0, True, 0.0),
    "window_softcap": ((4, 2, 4, 2, 64, 8, 12), [(2, (0, 3), 6)], 24, False, 30.0),
    "identity": ((3, 1, 4, 2, 64, 16, 4), [], 0, True, 0.0),
    # shared runs of 80 and 144 keys end inside a 64-key split (the split
    # variant's split 1 and 2); in rep 2's group row 3 shares only 48 keys
    "run_ends_mid_split": ((7, 1, 16, 16, 128, 16, 12), [(2, (0, 1), 5), (2, (3,), 3), (5, (4, 6), 9)], 0, True,
                           0.0),
    # head dim 256 (Gemma-2-9B's 16/8 heads): the main path's grouping, and
    # a chunk with window and softcap
    "hd256_decode": ((8, 1, 16, 8, 256, 16, 20), [(1, range(2, 8), 12)], 0, True, 0.0),
    "hd256_window_softcap": ((4, 2, 16, 8, 256, 8, 12), [(2, (0, 3), 6)], 24, False, 50.0),
}


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefix_paged_attention_kernel(name, dtype):
    """Against its plain version at the stated tolerance, and bit for bit
    against the paged kernel on the rows' own tables, pages included."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefix_paged_attention as ppa
    from repro_torch.kernels._build import LAUNCH_COUNTS

    from repro_torch.kernels._build import VARIANT_COUNTS

    dev = _card()
    shape, groups, window, is_global, softcap = PREFIX_CASES[name]
    q, kp, vp, tables, kn, vn, pos, reps, nsh = _prefix_inputs(
        np.random.default_rng(4), *shape, groups, dtype, dev
    )
    kw = dict(scale=shape[4] ** -0.5, softcap=softcap, window=window)
    pages = {k: (kp.clone(), vp.clone()) for k in ("kernel", "paged", "plain", "again")}
    n0 = LAUNCH_COUNTS["prefix_paged_attention"]
    key = ("prefix_paged_attention", _decode_variant(dtype, shape[4]))
    v0 = VARIANT_COUNTS[key]
    out, kp_o, _ = ppa.prefix_paged_attention(q, *pages["kernel"], tables, kn, vn, pos, reps, nsh, is_global, **kw)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["prefix_paged_attention"] == n0 + 1 and kp_o is pages["kernel"][0]
    assert VARIANT_COUNTS[key] == v0 + 1
    again, _, _ = ppa.prefix_paged_attention(q, *pages["again"], tables, kn, vn, pos, reps, nsh, is_global, **kw)
    assert torch.equal(out, again)
    own, _, _ = pa.paged_attention(q, *pages["paged"], tables, kn, vn, pos, is_global, **kw)
    want, _, _ = ppa.prefix_paged_attention_plain(q, *pages["plain"], tables, kn, vn, pos, reps, nsh, is_global, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, own)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for i in (0, 1):
        assert torch.equal(pages["kernel"][i][1:], pages["paged"][i][1:])
        assert torch.equal(pages["kernel"][i][1:], pages["plain"][i][1:])


def test_engine_prefix_cache_on_the_card():
    """Reduced DeepSeekMoE-16B in float32 on the hopper backend, the scenario
    of tests/test_prefix_cache.py:326: the prefix cache on gives the tokens of
    the cache off, forks the shared tail twice and decodes through the
    prefix kernel; no ref op runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, Request

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompt = list(range(1, 21)) + [40, 41]
    outs = {}
    for pc in (False, True):
        eng = InferenceEngine(cfg, params, max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9, prefix_cache=pc)
        eng.scheduler.bucket = 16
        for g in (6, 4, 4):
            eng.submit(Request(prompt=prompt, max_new_tokens=g))
        ops.reset_counts()
        outs[pc] = [c.tokens for c in eng.serve_continuous()]
        assert not any(k.split(".")[1].startswith("ref") for k in ops.DISPATCH_COUNTS)
        assert ops.DISPATCH_COUNTS["decode.hopper_prefix" if pc else "decode.hopper"] > 0
        assert (ops.LAUNCH_COUNTS["prefix_paged_attention"] > 0) == pc
        if pc:
            assert eng.stats.cow_copies == 2 and eng.stats.prefix_hit_blocks == 8
            assert eng.stats.prefix_grouped_steps > 0
    assert outs[True] == outs[False]
    assert [len(t) for t in outs[True]] == [6, 4, 4]


# ---------------------------------------------------------------------------
# INT4: the dequant kernel, the card quantizer, resident and async serving
# ---------------------------------------------------------------------------
def _int4_inputs(rng, G, gs, dev):
    packed = torch.from_numpy(rng.integers(0, 256, (G, gs // 2), dtype=np.uint8)).to(dev)
    scales = torch.from_numpy(rng.uniform(1e-3, 0.1, (G, 1)).astype(np.float32)).to(dev)
    zeros = torch.from_numpy(rng.uniform(-1.0, 1.0, (G, 1)).astype(np.float32)).to(dev)
    return packed, scales, zeros


@pytest.mark.parametrize(
    "G,gs",
    [(8, 256), (16, 128), (32, 512), (7, 128), (5, 10), (3, 2), (129, 6), (1441792, 128)],  # last: main path
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_int4_dequant_kernel(G, gs, dtype):
    """Bit-equal to its plain version, on aligned buffers and on a packed
    buffer one byte off alignment (the kernel's byte-by-byte path)."""
    from repro_torch.kernels import int4_dequant as dq
    from repro_torch.kernels._build import LAUNCH_COUNTS

    dev = _card()
    dt = getattr(torch, dtype)
    packed, scales, zeros = _int4_inputs(np.random.default_rng(5), G, gs, dev)
    n0 = LAUNCH_COUNTS["int4_dequant"]
    out = dq.int4_dequant(packed, scales, zeros, out_dtype=dt)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["int4_dequant"] == n0 + 1
    want = dq.int4_dequant_plain(packed, scales, zeros, dt)
    assert out.shape == (G, gs) and out.dtype == dt
    assert torch.equal(out, want)
    buf = torch.empty(packed.numel() + 1, dtype=torch.uint8, device=dev)
    odd = buf[1:].view(G, gs // 2)
    odd.copy_(packed)
    assert torch.equal(dq.int4_dequant(odd, scales, zeros, out_dtype=dt), want)


def test_int4_quantizer_on_the_card_matches_numpy():
    """The torch quantizer on the card gives the numpy quantizer's bytes,
    scales and zeros bit for bit, flat and last-dim grouped, bf16 input."""
    from repro_torch.core import quantization as q

    dev = _card()
    w = _randn(np.random.default_rng(6), (3, 4, 64, 176), "bfloat16", dev, std=0.05)
    w_np = w.float().cpu().numpy()
    for got, want in (
        (q.quantize_int4_torch(w, 128), q.quantize_int4(w_np, "per_group", 128)),
        (q.quantize_int4_lastdim_torch(w, out_device="cpu", pin=True), q.quantize_int4_lastdim(w_np)),
    ):
        assert got.shape == want.shape and got.group_size == want.group_size
        for a in ("packed", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(got, a).cpu().numpy(), getattr(want, a))


def test_grouped_matmul_quantized_on_the_card():
    """A ``QuantizedExpert`` rhs: one dequant launch, then the gmm kernel on
    the dequantized weight, equal to the gmm of that weight."""
    from repro_torch.kernels import ops

    dev = _card()
    rng = np.random.default_rng(7)
    w = _randn(rng, (4, 64, 96), "bfloat16", dev, std=0.1)
    lhs = _randn(rng, (4, 8, 64), "bfloat16", dev)
    qe = ops.quantize_weight(w)
    ops.reset_counts()
    out = ops.grouped_matmul(lhs, qe)
    torch.cuda.synchronize()
    assert dict(ops.LAUNCH_COUNTS) == {"int4_dequant": 1, "grouped_matmul": 1}
    dense = ops._dequant_weight(qe, torch.bfloat16)
    assert torch.equal(out, ops.grouped_matmul(lhs, dense))


def test_async_restore_on_the_side_stream():
    """Reduced DeepSeekMoE-16B in float32 on the card under a pinned switching
    INT4 plan: the restore on the worker's own stream gives the sync tokens,
    resident and dense, and the executor's async restore installs the sync
    restore's values."""
    from repro_torch.configs import get_config
    from repro_torch.core.hap import fixed_plan
    from repro_torch.core.transition import TransitionExecutor
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, Request

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tx = TransitionExecutor(dev)
    tx.backup("w", params["layers"]["moe"]["wi_gate"])
    fut = tx.restore_async("w", torch.float32)
    assert torch.equal(fut.result().install(), tx.restore("w", torch.float32))
    for resident in (False, True):
        toks = {}
        for asy in (False, True):
            plan = fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload")
            eng = InferenceEngine(cfg, params, max_batch=2, hap_plan=plan, use_int4_transition=True,
                                  resident_int4=resident, async_transitions=asy)
            for p in ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10], [11, 12, 13]):
                eng.submit(Request(prompt=p, max_new_tokens=8))
            ops.reset_counts()
            toks[asy] = [c.tokens for c in eng.run()]
            assert eng.stats.async_restores == (2 if asy else 0) and eng.stats.restore_errors == 0
            assert not any(k.split(".")[1].startswith("ref") for k in ops.DISPATCH_COUNTS)
            if resident:
                assert ops.LAUNCH_COUNTS["int4_dequant"] == ops.LAUNCH_COUNTS["grouped_matmul"]
        assert toks[True] == toks[False]


# ---------------------------------------------------------------------------
# captured serving steps (repro_torch.serving.step_cache)
# ---------------------------------------------------------------------------
def _spy_logits(monkeypatch):
    """Record a copy of every logits tensor the engine samples from; of a
    continuous step, the rows whose tokens are used (an empty or drained
    slot reads and writes the shared trash page, which several such rows
    may write in one launch, so its logits are not defined)."""
    from repro_torch.serving import engine as engine_mod

    seen = []
    orig, apply = engine_mod.sample, engine_mod.InferenceEngine._apply_sampled

    def spy(logits, params, generator=None):
        seen.append(logits.clone())
        return orig(logits, params, generator)

    def rows(self, toks, active, step_ms):
        seen[-1] = seen[-1][active]
        return apply(self, toks, active, step_ms)

    monkeypatch.setattr(engine_mod, "sample", spy)
    monkeypatch.setattr(engine_mod.InferenceEngine, "_apply_sampled", rows)
    return seen


def _served_both_ways(make, reqs, continuous):
    """Serve ``reqs`` eagerly and captured on fresh engines from ``make``;
    returns {capture: (tokens, logits, launches, variants, dispatch, engine)}."""
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import Request

    runs = {}
    for capture in (False, True):
        eng = make(capture)
        for p, g in reqs:
            eng.submit(Request(prompt=p, max_new_tokens=g))
        ops.reset_counts()
        with pytest.MonkeyPatch.context() as mp:
            seen = _spy_logits(mp)
            comps = eng.serve_continuous() if continuous else eng.run()
        torch.cuda.synchronize()
        runs[capture] = ([c.tokens for c in comps], list(seen), dict(_build.LAUNCH_COUNTS),
                         dict(_build.VARIANT_COUNTS), dict(ops.DISPATCH_COUNTS), eng)
        eng.close()
    return runs


@pytest.mark.parametrize("mode", ["run", "continuous", "resident"])
def test_captured_steps_equal_eager_on_the_card(mode):
    """Reduced DeepSeekMoE-16B in bf16 on the hopper backend: the captured
    steps give the eager steps' tokens, every sampled logits tensor bit for
    bit (the same kernels on the same buffers; the repo's kernels use no
    atomics), and the same launch, variant and dispatch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    shared = list(range(1, 21))
    if mode == "run":
        reqs = [([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), ([11, 12, 13], 6), (list(range(14, 30)), 6)]

        def make(capture):
            return InferenceEngine(cfg, params, max_batch=2, capture_steps=capture)
    elif mode == "continuous":
        reqs = [([3, 1, 4, 1, 5], 8), (shared + [40, 41], 6), (shared + [40, 41], 4), (shared + [40, 41], 4)]

        def make(capture):
            eng = InferenceEngine(cfg, params, max_batch=3, prefill_chunk=8, kv_block_size=8, prefix_cache=True,
                                  capture_steps=capture)
            eng.scheduler.bucket = 16
            return eng
    else:
        reqs = [([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), (list(range(11, 31)), 6)]

        def make(capture):
            session = HAPSession(cfg, "h100", 1, source=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"),
                                 prompt_bucket=16)
            return session.engine(params, max_batch=2, resident_int4=True, use_int4_transition=True,
                                  capture_steps=capture)
    runs = _served_both_ways(make, reqs, mode == "continuous")
    eager, captured = runs[False], runs[True]
    assert captured[0] == eager[0]
    assert len(captured[1]) == len(eager[1]) > 0
    for a, b in zip(captured[1], eager[1]):
        assert torch.equal(a, b)
    assert captured[2:5] == eager[2:5]
    assert not any(k.split(".")[1].startswith("ref") for k in captured[4])
    st = captured[5].steps.stats
    assert st.captures > 0 and st.replays > 0
    assert eager[5].steps.stats.captures == 0
    if mode == "resident":
        assert captured[2]["int4_dequant"] == captured[2]["grouped_matmul"]


def test_replay_after_a_leaf_install_reads_the_new_leaves():
    """After the engine installs new expert leaves, its steps are captured
    anew and replay the new leaves: the tokens equal an eager engine's on
    the new weights, and differ from the old weights' tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, Request

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    prompts = ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10])

    def serve(eng):
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=8))
        return [c.tokens for c in eng.run()]

    eng = InferenceEngine(cfg, params, max_batch=2)
    old = serve(eng)
    assert eng.steps.stats.captures == 1 and eng.steps.stats.replays > 0  # decode; the prefill ran once
    moe = eng.params["layers"]["moe"]
    new = {n: moe[n] * -1.5 for n in ("wi_gate", "wi_up", "wo")}
    eng._set_expert_leaves(new)
    assert len(eng.steps) == 0
    got = serve(eng)
    assert eng.steps.stats.captures == 2
    want = serve(InferenceEngine(cfg, eng.params, max_batch=2, capture_steps=False))
    assert got == want and got != old


def test_a_failing_capture_raises_on_the_card():
    """A step body that syncs with the host cannot be captured: the capture
    raises and nothing runs the step eagerly in its place."""
    from repro_torch.serving.step_cache import StepCache

    dev = _card()
    steps = StepCache(dev, True)
    g = steps.graph(("decode", None, 1), lambda: steps.buffers(x=((4,), torch.float32)),
                    lambda g: g.bufs["x"] * float(g.bufs["x"].sum().item()), "static")
    g.feed("x", np.ones(4, np.float32))
    steps.run(g, may_capture=False)  # eager: a host sync is allowed there
    with pytest.raises(RuntimeError):
        steps.run(g)
    assert g.graph is None and steps.stats.captures == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "gemma2-9b"])
def test_captured_full_width_family_equals_eager(name):
    """A family at full width, 2 layers, bf16 (Qwen3-30B-A3B: 128 experts
    top-8, GQA 32/4; Gemma-2-9B: hd 256, softcaps, post-norms, a 4,096-token
    window on its local layer): the captured steps give the eager steps'
    tokens, logits bit for bit and counts, through run() and
    serve_continuous() with the prefix cache; every flash and gmm launch is
    wgmma, every paged and prefix launch split."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    dev = _card()
    cfg = dataclasses.replace(get_config(name), num_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(13)
    shared = rng.integers(1, cfg.vocab_size, 48).tolist()
    for continuous in (False, True):
        if continuous:
            reqs = [(shared + rng.integers(1, cfg.vocab_size, 16).tolist(), g) for g in (8, 4, 6, 4)]

            def make(capture):
                return InferenceEngine(cfg, params, max_batch=3, kv_block_size=16, prefix_cache=True,
                                       capture_steps=capture)
        else:
            reqs = [(rng.integers(1, cfg.vocab_size, n).tolist(), 6) for n in (20, 70, 33, 100)]

            def make(capture):
                return InferenceEngine(cfg, params, max_batch=2, capture_steps=capture)
        runs = _served_both_ways(make, reqs, continuous)
        eager, captured = runs[False], runs[True]
        assert captured[0] == eager[0] and [len(t) for t in captured[0]] == [g for _, g in reqs]
        assert len(captured[1]) == len(eager[1]) > 0
        for a, b in zip(captured[1], eager[1]):
            assert torch.equal(a, b)
        assert captured[2:5] == eager[2:5]
        launches, variants = captured[2], captured[3]
        assert launches.get("grouped_matmul", 0) == variants.get(("grouped_matmul", "wgmma"), 0)
        assert (launches.get("grouped_matmul", 0) > 0) == cfg.is_moe
        # static prefills run flash; continuous prompts go through the paged
        # kernel in chunks
        assert launches.get("flash_attention", 0) == variants.get(("flash_attention", "wgmma"), 0)
        assert (launches.get("flash_attention", 0) > 0) == (not continuous)
        for k in ("paged_attention", "prefix_paged_attention"):
            assert launches.get(k, 0) == variants.get((k, "split"), 0)
        if continuous:
            assert launches["prefix_paged_attention"] > 0 and captured[5].stats.prefix_hit_blocks > 0
        assert not any(k.split(".")[1].startswith("ref") for k in captured[4])


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_prefill_equals_decode_on_the_card(dtype):
    """Falcon-Mamba-7B at full width, 4 layers, left-padded prompts: a
    prefill of the prompt and 4 more tokens against the prompt's prefill
    and those tokens decoded one by one. A wrong scan or state hand-off
    gives unrelated logits (rel L2 near 1.4). In float32 the two paths
    differ by rounding alone (the H100 read 1.4e-5 at this depth); in bf16
    by bf16 rounding, which the H100 read at 0.02-0.03 at this depth (as
    much as the same path at another batch size)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    dev = _card()
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), num_layers=4, dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 68))).to(dev)
    toks[0, :20] = 0  # left padding, as the scheduler pads a short prompt
    with torch.inference_mode():
        whole, _ = prefill(params, cfg, {"tokens": toks}, 72)
        logits, cache = prefill(params, cfg, {"tokens": toks[:, :64]}, 72)
        for t in range(64, 68):
            logits, cache = decode_step(params, cfg, toks[:, t : t + 1], cache)
    assert torch.isfinite(logits).all()
    assert _rel_l2(logits, whole) < (1e-3 if dtype == "float32" else 0.1)


def test_ssm_families_captured_contiguous_equals_eager():
    """Hymba-1.5B (hd 64, G=5, window 1024) and Falcon-Mamba-7B at full
    width, 2 layers, bf16: ``run()`` and the contiguous
    ``serve_continuous()`` give the eager tokens, logits bit for bit and
    counts when captured; Hymba's flash launches are wgmma and its paged
    launches split, Falcon-Mamba launches no kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    dev = _card()
    for name in ("hymba-1.5b", "falcon-mamba-7b"):
        cfg = dataclasses.replace(get_config(name), num_layers=2)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        rng = np.random.default_rng(17)
        for continuous in (False, True):
            reqs = [(rng.integers(1, cfg.vocab_size, n).tolist(), g) for n, g in ((20, 6), (70, 4), (33, 8), (100, 5))]
            runs = _served_both_ways(
                lambda capture: InferenceEngine(cfg, params, max_batch=2, capture_steps=capture), reqs, continuous)
            eager, captured = runs[False], runs[True]
            assert captured[0] == eager[0] and [len(t) for t in captured[0]] == [g for _, g in reqs]
            assert len(captured[1]) == len(eager[1]) > 0
            for a, b in zip(captured[1], eager[1]):
                assert torch.equal(a, b)
            assert captured[2:5] == eager[2:5]
            launches, variants = captured[2], captured[3]
            assert not captured[5].paged
            assert launches.get("flash_attention", 0) == variants.get(("flash_attention", "wgmma"), 0)
            assert launches.get("paged_attention", 0) == variants.get(("paged_attention", "split"), 0)
            assert (launches.get("flash_attention", 0) > 0) == cfg.has_attention
            assert not any(v for k, v in launches.items() if k not in ("flash_attention", "paged_attention"))
            assert not any(k.split(".")[1].startswith("ref") for k in captured[4])


# ---------------------------------------------------------------------------
# sharded execution on the card
# ---------------------------------------------------------------------------
class _HalfMesh:
    """Rank ``rank`` of a two-rank model axis for the grouped-matmul seam,
    its all-reduce left to the test (which sums the two ranks' partials)."""

    def __init__(self, rank):
        self.rank, self.size, self.shape = rank, 2, {"model": 2}

    def all_reduce(self, x):
        return x


@pytest.mark.parametrize("f", [704, 352, 96])
def test_sharded_grouped_matmul_on_the_card(f):
    """Each rank's column-parallel (wi) and row-parallel (wo) grouped matmul
    at DeepSeek's TP2 / TP4 widths (and 96 = 3 INT4 groups of 32, which do
    not split in two) against the plain product of the whole weight: dense
    and resident INT4, the dequant on the rank's slice where the group axis
    divides and on the whole leaf where it does not."""
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import LAUNCH_COUNTS
    from repro_torch.sharding.specs import KernelShardAxes

    dev = _card()
    rng = np.random.default_rng(f)
    E, C, d = 8, 16, 256
    gs = 32 if f == 96 else 64
    lhs = _randn(rng, (E, C, d), "bfloat16", dev)
    wi = _randn(rng, (E, d, f), "bfloat16", dev, std=d**-0.5)
    wo = _randn(rng, (E, f, d), "bfloat16", dev, std=f**-0.5)
    qi, qo = ops.quantize_weight(wi, gs), ops.quantize_weight(wo, gs)
    for rhs_i, rhs_o, quantized in ((wi, wo, False), (qi, qo, True)):
        want_h = gm.grouped_matmul_plain(lhs, ops._dequant_weight(rhs_i, lhs.dtype, "hopper"))
        want_o = gm.grouped_matmul_plain(want_h, ops._dequant_weight(rhs_o, lhs.dtype, "hopper"))
        half, parts = f // 2, []
        for r in (0, 1):
            ax = KernelShardAxes(_HalfMesh(r), "model", f)
            cols = slice(r * half, (r + 1) * half)
            if quantized:
                fused = qi.packed.shape[-2] % 2 == 0
                g = qi.packed.shape[-2] // 2
                loc_i = ops.QuantizedExpert(*(t[..., r * g:(r + 1) * g, :] for t in (qi.packed, qi.scales, qi.zeros))) \
                    if fused else qi
                loc_o = qo[:, cols]
            else:
                loc_i, loc_o = wi[..., cols].contiguous(), wo[:, cols].contiguous()
            LAUNCH_COUNTS.clear()
            h = ops.grouped_matmul(lhs, loc_i, shard_axes=ax, sharded_dim="out")
            torch.testing.assert_close(h.float(), want_h[..., cols].float(), atol=2e-2, rtol=2e-2)
            parts.append(ops.grouped_matmul(want_h[..., cols].contiguous(), loc_o, shard_axes=ax, sharded_dim="in"))
            assert LAUNCH_COUNTS["grouped_matmul"] == 2
            assert LAUNCH_COUNTS.get("int4_dequant", 0) == (2 if quantized else 0)
        torch.testing.assert_close((parts[0].float() + parts[1].float()), want_o.float(), atol=5e-2, rtol=2e-2)


def _one_rank_group(tmp_path, backend):
    import torch.distributed as dist

    from repro_torch.sharding import RankMesh

    dist.init_process_group(backend, store=dist.FileStore(str(tmp_path / f"store_{backend}"), 1), rank=0,
                            world_size=1)
    return RankMesh()


def test_one_rank_nccl_sharded_engine_captured_equals_eager(tmp_path):
    """A one-rank NCCL group, reduced DeepSeekMoE-16B in bf16 under
    fixed_plan("TP2", "EP2") with the serial and the pipelined EP schedule:
    the steps (their all-reduce, all-gather and all-to-all included) are
    captured in CUDA graphs and give the eager steps' tokens, logits and
    launch counts, and the plain one-card engine's tokens."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine

    dev = _card()
    mesh = _one_rank_group(tmp_path, "nccl")
    try:
        cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
        plan = fixed_plan("TP2", "EP2")
        splan = plan.to_sharding_plan(mesh, cfg, phase="prefill")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, shard=(splan, 0))
        reqs = [([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), (list(range(11, 31)), 6)]
        plain = _served_both_ways(lambda cap: InferenceEngine(cfg, params, max_batch=2, capture_steps=cap), reqs,
                                  False)[True][0]
        for k in (1, 2):
            runs = _served_both_ways(lambda cap: HAPSession(cfg, "h100", 1, source=plan, mesh=mesh, prompt_bucket=64)
                                     .engine(params, max_batch=2, capture_steps=cap, moe_pipeline=k), reqs, False)
            eager, captured = runs[False], runs[True]
            assert captured[0] == eager[0] == plain
            for a, b in zip(captured[1], eager[1]):
                assert torch.equal(a, b)
            assert captured[2:5] == eager[2:5]
            assert captured[5].steps.stats.captures > 0 and captured[5].steps.stats.replays > 0
            assert captured[4].get("moe.ep_serial" if k == 1 else "moe.ep_pipeline_k2")
    finally:
        dist.destroy_process_group()


def test_capture_on_a_gloo_group_raises(tmp_path):
    """gloo stages CUDA collectives through the host: a step cannot be
    captured, so capture_steps=True raises and names the reason; None
    serves eagerly."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import init_params

    dev = _card()
    mesh = _one_rank_group(tmp_path, "gloo")
    try:
        cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
        plan = fixed_plan("TP2", "TP2")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                             shard=(plan.to_sharding_plan(mesh, cfg, phase="prefill"), 0))
        session = HAPSession(cfg, "h100", 1, source=plan, mesh=mesh)
        with pytest.raises(ValueError, match="gloo"):
            session.engine(params, capture_steps=True)
        assert not session.engine(params).steps.capture
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# hot-expert replication and predictive prefetch (ROADMAP A.4)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard", [None, "ep1", "tp0"])
def test_staged_row_restore_bit_equal_on_the_card(shard):
    """Rows staged on the executor's worker (its own stream) and the missed
    rows uploaded at the barrier give a restore bit-equal to the plain one,
    dense (one int4_dequant launch over the assembled leaf) and packed,
    whole and a rank's shard."""
    from repro_torch.core.transition import TransitionExecutor
    from repro_torch.kernels import _build

    dev = _card()
    rng = np.random.default_rng(7)
    w = _randn(rng, (3, 8, 256, 384), "bfloat16", dev, std=0.05)
    tx = TransitionExecutor(dev)
    tx.backup("w", w)
    tx.backup_packed("p", w)
    sh = None if shard is None else (((None, "model", None, None) if shard[:2] == "ep" else
                                      (None, None, None, "model")), int(shard[2]), {"model": 2})
    kw = {} if sh is None else {"shard": sh}
    rows = list(range(0, 24, 3))
    staged = tx.submit(lambda: ({r: tx.prefetch_row("w", r) for r in rows},
                                {r: tx.prefetch_row("p", r) for r in rows})).result().value
    assert all(st.packed.is_cuda and st.event is not None for st in staged[0].values())
    plain = tx.restore("w", torch.bfloat16, **kw)
    n0 = _build.LAUNCH_COUNTS["int4_dequant"]
    got = tx.restore_with_rows("w", staged[0], torch.bfloat16, **kw)
    assert _build.LAUNCH_COUNTS["int4_dequant"] == n0 + 1
    assert torch.equal(got, plain)
    packed, want = tx.restore_packed_with_rows("p", staged[1], **kw), tx.restore_packed("p", **kw)
    for a in ("packed", "scales", "zeros"):
        assert torch.equal(getattr(packed, a), getattr(want, a))
    tx.close()


def test_prefetch_pull_while_a_step_is_captured():
    """A prefetch pull that allocates and uploads on the worker thread's
    stream while the engine thread captures a step (``thread_local``
    capture, ``step_cache.CudaGraph``) is legal: the capture completes,
    its replay computes the step, and the staged rows hold the backup's
    bytes."""
    import threading

    from repro_torch.configs import get_config
    from repro_torch.core import fixed_plan
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving.step_cache import CudaGraph

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = InferenceEngine(cfg, params, max_batch=2, use_int4_transition=True, prefetch=True,
                          hap_plan=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"))
    capturing, pulled = threading.Event(), threading.Event()
    orig = eng._tx.prefetch_rows

    def in_capture(name, rows):
        assert capturing.wait(30)  # the engine thread is inside its capture
        return orig(name, rows)

    eng._tx.prefetch_rows = in_capture
    rows = tuple(range(cfg.num_layers * cfg.n_routed_experts))
    eng._prefetch_live.update(rows)
    fut = eng._tx.submit(lambda: (eng._prefetch_pull(rows), pulled.set()))
    x = torch.randn(64, 64, device=dev)
    x @ x  # the eager first run that precedes every capture (cuBLAS's state)
    torch.cuda.synchronize()

    def body():
        y = x @ x  # a step's allocation and launch on the capture stream
        capturing.set()
        assert pulled.wait(30)  # every row uploaded while the capture is open
        return torch.relu(y) + 1

    graph = CudaGraph()
    out = graph.capture(body)
    fut.result(timeout=30)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.relu(x @ x) + 1)
    assert set(eng._prefetch_stage) == set(rows) and eng.stats.prefetch_errors == 0
    qt = eng._tx._backups["moe/wi_gate"]
    gpr = qt.packed.shape[0] // len(rows)
    for r in (0, len(rows) - 1):
        assert torch.equal(eng._prefetch_stage[r]["wi_gate"].packed.cpu(), qt.packed[r * gpr:(r + 1) * gpr])
    eng.close()


def test_replicated_engine_on_the_card():
    """Reduced DeepSeekMoE-16B in bf16 with the doctored router of
    ``tests/test_replication.py``: a replicated engine rebalances, lays the
    expert leaves out in its slots (the grouped matmul launched at the slot
    count), and gives the unreplicated engine's tokens, eager and captured;
    the captured step's router top-k reaches the tracker."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceEngine, Request

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    L, d, E = params["layers"]["moe"]["router"].shape
    v = torch.randn(d, generator=torch.Generator().manual_seed(3))
    router = (-v)[None, :, None].expand(L, d, E).clone()
    router[:, :, 1] = v
    params["layers"]["moe"]["router"] = router.to(dev, params["layers"]["moe"]["router"].dtype)
    prompts = ([1, 2, 3, 4], [9, 8, 7], list(range(10, 30)))

    def serve(**kw):
        eng = InferenceEngine(cfg, params, max_batch=2, **kw)
        for p in prompts:
            eng.submit(Request(p, max_new_tokens=10))
        ops.reset_counts()
        toks = [c.tokens for c in eng.run()]
        eng.close()
        return eng, toks

    _, base = serve()
    seen = {}
    orig = ops._gmm_hopper

    def spy(lhs, rhs, *a, **k):
        seen[lhs.shape[0]] = seen.get(lhs.shape[0], 0) + 1
        return orig(lhs, rhs, *a, **k)

    for capture in (False, True):
        ops._gmm_hopper = spy
        try:
            eng, toks = serve(replicate_experts=2, rebalance_interval=4, capture_steps=capture)
        finally:
            ops._gmm_hopper = orig
        assert toks == base
        rep = eng._replication
        assert eng.stats.replication_rebalances >= 1 and rep.total_slots == E + 2
        assert rep.degrees[0] == max(rep.degrees) and eng.stats.routing_steps > 0
        assert eng.params["layers"]["moe"]["wi_gate"].shape[1] == rep.total_slots
        assert seen.get(rep.total_slots, 0) > 0
        assert (eng.steps.stats.captures > 0) == capture


def _robust_reqs():
    rng = np.random.default_rng(4)
    return [(rng.integers(1, 512, int(rng.integers(5, 30))).tolist(), int(rng.integers(4, 13))) for _ in range(8)]


def _serve_robust(cfg, params, reqs, cancel=None, **kw):
    """The continuous engine on ``reqs``; ``cancel=(uid, steps)`` cancels
    ``uid`` after that many steps. Returns (completions by uid, the
    preempted uids' stash lengths, the engine, its allocators)."""
    from repro_torch.serving import InferenceEngine, Request

    eng = InferenceEngine(cfg, params, max_batch=4, kv_block_size=8, prefill_chunk=16, **kw)
    eng.scheduler.bucket = 16
    stash, allocators = {}, []
    preempt, begin, step = eng._preempt, eng._begin_live_batch, eng.step

    def spy_preempt(j):
        r = eng._live.slots[j].req
        preempt(j)
        stash.setdefault(r.uid, []).append(len(r.stashed))

    def spy_begin():
        begin()
        allocators.append(eng._live.allocator)

    steps = [0]

    def spy_step(*a):
        steps[0] += 1
        if cancel is not None and steps[0] == cancel[1]:
            assert eng.cancel(cancel[0])
        return step(*a)

    eng._preempt, eng._begin_live_batch, eng.step = spy_preempt, spy_begin, spy_step
    for p, g in reqs:
        eng.submit(Request(prompt=p, max_new_tokens=g))
    comps = {c.uid: c for c in eng.serve_continuous()}
    eng.close()
    return comps, stash, eng, allocators


def test_overcommit_preemption_on_the_card():
    """Reduced DeepSeekMoE-16B in bf16 on the hopper backend, captured
    steps: an overcommitted pool preempts rows; every request never
    preempted gives the worst-case pool's tokens exactly, a preempted one's
    stash is that run's prefix, and every allocator ends with all blocks
    free and no reservation."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = _robust_reqs()
    want, _, base, _ = _serve_robust(cfg, params, reqs, kv_blocks=8)
    got, stash, eng, allocators = _serve_robust(cfg, params, reqs, kv_blocks=8, kv_overcommit=0.25)
    assert base.stats.preemptions == 0 and eng.stats.preemptions >= 1 and stash
    assert all(got[u].status == "ok" and len(got[u].tokens) == g for u, (_, g) in enumerate(reqs))
    for uid in got:
        if uid not in stash:
            assert got[uid].tokens == want[uid].tokens, uid
        else:
            assert got[uid].preemptions == len(stash[uid])
            n = stash[uid][-1]
            assert got[uid].tokens[:n] == want[uid].tokens[:n], uid
    for a in allocators:
        assert a.num_reserved == 0 and a.num_free == a.num_blocks - 1
    assert eng.steps.stats.captures > 0


def test_live_cancel_returns_partial_output_on_the_card():
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = _robust_reqs()
    want, _, _, _ = _serve_robust(cfg, params, reqs)
    got, _, eng, allocators = _serve_robust(cfg, params, reqs, cancel=(0, 4))
    assert got[0].status == "cancelled" and 0 < len(got[0].tokens) < len(want[0].tokens)
    assert got[0].tokens == want[0].tokens[:len(got[0].tokens)]
    assert all(got[u].tokens == want[u].tokens and got[u].status == "ok" for u in got if u != 0)
    assert eng.stats.cancelled == 1
    assert all(a.num_reserved == 0 and a.num_free == a.num_blocks - 1 for a in allocators)


def test_restore_failover_on_the_card():
    """The resident session's first background restore fails: the barrier
    relayouts in sync and the tokens are the run's with no fault."""
    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import init_params
    from repro_torch.serving import FaultInjector, Request

    dev = _card()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), capacity_factor=8.0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def serve(fi):
        session = HAPSession(cfg, "h100", 1, source=fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload"),
                             prompt_bucket=16)
        eng = session.engine(params, max_batch=2, resident_int4=True, use_int4_transition=True, faults=fi)
        if fi is not None:
            fi.fail("restore", at=fi.calls["restore"])  # the first restore after the resident upload
        for p in ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10]):
            eng.submit(Request(prompt=p, max_new_tokens=8))
        toks = [c.tokens for c in eng.run()]
        eng.close()
        return toks, eng

    want, base = serve(None)
    fi = FaultInjector()
    got, eng = serve(fi)
    assert got == want and fi.fired_at("restore") == 1
    assert eng.stats.restore_errors == eng.stats.background_errors == 1 and base.stats.restore_errors == 0
    assert eng.stats.async_restores == base.stats.async_restores >= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_llava_decode(dtype):
    """LLaVA-NeXT-Mistral-7B's decode step after an image prompt: B=2 rows
    at positions 2944 and 2951 of a contiguous (2, 2961) cache through the
    identity table, Hq 32 / Hkv 8, hd 128."""
    from repro_torch.kernels import paged_attention as pa

    dev = _card()
    rng = np.random.default_rng(2)
    B, Hq, Hkv, hd, Smax = 2, 32, 8, 128, 2961
    q = _randn(rng, (B, 1, Hq, hd), dtype, dev)
    kc, vc = (_randn(rng, (B, Smax, Hkv, hd), dtype, dev) for _ in range(2))
    kn, vn = (_randn(rng, (B, 1, Hkv, hd), dtype, dev) for _ in range(2))
    tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    pos = torch.tensor([2944, 2951], dtype=torch.int32, device=dev)
    kc2, vc2 = kc.clone(), vc.clone()
    out, _, _ = pa.paged_attention(q, kc, vc, tables, kn, vn, pos, True, scale=hd**-0.5)
    want, kw, vw = pa.paged_attention_plain(q, kc2, vc2, tables, kn, vn, pos, True, scale=hd**-0.5)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(kc, kw) and torch.equal(vc, vw)


@pytest.mark.parametrize("name", ["hubert-xlarge", "deepseek-moe-16b", "llava-next-mistral-7b"])
def test_train_step_on_the_card_equals_the_cpu(name):
    """A reduced float32 ``make_train_step`` step on the card against the
    same step on the CPU from the same weights and batch: loss, gradient
    norm and updated parameters at 1e-4 (TF32 off), and the step launches
    no hand kernel: training pins the plain PyTorch path, whose
    dispatches it counts."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_data
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainState, make_train_step
    from repro_torch.training.tree import tree_leaves, tree_map

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    batch = next(synthetic_lm_data(cfg, 2, 64, seed=3))
    step = make_train_step(cfg, base_lr=1e-3, warmup=1, total_steps=10)
    out = {}
    for where in ("cpu", dev):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.to(where, copy=True), params)
        state = TrainState(params, adamw_init(params))
        ops.reset_counts()
        state, m = step(state, batch)
        out[str(where)] = (state, m, dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS))
    (cs, cm, _, _), (gs, gm, launches, dispatch) = out["cpu"], out[str(dev)]
    assert sum(launches.values()) == 0, launches
    assert dispatch.get("prefill.ref", 0) > 0 and not any(k.endswith("hopper") for k in dispatch), dispatch
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(gm[k].cpu(), cm[k], atol=1e-4, rtol=1e-4)
    for a, b in zip(tree_leaves(gs.params), tree_leaves(cs.params)):
        assert _rel_l2(a.detach().cpu(), b.detach()) < 1e-4


# ---------------------------------------------------------------------------
# the serve launcher and the sequence-sharded decode cache (ROADMAP A.9)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_seq_decode_on_the_card_equals_a_whole_cache(dtype, per_row):
    """Two ranks' shares of a contiguous cache (``seq``), each writing the
    entries it holds and returning its partial softmax, merged as
    ``ops.seq_decode_attention`` merges them, against the paged kernel on
    the whole cache: the same output and the same cache, with a window on
    the layer and a softcap."""
    from repro_torch.kernels import ops, ref

    dev = _card()
    rng = np.random.default_rng(7)
    B, Hq, Hkv, hd, S, n = 3, 8, 2, 64, 96, 2
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, 1, Hq, hd), dtype, dev)
    k_new, v_new = (_randn(rng, (B, 1, Hkv, hd), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (B, S, Hkv, hd), dtype, dev) for _ in range(2))
    pos = torch.tensor([5, 47, 80] if per_row else 60, dtype=torch.int32, device=dev)
    kw = dict(scale=hd**-0.5, softcap=30.0, window=32, is_global=False)
    want, wk, wv = ops.decode_attention(q, k.clone(), v.clone(), k_new, v_new, pos, backend="hopper", **kw)
    P = S // n
    parts, ks = [], []
    for r in range(n):
        kr, vr = k[:, r * P:(r + 1) * P].clone(), v[:, r * P:(r + 1) * P].clone()
        parts.append(ref.seq_append_attention_partial_ref(q, kr, vr, k_new, v_new, pos, r, n, kw["is_global"],
                                                          scale=kw["scale"], softcap=30.0, window=32))
        ks.append(kr)
    o, m, s = (torch.stack(t) for t in zip(*parts))
    got = ref.merge_partials_ref(o, m, s).to(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dt), rtol=_tol(dt))
    assert torch.equal(torch.cat(ks, dim=1), wk)


def test_serve_launcher_on_the_card():
    """``repro_torch.launch.serve`` at the reduced config (float32) on the
    card with the hopper kernels: every prefill through flash, every decode
    through the paged kernel, every expert matmul through gmm, no plain
    path; the tokens of an engine built from the same session and flags."""
    from repro_torch.core import hardware, latency
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import Request

    _card()
    latency._MODEL_CACHE.setdefault(("h100", 0), latency.LatencyModel(hardware.get_chip("h100"), n_samples=40))
    flags = ["--chip", "h100", "--requests", "4", "--batch", "2", "--gen", "6", "--prompt-bucket", "16",
             "--prompt-len", "40", "--kernel-backend", "hopper"]
    ops.reset_counts()
    done, eng = serve.main(flags)
    launches, dispatch = dict(ops.LAUNCH_COUNTS), dict(ops.DISPATCH_COUNTS)
    assert all(launches.get(k) for k in ("flash_attention", "paged_attention", "grouped_matmul")), launches
    assert not [k for k in dispatch if ".ref" in k], dispatch
    again = eng.session.engine(eng.params, cfg=eng.cfg, max_batch=2, kernel_backend="hopper")
    rng = np.random.default_rng(0)
    for i in range(4):
        hi = 40 if i >= 2 else 16
        lo = max(1, (hi - 1) // 16 * 16 + 1)
        again.submit(Request(prompt=rng.integers(1, eng.cfg.vocab_size, int(rng.integers(lo, hi + 1))).tolist(),
                             max_new_tokens=6))
    assert [c.tokens for c in again.run()] == [c.tokens for c in done]
    eng.close()
    again.close()


# ---------------------------------------------------------------------------
# training on a mesh (ROADMAP A.9's training half)
# ---------------------------------------------------------------------------
def _gpu_train_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)


def gloo_train_rank(mesh, steps: int, batch: int, seq: int):
    """One rank of ``test_train_step_on_two_gloo_ranks_equals_one_rank``:
    TP-heads attention and TP experts on the card, its shard of the seeded
    state; returns the history and the gathered parameters (rank 0)."""
    from repro_torch.data import synthetic_lm_data
    from repro_torch.models.params import SPLIT_LEAVES, gather_leaf, leaf_specs
    from repro_torch.sharding.specs import make_plan
    from repro_torch.training.train_loop import init_train_state, train_loop
    from repro_torch.training.tree import tree_items

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _gpu_train_config()
    plan = make_plan(mesh, cfg, expert_mode="tp")
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", plan=plan)
    hist = []
    state = train_loop(cfg, synthetic_lm_data(cfg, batch, seq, plan=plan), steps, plan=plan, state=state,
                       log_every=0, history=hist)
    specs = leaf_specs(cfg, plan)
    params = {n: gather_leaf(t.detach(), specs[n], mesh, SPLIT_LEAVES.get(n.rsplit("/", 1)[-1], 1)).cpu()
              for n, t in tree_items(state.params)}
    return {"history": hist, "params": params if mesh.index == 0 else None}


def test_train_step_on_two_gloo_ranks_equals_one_rank(tmp_path):
    """Reduced DeepSeekMoE-16B in float32, two train steps: two gloo ranks
    sharing the card (TP2 heads, TP2 experts, each rank its shard) give one
    rank's losses (1e-5), grad norms (1e-4) and parameters (rel L2 1e-4)."""
    import os

    from repro_torch.data import synthetic_lm_data
    from repro_torch.sharding.launch import spawn
    from repro_torch.training.train_loop import train_loop
    from repro_torch.training.tree import tree_items

    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _gpu_train_config()
    steps, batch, seq = 2, 2, 32
    hist = []
    state = train_loop(cfg, synthetic_lm_data(cfg, batch, seq), steps, log_every=0, device=dev, history=hist)
    ranks = spawn("test_torch_gpu:gloo_train_rank", 2, backend="gloo", args={"steps": steps, "batch": batch,
                                                                          "seq": seq},
                  workdir=str(tmp_path), timeout=600, pythonpath=(os.path.dirname(os.path.abspath(__file__)),))
    for r in ranks:
        for got, want in zip(r["history"], hist):
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    for name, t in tree_items(state.params):
        got, want = ranks[0]["params"][name].double(), t.detach().cpu().double()
        assert float((got - want).norm() / want.norm()) < 1e-4, name
