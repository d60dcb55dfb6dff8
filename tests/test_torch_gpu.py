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


@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,hd,window,softcap",
    [
        (2, 4, 2, 37, 37, 32, 0, 0.0),
        (1, 4, 4, 70, 100, 64, 16, 30.0),
        (3, 8, 2, 1, 65, 16, 0, 0.0),
        (4, 16, 16, 128, 128, 128, 0, 0.0),  # main path: DeepSeekMoE-16B prefill
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(B, Hq, Hkv, Sq, Sk, hd, window, softcap, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import LAUNCH_COUNTS

    dev = _card()
    rng = np.random.default_rng(0)
    # model layout (B, S, H, hd) seen through transposed views, as on the path
    q, k, v = (
        _randn(rng, (B, S, H, hd), dtype, dev).transpose(1, 2)
        for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv))
    )
    n0 = LAUNCH_COUNTS["flash_attention"]
    out = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention"] == n0 + 1
    want = fa.flash_attention_plain(q, k, v, window=window, softcap=softcap)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "B,C,Hq,Hkv,hd,bs,nb,window,is_global,softcap",
    [
        (4, 1, 16, 16, 128, 145, 1, 0, True, 0.0),  # main path: identity table, Smax 145
        (3, 5, 4, 2, 32, 16, 4, 6, False, 25.0),  # block pool, chunk, window, softcap
        (2, 40, 4, 2, 64, 8, 12, 0, True, 0.0),  # C*G = 80 rows: two row chunks
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


@pytest.mark.parametrize(
    "E,C,d,f",
    [
        (4, 5, 40, 33),  # ragged C, d and f tiles
        (8, 24, 256, 200),
        (3, 100, 96, 130),  # C > 64: two row passes
        (64, 8, 2048, 1408),  # main path: decode wi_gate / wi_up
        (64, 64, 1408, 2048),  # main path: prefill wo
    ],
)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_matmul_kernel(E, C, d, f, dtype):
    from repro_torch.kernels import grouped_matmul as gm

    dev = _card()
    rng = np.random.default_rng(2)
    lhs = _randn(rng, (E, C, d), dtype, dev)
    lhs[:, C - 1] = 0  # the empty-slot sentinel row
    rhs = _randn(rng, (E, d, f), dtype, dev, std=d**-0.5)
    out = gm.grouped_matmul(lhs, rhs)
    torch.cuda.synchronize()
    want = gm.grouped_matmul_plain(lhs, rhs)
    tol = _tol(out.dtype)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    assert torch.count_nonzero(out[:, C - 1]) == 0


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
