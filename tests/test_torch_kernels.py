"""The port's reference ops and kernel wrappers against the JAX package.

Every ``repro_torch.kernels.ref`` op is held against ``repro.kernels.ref``
and against the Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it), in float32 at 2e-5, on the same inputs
made from a seed with numpy. The kernel wrappers' CPU path (their plain
version) and host-side validation, and the backend resolution of the seam,
are checked here too; the CUDA kernels themselves run in
``tests/test_torch_gpu.py`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.grouped_matmul import grouped_matmul as pallas_gmm  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels._build import LAUNCH_COUNTS  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "B,Hq,Hkv,Sq,Sk,hd,causal,window,softcap",
    [
        (2, 4, 2, 32, 32, 16, True, 0, 0.0),  # GQA, G = 2
        (1, 4, 2, 16, 32, 16, True, 8, 0.0),  # Sq < Sk, sliding window
        (1, 2, 1, 32, 32, 16, True, 0, 30.0),  # softcap, MQA
        (1, 2, 2, 16, 16, 8, False, 0, 0.0),  # bidirectional
    ],
)
def test_flash_attention_ref_matches_jax(B, Hq, Hkv, Sq, Sk, hd, causal, window, softcap):
    q, k, v = _rand(0, B, Hq, Sq, hd), _rand(1, B, Hkv, Sk, hd), _rand(2, B, Hkv, Sk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), **kw)
    _close(got, jref.flash_attention_ref(q, k, v, **kw))
    _close(got, pallas_flash(q, k, v, bq=16, bk=16, interpret=True, **kw))
    # the kernel wrapper's CPU path is the plain version, and launches nothing
    n0 = sum(LAUNCH_COUNTS.values())
    _close(fa.flash_attention(_t(q), _t(k), _t(v), **kw), got)
    assert sum(LAUNCH_COUNTS.values()) == n0


def test_flash_seam_model_layout_matches_jax():
    """``ops.flash_attention`` in model layout, global and windowed layers."""
    from repro.kernels import ops as jops

    q, k, v = _rand(3, 2, 24, 4, 16), _rand(4, 2, 24, 2, 16), _rand(5, 2, 24, 2, 16)
    for is_global in (True, False):
        kw = dict(is_global=is_global, window=6, softcap=20.0, scale=0.3)
        got = ops.flash_attention(_t(q), _t(k), _t(v), backend="ref", **kw)
        _close(got, jops.flash_attention(q, k, v, backend="ref", **kw))
        _close(got, jops.flash_attention(q, k, v, backend="pallas", **kw))


def test_attention_seam_matches_jax():
    from repro.kernels import ops as jops

    q, k, v = _rand(6, 1, 2, 32, 16), _rand(7, 1, 2, 32, 16), _rand(8, 1, 2, 32, 16)
    _close(ops.attention(_t(q), _t(k), _t(v)), jops.attention(q, k, v, backend="pallas"))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------
def _paged_case(seed, B, C, Hq, Hkv, hd, bs, N):
    return (
        _rand(seed, B, C, Hq, hd),
        _rand(seed + 1, N, bs, Hkv, hd),
        _rand(seed + 2, N, bs, Hkv, hd),
        _rand(seed + 3, B, C, Hkv, hd),
        _rand(seed + 4, B, C, Hkv, hd),
    )


PAGED_CASES = {
    # name: (B, C, Hq, Hkv, hd, bs, tables, pos, is_global, window, softcap)
    "identity_table": (2, 1, 4, 2, 16, 21, [[0], [1]], [10, 17], True, 0, 0.0),
    "pool_with_trash_entries": (
        3, 3, 4, 2, 16, 4, [[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], [5, 2, 13], True, 0, 0.0,
    ),
    "chunk_window_local_layer": (
        3, 3, 4, 2, 16, 4, [[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], [9, 1, 12], False, 4, 0.0,
    ),
    "softcap": (2, 2, 2, 2, 8, 8, [[1, 2], [3, 4]], [3, 9], True, 0, 25.0),
    "past_table_width": (2, 3, 4, 2, 16, 4, [[1, 2], [3, 4]], [6, 2], True, 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_attention_ref_matches_jax(name):
    B, C, Hq, Hkv, hd, bs, tables, pos, is_global, window, softcap = PAGED_CASES[name]
    N = max(max(r) for r in tables) + 1
    q, kp, vp, kn, vn = _paged_case(10, B, C, Hq, Hkv, hd, bs, N)
    tables = np.asarray(tables, np.int32)
    pos = np.asarray(pos, np.int32)
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    j_in = [jnp.asarray(a) for a in (q, kp, vp, tables, kn, vn, pos)]
    j_out, j_k, j_v = jref.paged_attention_ref(*j_in, is_global, **kw)
    k_t, v_t = _t(kp), _t(vp)
    out, k_o, v_o = ref.paged_attention_ref(q=_t(q), k_pages=k_t, v_pages=v_t, block_tables=_t(tables),
                                            k_new=_t(kn), v_new=_t(vn), pos=_t(pos), is_global=is_global, **kw)
    assert k_o is k_t and v_o is v_t  # updated in place
    _close(out, j_out)
    # every page but the trash page agrees exactly (trash takes racing writes)
    np.testing.assert_array_equal(k_o.numpy()[1:], np.asarray(j_k)[1:])
    np.testing.assert_array_equal(v_o.numpy()[1:], np.asarray(j_v)[1:])
    # the Pallas kernel drops writes past the table width where ref routes
    # them to the trash page; the kernel wrapper's plain version does as the
    # kernel does, so it matches the Pallas kernel on every page
    p_out, p_k, p_v = pallas_paged(*j_in, is_global, interpret=True, **kw)
    _close(out, p_out)
    c_out, c_k, c_v = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(kn), _t(vn), _t(pos), is_global, **kw)
    _close(c_out, p_out)
    np.testing.assert_array_equal(c_k.numpy(), np.asarray(p_k))
    np.testing.assert_array_equal(c_v.numpy(), np.asarray(p_v))


@pytest.mark.parametrize("per_row", [False, True])
def test_append_attention_ref_matches_jax(per_row):
    B, Smax, Hq, Hkv, hd = 2, 24, 4, 2, 16
    C = 1 if per_row else 3
    q, kc, vc, kn, vn = _paged_case(20, B, C, Hq, Hkv, hd, Smax, B)
    pos = np.asarray([7, 15], np.int32) if per_row else np.asarray(9, np.int32)
    kw = dict(scale=hd**-0.5, softcap=10.0, window=5)
    j_in = [jnp.asarray(a) for a in (q, kc, vc, kn, vn, pos)]
    j_out, j_k, j_v = jref.append_attention_ref(*j_in, False, **kw)
    out, k_o, v_o = ref.append_attention_ref(_t(q), _t(kc), _t(vc), _t(kn), _t(vn), _t(pos), False, **kw)
    _close(out, j_out)
    np.testing.assert_array_equal(k_o.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(v_o.numpy(), np.asarray(j_v))


@pytest.mark.parametrize("layout", ["contiguous_lockstep", "contiguous_rows", "paged"])
def test_decode_seam_matches_jax(layout):
    """``ops.decode_attention`` on both cache layouts against the JAX seam
    on its ``ref`` and ``pallas`` backends (live outputs and caches)."""
    from repro.kernels import ops as jops

    B, Hq, Hkv, hd = 2, 4, 2, 16
    if layout == "paged":
        C, bs, N, tables, pos = 3, 4, 7, np.asarray([[1, 2, 3], [4, 5, 6]], np.int32), np.asarray([5, 1], np.int32)
    else:
        C, bs, N, tables = (2 if layout == "contiguous_lockstep" else 1), 20, B, None
        pos = np.asarray(11, np.int32) if layout == "contiguous_lockstep" else np.asarray([3, 14], np.int32)
    q, kc, vc, kn, vn = _paged_case(50, B, C, Hq, Hkv, hd, bs, N)
    kw = dict(scale=0.25, softcap=15.0, window=6, is_global=False)
    t_tables = None if tables is None else _t(tables)
    out, k_o, v_o = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(kn), _t(vn), _t(pos), block_tables=t_tables, **kw)
    j_tables = None if tables is None else jnp.asarray(tables)
    for be in ("ref", "pallas"):
        j_out, j_k, j_v = jops.decode_attention(
            *(jnp.asarray(a) for a in (q, kc, vc, kn, vn, pos)), block_tables=j_tables, backend=be, **kw
        )
        _close(out, j_out)
        live = slice(1, None) if layout == "paged" else slice(None)
        np.testing.assert_array_equal(k_o.numpy()[live], np.asarray(j_k)[live])
        np.testing.assert_array_equal(v_o.numpy()[live], np.asarray(j_v)[live])


@pytest.mark.parametrize("per_row", [False, True])
def test_identity_table_paged_equals_append(per_row):
    """What the hopper path relies on: a contiguous cache sent through the
    paged op behind the identity table gives the append op's live outputs
    and caches."""
    B, Smax, Hq, Hkv, hd = 3, 19, 4, 2, 8
    C = 1 if per_row else 2
    q, kc, vc, kn, vn = (_t(a) for a in _paged_case(30, B, C, Hq, Hkv, hd, Smax, B))
    pos = torch.tensor([4, 11, 17], dtype=torch.int32) if per_row else torch.tensor(12, dtype=torch.int32)
    ident = torch.arange(B, dtype=torch.int32)[:, None]
    posv = torch.broadcast_to(pos.reshape(-1), (B,)).contiguous()
    a_out, a_k, a_v = ref.append_attention_ref(q, kc.clone(), vc.clone(), kn, vn, pos)
    p_out, p_k, p_v = ref.paged_attention_ref(q, kc.clone(), vc.clone(), ident, kn, vn, posv)
    _close(p_out, a_out)
    assert torch.equal(p_k, a_k) and torch.equal(p_v, a_v)


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,f", [(4, 5, 32, 24), (2, 13, 64, 40), (3, 8, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_ref_matches_jax(E, C, d, f, dtype):
    lhs, rhs = _rand(40, E, C, d), _rand(41, E, d, f) * d**-0.5
    lhs[:, -1] = 0  # an empty capacity slot: the zero sentinel row
    j_l, j_r = jnp.asarray(lhs, dtype), jnp.asarray(rhs, dtype)
    t_l, t_r = _t(lhs).to(getattr(torch, dtype)), _t(rhs).to(getattr(torch, dtype))
    got = ref.grouped_matmul_ref(t_l, t_r)
    assert got.dtype == t_l.dtype
    # bf16: both sides sum in f32 and round once; another summation order
    # may flip that rounding by one bf16 step (2^-8 relative)
    tol = TOL if dtype == "float32" else 8e-3
    _close(got.float(), jref.grouped_matmul_ref(j_l, j_r), tol)
    _close(got.float(), pallas_gmm(j_l, j_r, interpret=True), tol)
    _close(gm.grouped_matmul(t_l, t_r).float(), got.float(), tol)
    assert torch.count_nonzero(got[:, -1]) == 0


# ---------------------------------------------------------------------------
# the seam: backend resolution and host-side validation
# ---------------------------------------------------------------------------
def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(ops.BACKEND_ENV, raising=False)
    assert ops.resolve_backend(None, "cpu") is ops.KernelBackend.REF
    assert ops.resolve_backend("auto", torch.device("cpu")) is ops.KernelBackend.REF
    assert ops.default_backend("cuda") is ops.KernelBackend.HOPPER
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_backend("hopper", "cpu")
    with pytest.raises(ValueError):
        ops.resolve_backend("pallas", "cpu")
    monkeypatch.setenv(ops.BACKEND_ENV, "ref")
    assert ops.resolve_backend(None, "cuda") is ops.KernelBackend.REF  # env read first
    monkeypatch.setenv(ops.BACKEND_ENV, "hopper")
    with pytest.raises(ValueError):
        ops.resolve_backend(None, "cpu")
    assert ops.resolve_backend("ref", "cpu") is ops.KernelBackend.REF  # explicit wins


def test_seam_never_falls_back_on_cpu():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, backend="hopper")
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.zeros(2, 8, 4), torch.zeros(2, 4, 4), backend="hopper")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :1], q, q, q[:, :1], q[:, :1], 3, backend="hopper")


def test_seam_counts_dispatch():
    ops.reset_counts()
    ops.grouped_matmul(torch.zeros(2, 8, 4), torch.zeros(2, 4, 4))
    assert ops.DISPATCH_COUNTS == {"gmm.ref": 1} and not ops.LAUNCH_COUNTS


def test_decode_seam_rejects_per_row_contiguous_chunks():
    q = torch.zeros(2, 3, 2, 8)
    kc = torch.zeros(2, 10, 2, 8)
    with pytest.raises(ValueError, match="lockstep"):
        ops.decode_attention(q, kc, kc, q, q, torch.tensor([1, 2]))


def _gmm_bad_inputs():
    z = torch.zeros
    return [
        (z(2, 8, 4), z(2, 5, 4)),  # d does not chain
        (z(2, 8, 4), z(3, 4, 4)),  # expert counts differ
        (z(2, 8, 4, dtype=torch.int32), z(2, 4, 4, dtype=torch.int32)),  # no integer kernel
        (z(2, 8, 4, dtype=torch.float16), z(2, 4, 4, dtype=torch.float16)),  # f32 / bf16 only
        (z(2, 8, 4), z(2, 4, 4, dtype=torch.bfloat16)),  # mixed dtypes
        (z(2, 8, 4), z(2, 4, 4).transpose(1, 2)),  # not contiguous
        (z(8, 4), z(4, 4)),  # not grouped
    ]


@pytest.mark.parametrize("i", range(7))
def test_grouped_matmul_wrapper_validates(i):
    with pytest.raises(ValueError):
        gm.grouped_matmul(*_gmm_bad_inputs()[i])


def test_flash_wrapper_validates():
    z = torch.zeros
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(z(1, 3, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(z(1, 2, 8, 256), z(1, 2, 8, 256), z(1, 2, 8, 256))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), window=-1)
    with pytest.raises(ValueError, match="stride"):
        x = z(1, 2, 16, 8).transpose(2, 3)
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16, dtype=torch.bfloat16), z(1, 2, 8, 16))


def test_paged_wrapper_validates():
    z = torch.zeros
    q, kp, kn = z(2, 1, 4, 16), z(3, 8, 2, 16), z(2, 1, 2, 16)
    tables, pos = torch.tensor([[1], [2]], dtype=torch.int32), torch.tensor([3, 4], dtype=torch.int32)
    pa.paged_attention(q, kp, kp.clone(), tables, kn, kn, pos)  # well formed
    bad = [
        dict(pos=torch.tensor(3, dtype=torch.int32)),  # scalar pos: the seam broadcasts it
        dict(pos=pos.long()),
        dict(block_tables=tables.long()),
        dict(block_tables=tables[:1]),
        dict(k_new=z(2, 2, 2, 16)),
        dict(q=z(2, 1, 3, 16)),  # 3 q heads over 2 kv heads
        dict(k_pages=z(3, 8, 2, 16).transpose(0, 1).contiguous().transpose(0, 1)),
    ]
    for change in bad:
        args = dict(q=q, k_pages=kp, v_pages=kp.clone(), block_tables=tables, k_new=kn, v_new=kn, pos=pos)
        args.update(change)
        if "k_pages" in change:
            args["v_pages"] = change["k_pages"]
        with pytest.raises(ValueError):
            pa.paged_attention(**args)
