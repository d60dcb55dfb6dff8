"""The port's INT4 quantization, dequant kernel seam and quantized expert
matmul against the JAX package.

The numpy copies and the torch quantizer must give ``repro.core.quantization``'s
packed bytes, scales and zeros bit for bit; the dequant's plain version and
``ref`` op the numpy dequant bit for bit, and the Pallas kernel in interpret
mode within one float32 ulp (atol 1e-6: interpret mode may fuse the multiply
and the add). The grouped matmul with a quantized rhs equals the matmul of
the round-tripped weight. The CUDA kernel itself runs in
``tests/test_torch_gpu.py`` on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.int4_dequant import int4_dequant as pallas_dequant  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quantization as q  # noqa: E402
from repro_torch.kernels import int4_dequant as dq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels._build import LAUNCH_COUNTS  # noqa: E402
from repro_torch.models import init_params, params_from_numpy  # noqa: E402
from repro_torch.models.params import layer_slice  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, std=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _int4_inputs(seed, G, gs):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 256, (G, gs // 2), dtype=np.uint8)
    scales = rng.uniform(0.01, 0.2, (G, 1)).astype(np.float32)
    zeros = rng.uniform(-1.0, 1.0, (G, 1)).astype(np.float32)
    return packed, scales, zeros


def _numpy_dequant(packed, scales, zeros, dtype):
    """The numpy dequant of the reference's restore path, cast like it."""
    host = jq.dequantize_int4(jq.QuantizedTensor(packed, scales, zeros, (packed.shape[0], 2 * packed.shape[1]),
                                                 2 * packed.shape[1]))
    return torch.from_numpy(host).to(dtype)


def _assert_qt_equal(got, want):
    assert tuple(got.shape) == tuple(want.shape) and got.group_size == want.group_size
    for a in ("packed", "scales", "zeros"):
        g = getattr(got, a)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = getattr(want, a)
        assert g.dtype == w.dtype and g.shape == w.shape, a
        np.testing.assert_array_equal(g, w, err_msg=a)


# ---------------------------------------------------------------------------
# quantization: the numpy copies and the torch quantizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["per_tensor", "per_channel", "per_group"])
def test_numpy_copies_equal_reference(scheme):
    w = _rand(0, 8, 256)
    _assert_qt_equal(q.quantize_int4(w, scheme, 64), jq.quantize_int4(w, scheme, 64))
    qt = jq.quantize_int4(w, scheme, 64)
    np.testing.assert_array_equal(q.dequantize_int4(qt), jq.dequantize_int4(qt))
    with pytest.raises(ValueError):
        q.quantize_int4(_rand(0, 3, 5), "per_group", 4)


def test_pick_group_size_and_lastdim_equal_reference():
    for last, pref in ((256, 128), (96, 128), (40, 16), (128, 32), (1408, 128), (2048, 128), (10, 128)):
        assert q.pick_group_size(last, pref) == jq.pick_group_size(last, pref)
    assert q.pick_group_size(40, 16) == 10
    for bad in (7, 9):
        with pytest.raises(ValueError):
            q.pick_group_size(bad)
    w = _rand(1, 2, 3, 8, 40, std=0.1)
    _assert_qt_equal(q.quantize_int4_lastdim(w, 16), jq.quantize_int4_lastdim(w, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_quantizer_bit_equal_to_numpy(dtype, monkeypatch):
    """Flat and last-dim grouped, in slabs smaller than the leaf (so a slab
    boundary falls inside it), float32 and bf16 weights (the reference casts
    a bf16 weight to float32 first, as the torch quantizer does)."""
    monkeypatch.setattr(q, "_SLAB_GROUPS", 7)
    w = torch.from_numpy(_rand(2, 2, 4, 16, 96, std=0.05)).to(getattr(torch, dtype))
    w_np = w.float().numpy()
    _assert_qt_equal(q.quantize_int4_torch(w, 64), jq.quantize_int4(w_np, "per_group", 64))
    _assert_qt_equal(q.quantize_int4_lastdim_torch(w), jq.quantize_int4_lastdim(w_np))
    got = q.quantize_int4_lastdim_torch(w, 32)
    assert got.packed.shape == (2, 4, 16, 3, 16) and got.scales.shape == (2, 4, 16, 3, 1)
    with pytest.raises(ValueError):
        q.quantize_int4_torch(torch.ones(6), 4)
    with pytest.raises(ValueError):
        q.quantize_int4_torch(torch.ones(6), 3)


def test_torch_quantizer_constant_groups():
    """A constant group: scale floors at 1e-8 and every code is 0, as in numpy."""
    w = np.zeros((4, 64), np.float32)
    w[1] = 3.0
    _assert_qt_equal(q.quantize_int4_torch(torch.from_numpy(w), 64), jq.quantize_int4(w, "per_group", 64))


# ---------------------------------------------------------------------------
# the dequant: plain version and ref op vs numpy and Pallas interpret
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "G,gs,bg", [(16, 64, 8), (128, 32, 32), (8, 256, 8), (7, 128, 7), (5, 10, 5)]  # the reference grid + odd G, gs=10
)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int4_dequant_plain_and_ref(G, gs, bg, out_dtype):
    packed, scales, zeros = _int4_inputs(3, G, gs)
    dt = getattr(torch, out_dtype)
    want = _numpy_dequant(packed, scales, zeros, dt)
    args = [torch.from_numpy(a) for a in (packed, scales, zeros)]
    n0 = sum(LAUNCH_COUNTS.values())
    plain = dq.int4_dequant(*args, out_dtype=dt)  # CPU tensors: the plain version
    assert sum(LAUNCH_COUNTS.values()) == n0
    assert plain.shape == (G, gs) and plain.dtype == dt
    assert torch.equal(plain, want)
    assert torch.equal(ref.int4_dequant_ref(*args, out_dtype=dt), want)
    jdt = getattr(jnp, out_dtype)
    jr = jref.int4_dequant_ref(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(zeros), out_dtype=jdt)
    assert torch.equal(torch.from_numpy(np.array(jr, np.float32)).to(dt), want)
    pal = pallas_dequant(jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(zeros), out_dtype=jdt, bg=bg,
                         interpret=True)
    if out_dtype == "float32":
        np.testing.assert_allclose(plain.numpy(), np.asarray(pal), atol=1e-6, rtol=0)
    else:  # one f32 ulp can move a bf16 rounding by one bf16 step
        np.testing.assert_allclose(plain.float().numpy(), np.asarray(pal, np.float32), atol=1e-6, rtol=2**-8)


def test_int4_dequant_validation_and_dispatch():
    packed, scales, zeros = (torch.from_numpy(a) for a in _int4_inputs(4, 4, 8))
    with pytest.raises(ValueError, match="uint8"):
        dq.int4_dequant(packed.int(), scales, zeros)
    with pytest.raises(ValueError, match="scales"):
        dq.int4_dequant(packed, scales[:2], zeros)
    with pytest.raises(ValueError, match="zeros"):
        dq.int4_dequant(packed, scales, zeros.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dq.int4_dequant(packed, scales, zeros, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        dq.int4_dequant(packed.t().contiguous().t(), scales, zeros)
    ops.reset_counts()
    ops.int4_dequant(packed, scales, zeros)
    assert ops.DISPATCH_COUNTS == {"int4_dequant.ref": 1} and not ops.LAUNCH_COUNTS
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.int4_dequant(packed, scales, zeros, backend="hopper")


# ---------------------------------------------------------------------------
# quantized experts through the grouped-matmul seam
# ---------------------------------------------------------------------------
def test_quantized_expert_structure_and_layer_slice():
    w = torch.from_numpy(_rand(5, 3, 4, 16, 96, std=0.1))
    qe = ops.quantize_weight(w, 32)
    assert qe.shape == (3, 4, 16, 96) and qe.group_size == 32 and qe.ndim == 4
    assert qe.nbytes == qe.packed.nbytes + qe.scales.nbytes + qe.zeros.nbytes
    one = layer_slice({"moe": {"wi_gate": qe}}, 1)["moe"]["wi_gate"]
    assert isinstance(one, ops.QuantizedExpert) and one.shape == (4, 16, 96)
    assert torch.equal(one.packed, qe.packed[1])
    jqe = jops.quantize_weight(jnp.asarray(w.numpy()), 32)
    for a in ("packed", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(qe, a).numpy(), np.asarray(getattr(jqe, a)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_quantized_rhs(dtype):
    """A ``QuantizedExpert`` and a flat ``QuantizedWeight`` rhs equal the
    matmul of the round-tripped weight, and the JAX seam's ref result."""
    dt = getattr(torch, dtype)
    w = _rand(6, 4, 32, 48, std=0.2)
    lhs = torch.from_numpy(_rand(7, 4, 8, 32)).to(dt)
    qe = ops.quantize_weight(torch.from_numpy(w))
    dense = torch.from_numpy(jq.dequantize_int4(jq.quantize_int4_lastdim(w))).to(dt)
    want = ops.grouped_matmul(lhs, dense)
    ops.reset_counts()
    got = ops.grouped_matmul(lhs, qe)
    assert ops.DISPATCH_COUNTS == {"int4_dequant.ref": 1, "gmm.ref": 1}
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    flat = q.quantize_int4_torch(torch.from_numpy(w), 64)
    qw = ops.QuantizedWeight(flat.packed, flat.scales, flat.zeros, shape=w.shape)
    flat_dense = torch.from_numpy(jq.dequantize_int4(jq.quantize_int4(w, "per_group", 64))).to(dt)
    torch.testing.assert_close(ops.grouped_matmul(lhs, qw), ops.grouped_matmul(lhs, flat_dense), atol=1e-5, rtol=1e-5)
    if dtype == "float32":
        jqe = jops.quantize_weight(jnp.asarray(w))
        jgot = jops.grouped_matmul(jnp.asarray(lhs.numpy()), jqe, backend="ref")
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5, rtol=1e-5)


def test_bridge_converts_jax_quantized_experts():
    """``params_from_numpy`` turns the JAX package's resident leaves into
    the port's, bytes unchanged, and casts only the dense leaves."""
    cfg = reduced("deepseek-moe-16b")
    jparams = jinit_params(cfg, jax.random.PRNGKey(0))
    moe = dict(jparams["layers"]["moe"])
    moe["wi_gate"] = jops.quantize_weight(moe["wi_gate"])
    jparams = dict(jparams, layers=dict(jparams["layers"], moe=moe))
    tp = params_from_numpy(jparams, "cpu", dtype="bfloat16")
    got = tp["layers"]["moe"]["wi_gate"]
    assert isinstance(got, ops.QuantizedExpert)
    assert got.packed.dtype == torch.uint8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(moe["wi_gate"].packed))
    assert tp["layers"]["moe"]["wi_up"].dtype == torch.bfloat16


def test_entry_points_run_on_the_card_unless_asked():
    """``init_params`` and ``params_from_numpy`` with no device go to the
    card and raise without one; the CPU is taken only when asked."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32")
    if torch.cuda.is_available():
        pytest.skip("this host has a card: device=None resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        params_from_numpy({"a": np.zeros(2, np.float32)})
    assert params_from_numpy({"a": np.zeros(2, np.float32)}, "cpu")["a"].device.type == "cpu"
