"""The port's sharded kernel-seam ops on two gloo ranks against the JAX
package's ``shard_map`` versions on two forced host devices.

One JAX subprocess draws every input from a numpy seed and runs
``repro.kernels.ops`` under ``shard_map`` (the Pallas kernels in interpret
mode): the grouped matmul column- and row-parallel, dense and resident
INT4 (its group axis dividing the mesh axis, and not), the paged and
contiguous decode attention on each device's head shard, ``a2a_ppermute``
and ``pipelined_ep_ffn`` at K = 1, 2, 3. One pair of gloo ranks runs the
port's counterparts on each rank's shard of the same inputs. Results match
within 1e-5 and the two ranks' shards reassemble the global result;
``a2a_ppermute`` equals ``all_to_all_single`` bit for bit, and the
pipelined schedules equal the serial one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_sharded import run_jax, run_ranks  # noqa: E402

E, C, D, F = 4, 24, 32, 128  # experts, capacity, model width, d_ff
GS = 32  # INT4 group size: F = 4 groups (divides two ranks); 96 = 3 (does not)
B, CH, HQ, HKV, HD, BS, NB = 2, 3, 4, 2, 16, 4, 9  # decode: rows, chunk, heads, head dim, block, blocks
TOL = 1e-5

_JAX = """
import functools, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.kernels import ops
from repro.models.moe import expert_ffn
from repro.sharding.specs import KernelShardAxes, SHARD_MAP_KW, shard_map

out = sys.argv[1]
E, C, D, F, GS, B, CH, HQ, HKV, HD, BS, NB = (int(a) for a in sys.argv[2:])
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ('data', 'model'))
ax = KernelShardAxes(mesh, 'model')
rng = np.random.default_rng(0)
f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
res = {}
ins = {'lhs': f32(E, C, D), 'wi': f32(E, D, F) * 0.2, 'wi96': f32(E, D, 96) * 0.2, 'h': f32(E, C, F),
       'wo': f32(E, F, D) * 0.2}
for name, w in (('wi', ins['wi']), ('wi96', ins['wi96'])):
    res[f'gmm_out_{name}'] = ops.grouped_matmul(jnp.asarray(ins['lhs']), jnp.asarray(w), shard_axes=ax,
                                                sharded_dim='out', backend='pallas')
    q = ops.quantize_weight(jnp.asarray(w), GS)
    res[f'gmm_out_{name}_int4'] = ops.grouped_matmul(jnp.asarray(ins['lhs']), q, shard_axes=ax, sharded_dim='out',
                                                     backend='pallas')
res['gmm_in'] = ops.grouped_matmul(jnp.asarray(ins['h']), jnp.asarray(ins['wo']), shard_axes=ax, sharded_dim='in',
                                   backend='pallas')
res['gmm_in_int4'] = ops.grouped_matmul(jnp.asarray(ins['h']), ops.quantize_weight(jnp.asarray(ins['wo']), GS),
                                        shard_axes=ax, sharded_dim='in', backend='pallas')

# decode attention per head shard: paged (with and without prefix groups) and contiguous
ins.update(q=f32(B, CH, HQ, HD), kn=f32(B, CH, HKV, HD), vn=f32(B, CH, HKV, HD), kp=f32(NB, BS, HKV, HD),
           vp=f32(NB, BS, HKV, HD), kc=f32(B, 16, HKV, HD), vc=f32(B, 16, HKV, HD),
           tables=np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32), pos=np.array([5, 9], np.int32),
           groups=np.array([[0, 0], [0, 1]], np.int32))
ins['tables_shared'] = np.array([[1, 2, 3, 4], [1, 6, 7, 8]], np.int32)
j = {k: jnp.asarray(v) for k, v in ins.items()}
for name, kw in (('paged', dict(block_tables=j['tables'])),
                 ('prefix', dict(block_tables=j['tables_shared'], prefix_groups=j['groups']))):
    o, kp, vp = ops.decode_attention(j['q'], j['kp'], j['vp'], j['kn'], j['vn'], j['pos'], shard_axes=ax,
                                     backend='pallas', **kw)
    res[f'{name}_out'], res[f'{name}_k'], res[f'{name}_v'] = o, kp, vp
o, kc, vc = ops.decode_attention(j['q'][:, :1], j['kc'], j['vc'], j['kn'][:, :1], j['vn'][:, :1], jnp.int32(7),
                                 shard_axes=ax, backend='pallas')
res['contig_out'], res['contig_k'], res['contig_v'] = o, kc, vc

# a2a_ppermute and the pipelined EP FFN inside an EP shard_map: device r's dispatch buffer is bufs[r]
ins['bufs'] = f32(2, E, C, D)
wig, wiu, wo = (jnp.asarray(f32(*s) * 0.2) for s in ((E, D, F), (E, D, F), (E, F, D)))
ins.update(wig=np.asarray(wig), wiu=np.asarray(wiu), wo_ep=np.asarray(wo))
def a2a(b):
    return ops.a2a_ppermute(b[0], 'model', split=0, concat=1)[None]
res['a2a'] = shard_map(a2a, mesh=mesh, in_specs=(P('model'),), out_specs=P('model'), **SHARD_MAP_KW)(
    jnp.asarray(ins['bufs']))
for K in (1, 2, 3):
    def local(b, g, u, o, K=K):
        ffn = lambda x: expert_ffn(x, g, u, o, 'silu', backend='ref')
        return ops.pipelined_ep_ffn(b[0], ffn, ep_axis='model', chunks=K)[None]
    spec = P('model')
    res[f'ep_k{K}'] = shard_map(local, mesh=mesh, in_specs=(spec, spec, spec, spec), out_specs=spec,
                                **SHARD_MAP_KW)(jnp.asarray(ins['bufs']), wig, wiu, wo)
np.savez(f'{out}/inputs.npz', **ins)
np.savez(f'{out}/jax.npz', **{k: np.asarray(v) for k, v in res.items()})
print('OK')
"""


def ranks_ops(mesh, data: str):
    """One rank: the port's sharded ops on this rank's shards; returns the
    reassembled (gathered) results."""
    from repro_torch.kernels import ops
    from repro_torch.models.moe import expert_ffn
    from repro_torch.sharding.specs import KernelShardAxes

    torch.set_num_threads(1)
    with np.load(f"{data}/inputs.npz") as z:
        t = {k: torch.from_numpy(z[k]) for k in z.files}
    r, n = mesh.rank, mesh.size
    res = {}

    def cols(x, dim=-1):
        step = x.shape[dim] // n
        return x.narrow(dim, r * step, step).contiguous()

    for name in ("wi", "wi96"):
        w = t[name]
        f = w.shape[-1]
        ax = KernelShardAxes(mesh, "model", f)
        res[f"gmm_out_{name}"] = mesh.all_gather(
            ops.grouped_matmul(t["lhs"], cols(w), shard_axes=ax, sharded_dim="out"), dim=-1)
        q = ops.quantize_weight(w, GS)
        fused = q.packed.shape[-2] % n == 0
        q_local = ops.QuantizedExpert(*(cols(a, -2) for a in (q.packed, q.scales, q.zeros))) if fused else q
        res[f"gmm_out_{name}_int4"] = mesh.all_gather(
            ops.grouped_matmul(t["lhs"], q_local, shard_axes=ax, sharded_dim="out"), dim=-1)
        res[f"gmm_out_{name}_fused"] = np.array(fused)
    ax = KernelShardAxes(mesh, "model", F)
    res["gmm_in"] = ops.grouped_matmul(cols(t["h"]), cols(t["wo"], 1), shard_axes=ax, sharded_dim="in")
    qo = ops.quantize_weight(t["wo"], GS)
    res["gmm_in_int4"] = ops.grouped_matmul(cols(t["h"]), ops.QuantizedExpert(*(cols(a, 1) for a in (
        qo.packed, qo.scales, qo.zeros))), shard_axes=ax, sharded_dim="in")

    heads = {k: cols(t[k], 2) for k in ("q", "kn", "vn", "kp", "vp", "kc", "vc")}
    for name, kw in (("paged", dict(block_tables=t["tables"])),
                     ("prefix", dict(block_tables=t["tables_shared"], prefix_groups=t["groups"]))):
        o, kp, vp = ops.decode_attention(heads["q"], heads["kp"].clone(), heads["vp"].clone(), heads["kn"],
                                         heads["vn"], t["pos"], **kw)
        res[f"{name}_out"], res[f"{name}_k"], res[f"{name}_v"] = (mesh.all_gather(x, dim=2) for x in (o, kp, vp))
    o, kc, vc = ops.decode_attention(heads["q"][:, :1], heads["kc"].clone(), heads["vc"].clone(),
                                     heads["kn"][:, :1], heads["vn"][:, :1], 7)
    res["contig_out"], res["contig_k"], res["contig_v"] = (mesh.all_gather(x, dim=2) for x in (o, kc, vc))

    buf = t["bufs"][r]
    a2a = ops.a2a_ppermute(buf, mesh, split=0, concat=1)
    res["a2a_equals_all_to_all"] = np.array(torch.equal(a2a, mesh.all_to_all(buf, split=0, concat=1)))
    back = ops.a2a_ppermute(a2a, mesh, split=1, concat=0)
    res["a2a_round_trip"] = np.array(torch.equal(back, buf))
    res["a2a"] = mesh.all_gather(a2a[None], dim=0)
    wig, wiu, wo = (cols(t[k], 0) for k in ("wig", "wiu", "wo_ep"))
    for K in (1, 2, 3):
        ops.reset_counts()
        y = ops.pipelined_ep_ffn(buf, lambda x: expert_ffn(x, wig, wiu, wo, "silu"), mesh=mesh, chunks=K)
        res[f"ep_k{K}"] = mesh.all_gather(y[None], dim=0)
        res[f"ep_k{K}_dispatch"] = dict(ops.DISPATCH_COUNTS)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in res.items()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_ops")
    run_jax(_JAX, str(work), *(str(v) for v in (E, C, D, F, GS, B, CH, HQ, HKV, HD, BS, NB)), timeout=600)
    with np.load(work / "jax.npz") as z:
        want = {k: z[k] for k in z.files}
    ranks = run_ranks("test_torch_sharded_ops:ranks_ops", work / "ranks", timeout=300, data=str(work))
    return want, ranks


def _same_on_both_ranks(ranks, key):
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    return ranks[0][key]


@pytest.mark.parametrize("name", ["gmm_out_wi", "gmm_out_wi96", "gmm_out_wi_int4", "gmm_out_wi96_int4", "gmm_in",
                                  "gmm_in_int4"])
def test_grouped_matmul_sharded_equals_shard_map(both, name):
    want, ranks = both
    got = _same_on_both_ranks(ranks, name)
    np.testing.assert_allclose(got, want[name], rtol=TOL, atol=TOL)


def test_int4_fused_only_where_the_group_axis_divides(both):
    """F = 128 holds 4 groups of 32 (each rank dequantizes its 2); 96 holds
    3 (each rank dequantizes all 3 and keeps its 48 columns)."""
    _, ranks = both
    assert bool(ranks[0]["gmm_out_wi_fused"]) and not bool(ranks[0]["gmm_out_wi96_fused"])


@pytest.mark.parametrize("layout", ["paged", "prefix", "contig"])
@pytest.mark.parametrize("part", ["out", "k", "v"])
def test_decode_attention_per_head_shard_equals_shard_map(both, layout, part):
    want, ranks = both
    key = f"{layout}_{part}"
    got = _same_on_both_ranks(ranks, key)
    np.testing.assert_allclose(got, want[key], rtol=TOL, atol=TOL)


def test_a2a_ppermute_bit_equal_to_all_to_all(both):
    want, ranks = both
    for r in ranks:
        assert bool(r["a2a_equals_all_to_all"]) and bool(r["a2a_round_trip"])
    np.testing.assert_array_equal(_same_on_both_ranks(ranks, "a2a"), want["a2a"])


@pytest.mark.parametrize("K", [1, 2, 3])
def test_pipelined_ep_ffn_equals_serial_and_shard_map(both, K):
    want, ranks = both
    got = _same_on_both_ranks(ranks, f"ep_k{K}")
    np.testing.assert_allclose(got, want[f"ep_k{K}"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ranks[0]["ep_k1"], rtol=1e-6, atol=1e-6)
    counts = ranks[0][f"ep_k{K}_dispatch"]
    assert counts.get("moe.ep_serial" if K == 1 else f"moe.ep_pipeline_k{K}") == 1
    assert counts.get("moe.ep_a2a_ppermute", 0) == (K > 1)
