"""The port's paged-pool bookkeeping, prefix cache and prefix kernel seam
against the JAX package.

The copies in ``repro_torch.serving`` (``kv_cache``, ``prefix_cache`` and
``ContinuousScheduler``) run the scenarios of ``tests/test_kv_cache.py`` and
``tests/test_prefix_cache.py`` side by side with ``repro.serving``: every
result, every raised error and the allocator's whole state (free list,
reservations, refcounts) must be equal. The prefix kernel's reference and
plain version are held against ``repro.kernels.ref`` and the Pallas kernel in
interpret mode, in float32 at 2e-5, on inputs made from a seed with numpy;
the CUDA kernel itself runs in ``tests/test_torch_gpu.py`` on the card.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import prefix_paged_attention as pallas_prefix  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefix_paged_attention as ppa  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pkg(kv, pc, sched):
    return types.SimpleNamespace(
        Alloc=kv.BlockAllocator, Table=kv.BlockTable, blocks_for=kv.blocks_for, TRASH=kv.TRASH_BLOCK,
        OutOfBlocks=kv.OutOfBlocks, DoubleFree=kv.DoubleFree, Cache=pc.PrefixCache,
        Sched=sched.ContinuousScheduler,
    )


JAX, PORT = _pkg(jkv, jpc, jsched), _pkg(tkv, tpc, tsched)


def _raises(m, fn):
    """The name of the package error ``fn`` raises, or None."""
    try:
        fn()
    except (m.OutOfBlocks, m.DoubleFree, ValueError) as e:
        return type(e).__name__
    return None


def _state(a):
    return (list(a._free), a.num_reserved, list(a._ref))


def _donor(m, a, tokens, budget=None):
    """A registered and retired donor: the cache holds the only references."""
    pc = m.Cache(a)
    t = m.Table(a, budget or len(tokens))
    t.ensure_tokens(len(tokens))
    blocks = list(t.blocks)
    pc.register(np.asarray(tokens, np.int32), blocks)
    t.free()
    return pc, blocks


def _match(m_):
    return (m_.n_tokens, list(m_.blocks))


# Each scenario runs one sequence of operations and returns what it saw;
# the two packages must see the same. Taken from tests/test_kv_cache.py
# (35-121) and tests/test_prefix_cache.py (51-190).
def sc_blocks_for(m):
    return [m.blocks_for(n, 8) for n in (0, 1, 8, 9)]


def sc_reserve_alloc_free(m):
    a = m.Alloc(9, 4)
    obs = [a.num_free, a.num_available]
    t = m.Table(a, 16)
    obs += [a.num_reserved, a.num_available]
    t.ensure_tokens(6)
    obs += [list(t.blocks), a.num_free, a.num_reserved, _state(a)]
    t.free()
    return obs + [a.num_free, a.num_reserved, len(t), _state(a)]


def sc_admission_refused(m):
    a = m.Alloc(9, 4)
    t1 = m.Table(a, 24)
    obs = [a.can_admit(2), a.can_admit(3), _raises(m, lambda: m.Table(a, 16)), _state(a)]
    t1.free()
    return obs + [a.can_admit(8), _state(a)]


def sc_within_budget_then_oom(m):
    a = m.Alloc(5, 2)
    t1, t2 = m.Table(a, 4), m.Table(a, 4)
    t2.ensure_tokens(4)
    t1.ensure_tokens(4)
    obs = [list(t1.blocks), list(t2.blocks), a.num_free, _raises(m, lambda: t1.ensure_tokens(6))]
    t2.free()
    t1.ensure_tokens(6)
    return obs + [list(t1.blocks), _state(a)]


def sc_fragmentation_reuse(m):
    a = m.Alloc(7, 4)
    t1, t2 = m.Table(a, 8), m.Table(a, 8)
    t1.ensure_tokens(5)
    t2.ensure_tokens(5)
    obs = [list(t1.blocks), list(t2.blocks)]
    t1.free()
    t3 = m.Table(a, 8)
    t3.ensure_tokens(8)
    return obs + [list(t3.blocks), list(t2.blocks), _state(a)]


def sc_padded_row(m):
    a = m.Alloc(5, 4)
    t = m.Table(a, 8)
    t.ensure_tokens(4)
    row = t.padded(4)
    return [str(row.dtype), row.tolist(), m.TRASH]


def sc_next_fit_blocks(m):
    sch = m.Sched(max_batch=4, bucket=8)
    sch.submit(list(range(1, 10)), max_new_tokens=4)
    obs = [sch.kv_need(sch.peek()), sch.next_fit_blocks(m.Alloc(3, 8), max_tokens=64), len(sch)]
    big = m.Alloc(9, 8)
    obs.append(sch.next_fit_blocks(big, max_tokens=16))
    got = sch.next_fit_blocks(big, max_tokens=64)
    return obs + [got.uid, len(sch)]


def sc_match_register_tail(m):
    a = m.Alloc(8, 4)
    toks = np.arange(1, 11, dtype=np.int32)
    pc, blocks = _donor(m, a, toks, budget=12)
    obs = [blocks, [a.refcount(b) for b in blocks], _match(pc.match(toks))]
    for i in (9, 5):
        div = toks.copy()
        div[i] = 99
        obs.append(_match(pc.match(div)))
    return obs + [len(pc), pc.hits, pc.hit_blocks, pc.hit_tokens, _state(a)]


def sc_register_dedup(m):
    a = m.Alloc(8, 4)
    toks = np.arange(1, 11, dtype=np.int32)
    pc, blocks = _donor(m, a, toks, budget=12)
    t2 = m.Table(a, 12)
    t2.ensure_tokens(12)
    return [pc.register(toks, t2.blocks), _state(a)]


def sc_hash_collision(m):
    a = m.Alloc(8, 4)
    pc = m.Cache(a, hash_fn=lambda data: 7)
    t = m.Table(a, 8)
    t.ensure_tokens(8)
    pc.register(np.arange(1, 9, dtype=np.int32), t.blocks)
    other = np.arange(101, 109, dtype=np.int32)
    return [_match(pc.match(other)), _match(pc.match(np.arange(1, 9, dtype=np.int32))), list(t.blocks)]


def sc_double_free(m):
    a = m.Alloc(4, 4)
    t = m.Table(a, 8)
    t.ensure_tokens(8)
    b = t.blocks[0]
    t.free()
    t.free()  # idempotent
    return [_raises(m, lambda: a.free_block(b)), _raises(m, lambda: a.free_block(m.TRASH)), _state(a)]


def sc_cow_boundary_vs_mid_block(m):
    a = m.Alloc(12, 4)
    toks = np.arange(1, 12, dtype=np.int32)
    pc, blocks = _donor(m, a, toks, budget=16)
    t1 = m.Table(a, 16, shared_blocks=blocks[:2])
    obs = [t1.ensure_writable(8), t1.n_shared, list(t1.blocks)]
    t2 = m.Table(a, 16, shared_blocks=blocks, shared_partial=True)
    obs += [t2.ensure_writable(9), t2.n_shared, list(t2.blocks), t2.ensure_writable(9), _state(a)]
    t1.free()
    t2.free()
    return obs + [_state(a)]


def sc_retire_order(m):
    obs = []
    for donor_first in (True, False):
        a = m.Alloc(12, 4)
        toks = np.arange(1, 9, dtype=np.int32)
        pc = m.Cache(a)
        donor = m.Table(a, 12)
        donor.ensure_tokens(8)
        pc.register(toks, donor.blocks)
        adopter = m.Table(a, 12, shared_blocks=donor.blocks)
        shared = list(donor.blocks)
        obs.append([a.refcount(b) for b in shared])
        first, second = (donor, adopter) if donor_first else (adopter, donor)
        first.free()
        obs.append([a.refcount(b) for b in shared])
        second.free()
        obs += [[a.refcount(b) for b in shared], pc.evict(len(shared)), _state(a)]
    return obs


def sc_pool_fits_only_shared(m):
    a = m.Alloc(5, 8)
    toks16 = list(range(1, 17))
    pc, blocks = _donor(m, a, toks16, budget=16)
    sch = m.Sched(max_batch=2, bucket=8)
    sch.submit(toks16, max_new_tokens=7)
    obs = [a.num_available, sch.next_fit_blocks(a, max_tokens=64)]
    obs.append(sch.next_fit_blocks(a, max_tokens=64, prefix_cache=pc).uid)
    p = pc.plan_admission(np.asarray(toks16, np.int32), 24)
    return obs + [(p.skip, p.adopt, p.adopt_partial, p.raw_blocks, p.reserve_blocks), _state(a)]


def sc_evict_cold_keep_match(m):
    a = m.Alloc(5, 8)
    cold = np.asarray(list(range(51, 67)), np.int32)
    pc, cold_blocks = _donor(m, a, cold, budget=16)
    hot = np.asarray(list(range(1, 17)), np.int32)
    t = m.Table(a, 16)
    t.ensure_tokens(16)
    pc.register(hot, t.blocks)
    t.free()
    sch = m.Sched(max_batch=2, bucket=8)
    sch.submit(hot.tolist(), max_new_tokens=7)
    got = sch.next_fit_blocks(a, max_tokens=64, prefix_cache=pc)
    return [got.uid, cold_blocks, pc.evicted_blocks, len(pc), _state(a)]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_blocks_for, sc_reserve_alloc_free, sc_admission_refused, sc_within_budget_then_oom,
    sc_fragmentation_reuse, sc_padded_row, sc_next_fit_blocks, sc_match_register_tail, sc_register_dedup,
    sc_hash_collision, sc_double_free, sc_cow_boundary_vs_mid_block, sc_retire_order,
    sc_pool_fits_only_shared, sc_evict_cold_keep_match,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_copies_match_reference(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want


def test_double_free_message_names_the_contract():
    a = tkv.BlockAllocator(4, 4)
    t = tkv.BlockTable(a, 8)
    t.ensure_tokens(8)
    b = t.blocks[0]
    t.free()
    with pytest.raises(tkv.DoubleFree, match="exactly once per holder"):
        a.free_block(b)


# ---------------------------------------------------------------------------
# the prefix kernel seam
# ---------------------------------------------------------------------------
def _prefix_case(seed, B, C, Hq, Hkv, hd, bs, nb, N):
    """Rows 0 and 1 share their 2 leading table entries (one group, rep 0);
    the other rows stay on their own (tests/test_prefix_cache.py:207)."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tables = np.arange(1, B * nb + 1, dtype=np.int32).reshape(B, nb)
    tables[1, :2] = tables[0, :2]
    assert tables.max() < N
    reps, nsh = np.arange(B, dtype=np.int32), np.zeros((B,), np.int32)
    reps[1], nsh[1] = 0, 2
    return dict(
        q=rand(B, C, Hq, hd), kp=rand(N, bs, Hkv, hd), vp=rand(N, bs, Hkv, hd),
        tables=tables, kn=rand(B, C, Hkv, hd), vn=rand(B, C, Hkv, hd), reps=reps, nsh=nsh,
    )


# (B, C, Hq, Hkv, hd, bs, nb), pos, is_global, window, softcap
PREFIX_CASES = {
    "decode_gqa": ((3, 1, 4, 2, 16, 4, 3), [8, 9, 10], True, 0, 0.0),
    "chunk_across_pages": ((2, 5, 4, 4, 8, 4, 4), [8, 9], True, 0, 0.0),
    "window": ((3, 1, 4, 2, 16, 4, 3), [9, 9, 5], False, 6, 0.0),
    "softcap": ((3, 1, 4, 2, 16, 4, 3), [9, 9, 5], True, 0, 25.0),
    # head dim 256 at the families' GQA groups
    "hd256_g1": ((3, 1, 2, 2, 256, 4, 3), [8, 9, 10], True, 0, 0.0),
    "hd256_g2_window_softcap": ((3, 1, 4, 2, 256, 4, 3), [9, 9, 5], False, 6, 50.0),
    "hd256_g7": ((3, 1, 7, 1, 256, 4, 3), [8, 9, 10], True, 0, 0.0),
    "hd256_g8_chunk": ((2, 3, 8, 1, 256, 4, 4), [8, 9], True, 0, 30.0),
}


def _torch_args(c):
    return [torch.from_numpy(c[k].copy()) for k in ("q", "kp", "vp", "tables", "kn", "vn")]


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
def test_prefix_ref_and_plain_match_jax(name):
    shape, pos, is_global, window, softcap = PREFIX_CASES[name]
    B, C, Hq, Hkv, hd, bs, nb = shape
    c = _prefix_case(3, *shape, B * nb + 2)
    posn = np.asarray(pos, np.int32)
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    jargs = [jnp.asarray(c[k]) for k in ("q", "kp", "vp", "tables", "kn", "vn")]
    groups = (jnp.asarray(c["reps"]), jnp.asarray(c["nsh"]))
    want, kw_j, vw_j = jref.prefix_paged_attention_ref(*jargs, jnp.asarray(posn), *groups, is_global, **kw)
    pal, kp_p, _ = pallas_prefix(*jargs, jnp.asarray(posn), *groups, is_global, **kw)
    _close(pal, want)
    tpos, treps, tnsh = torch.from_numpy(posn), torch.from_numpy(c["reps"]), torch.from_numpy(c["nsh"])
    runs = {}
    for fn in ("ref", "plain", "ref_own", "plain_own"):
        q, kp, vp, tables, kn, vn = _torch_args(c)
        if fn == "ref":
            runs[fn] = ref.prefix_paged_attention_ref(q, kp, vp, tables, kn, vn, tpos, treps, tnsh, is_global, **kw)
        elif fn == "plain":
            runs[fn] = ppa.prefix_paged_attention(q, kp, vp, tables, kn, vn, tpos, treps, tnsh, is_global, **kw)
        elif fn == "ref_own":
            runs[fn] = ref.paged_attention_ref(q, kp, vp, tables, kn, vn, tpos, is_global, **kw)
        else:
            runs[fn] = pa.paged_attention_plain(q, kp, vp, tables, kn, vn, tpos, is_global, **kw)
    for fn in ("ref", "plain"):
        out, kp_t, vp_t = runs[fn]
        _close(out, want)
        _close(out, pal)
        # live pages (not the trash page 0) hold the appended K/V
        np.testing.assert_array_equal(kp_t.numpy()[1:], np.asarray(kw_j)[1:])
        np.testing.assert_array_equal(vp_t.numpy()[1:], np.asarray(vw_j)[1:])
        np.testing.assert_array_equal(kp_t.numpy()[1:], np.asarray(kp_p)[1:])
        # the grouping re-routes reads only: exactly the unshared result
        torch.testing.assert_close(out, runs[fn + "_own"][0], rtol=0, atol=0)


def _seam_args():
    c = _prefix_case(17, 3, 1, 4, 2, 16, 4, 3, 11)
    q, kp, vp, tables, kn, vn = _torch_args(c)
    pos = torch.tensor([9, 9, 5], dtype=torch.int32)
    return (q, kp, vp, kn, vn, pos), tables, torch.from_numpy(np.stack([c["reps"], c["nsh"]]))


def test_seam_prefix_dispatch_and_identity_grouping():
    """``ops.decode_attention`` routes ``prefix_groups`` to the prefix ref on
    the CPU; an identity grouping equals the plain paged path bit for bit
    (tests/test_prefix_cache.py:246)."""
    args, tables, groups = _seam_args()
    ident = torch.stack([torch.arange(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)])
    ops.reset_counts()
    outs = {}
    for name, g in (("grouped", groups), ("identity", ident), ("plain", None)):
        fresh = [a.clone() for a in args]
        outs[name], _, _ = ops.decode_attention(*fresh, block_tables=tables, prefix_groups=g, scale=16**-0.5)
    assert ops.DISPATCH_COUNTS["decode.ref_prefix"] == 2
    assert ops.DISPATCH_COUNTS["decode.ref_paged"] == 1
    assert not ops.LAUNCH_COUNTS
    torch.testing.assert_close(outs["identity"], outs["plain"], rtol=0, atol=0)
    torch.testing.assert_close(outs["grouped"], outs["plain"], rtol=TOL, atol=TOL)


def test_seam_prefix_groups_need_a_paged_cache():
    args, _, groups = _seam_args()
    q, _, _, kn, vn, pos = args
    cache = torch.zeros(3, 24, 2, 16)
    with pytest.raises(ValueError, match="paged cache"):
        ops.decode_attention(q, cache, cache.clone(), kn, vn, pos, prefix_groups=groups, backend="ref")


@pytest.mark.parametrize("bad", ["reps_shape", "nsh_dtype", "reps_noncontiguous"])
def test_prefix_wrapper_validates(bad):
    args, tables, groups = _seam_args()
    q, kp, vp, kn, vn, pos = args
    reps, nsh = groups[0].clone(), groups[1].clone()
    if bad == "reps_shape":
        reps = reps[:2]
    elif bad == "nsh_dtype":
        nsh = nsh.long()
    else:
        reps = torch.stack([reps, reps], 1)[:, 0]
    with pytest.raises(ValueError):
        ppa.prefix_paged_attention(q, kp, vp, tables, kn, vn, pos, reps, nsh)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)
