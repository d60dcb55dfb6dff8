"""The launch plan and the split algorithm of the paged decode kernels, on the CPU.

``paged_attention`` and ``prefix_paged_attention`` work out, in Python and
before the launch, which variant runs (``split`` for bfloat16, ``simt`` for
float32), the splits, row tiles, grid, shared memory and workspace
(``paged_attention.decode_plan``); the CUDA launchers only check the plan.
These tests hold the plans at the main path's shapes (DeepSeekMoE-16B: 16
heads of 128; the static decode step on a 145-token identity page, the
continuous chunk and decode on 16-token pages) and at the card tests' shapes
to the kernels' contracts: every (KV head, row, tile, split) is covered by
exactly one block, shared memory and the grid fit, and bad plans are refused.

A plain-PyTorch model of the split variant then walks a plan's blocks as
the kernels do: per-split partials (m, l, acc) for the rows a block
computes, appended keys taken from k_new / v_new, each appended slot written
by exactly one block and read by none, the prefix kernel's shared splits
computed once per group through the representative's table and its own
splits per row, and a merge in split order. In float32 it equals the
wrapper's plain version (1e-5: the same sums in another order) and matches
``repro.kernels.ref`` and the Pallas kernels in interpret mode on the same
numpy-seeded inputs (2e-5, as the port's other kernel tests).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro.kernels.paged_attention import prefix_paged_attention as pallas_prefix  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefix_paged_attention as ppa  # noqa: E402

SMEM_MAX = 232_448
TOL = 2e-5
MODEL_TOL = 1e-5

# (B, C, Hq, Hkv, hd, bs, n_blocks): the main path (static decode on the
# identity table, the continuous chunk, the continuous decode), the card
# tests' paged and split-edge shapes, and the card tests' PREFIX_CASES
MAIN_SHAPES = [(4, 1, 16, 16, 128, 145, 1), (1, 64, 16, 16, 128, 16, 20), (8, 1, 16, 16, 128, 16, 20)]
CARD_SHAPES = [
    (3, 5, 4, 2, 32, 16, 4),
    (2, 40, 4, 2, 64, 8, 12),
    (3, 1, 8, 2, 128, 16, 8),
    (2, 3, 4, 4, 64, 16, 8),
    (70, 1, 4, 2, 64, 8, 12),
]
PREFIX_SHAPES = [
    (8, 1, 16, 16, 128, 16, 20),
    (4, 1, 4, 2, 64, 8, 10),
    (5, 5, 8, 2, 32, 16, 6),
    (70, 1, 2, 2, 32, 4, 8),
    (4, 2, 4, 2, 64, 8, 12),
    (3, 1, 4, 2, 64, 16, 4),
    (7, 1, 16, 16, 128, 16, 12),
]
ALL_SHAPES = MAIN_SHAPES + CARD_SHAPES + PREFIX_SHAPES
# the other families' decode shapes (chip_smoke.py's families phase and its
# kernel rows): Gemma-2-9B at head dim 256 (16 q over 8 KV heads) on the
# static identity page, the continuous chunk and decode, and at position
# ~6000 on 376-page tables; Gemma-7B's 16/16 heads of 256; Qwen3-30B-A3B's
# G=8 (32/4), Qwen2-57B-A14B's G=7 (28/4), Mixtral-8x7B's and
# Mistral-Nemo-12B's G=4 (32/8), Gemma-3-27B's G=2 (32/16), all at 128
FAMILY_SHAPES = [
    (4, 1, 16, 8, 256, 145, 1),
    (1, 64, 16, 8, 256, 16, 20),
    (8, 1, 16, 8, 256, 16, 20),
    (4, 1, 16, 8, 256, 16, 376),
    (4, 1, 16, 16, 256, 145, 1),
    (4, 1, 32, 4, 128, 145, 1),
    (8, 1, 32, 4, 128, 16, 20),
    (1, 64, 32, 4, 128, 16, 20),
    (4, 1, 28, 4, 128, 145, 1),
    (4, 1, 32, 8, 128, 145, 1),
    (4, 1, 32, 16, 128, 145, 1),
]


def _ids(shape):
    return "B{}_C{}_H{}x{}_hd{}_bs{}_nb{}".format(*shape)


def _check_coverage(plan, shape, prefix):
    """Every (KV head, row, tile, split) item of the plan is covered by
    exactly one block; the tiles cover the rows, the splits the keys; the
    grid, workspace and combine blocks fit the shapes."""
    B, C, Hq, Hkv, hd, bs, nb = shape
    assert plan.variant == "split" and plan.s_split == 64 and plan.row_tile == 16
    rows = C * (Hq // Hkv)
    n_splits = math.ceil(nb * bs / plan.s_split)
    seen = [item for blk in range(plan.items) for item in plan.block_items(blk)]
    assert len(seen) == len(set(seen)), "a block item is computed twice"
    own = {(h, b, t, s) for h in range(Hkv) for b in range(B) for t in range(math.ceil(rows / 16))
           for s in range(n_splits)}
    shared = {(h, b, t, s) for h in range(Hkv) for b in range(B) for t in range(math.ceil(B * rows / 16))
              for s in range(n_splits)} if prefix else set()
    assert {i[1:] for i in seen if i[0] == "own"} == own
    assert {i[1:] for i in seen if i[0] == "shared"} == shared
    # the tiles cover the rows, the splits the keys
    assert (plan.n_tiles - 1) * 16 < rows <= plan.n_tiles * 16
    assert (plan.n_splits - 1) * 64 < nb * bs <= plan.n_splits * 64
    assert plan.grid[0] < 2**31 and max(plan.grid[1:]) <= 65535
    assert plan.workspace_floats == B * Hkv * rows * n_splits * (hd + 2)
    assert plan.combine_blocks * 4 >= B * Hkv * rows > (plan.combine_blocks - 1) * 4  # a warp per row


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_ids)
@pytest.mark.parametrize("prefix", [False, True], ids=["paged", "prefix"])
def test_decode_plan_covers_every_item_once(shape, prefix):
    plan = pa.decode_plan(*shape, torch.bfloat16, prefix)
    _check_coverage(plan, shape, prefix)
    assert 0 < plan.smem_bytes <= 48 * 1024  # no opt-in needed


@pytest.mark.parametrize("shape", FAMILY_SHAPES, ids=_ids)
@pytest.mark.parametrize("prefix", [False, True], ids=["paged", "prefix"])
def test_decode_plan_at_the_families_shapes(shape, prefix):
    """Every family's decode shape takes the bf16 split variant, never a
    quiet fall back to simt, with full coverage; head dim 256 needs 79,168
    bytes of shared memory (79,236 with the prefix kernel's group scan),
    which the launchers opt into, against 42,304 at 128."""
    plan = pa.decode_plan(*shape, torch.bfloat16, prefix)
    _check_coverage(plan, shape, prefix)
    hd = shape[4]
    want = {128: 42_304, 256: 79_168}[hd] + (68 if prefix else 0)
    assert plan.smem_bytes == pa.split_smem_bytes(hd, prefix) == want <= SMEM_MAX
    assert (plan.smem_bytes > 48 * 1024) == (hd == 256)
    f32 = pa.decode_plan(*shape, torch.float32, prefix)
    assert f32.variant == "simt" and f32.smem_bytes <= SMEM_MAX
    # bf16 at a head dim without a split instance (144) takes simt
    assert pa.decode_plan(*shape[:4], 144, *shape[5:], torch.bfloat16, prefix).variant == "simt"


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=_ids)
def test_decode_plan_variant(shape):
    """bf16 at a head dim that is a multiple of 16 on aligned operands takes
    split; float32, unaligned operands and other head dims take simt."""
    for prefix in (False, True):
        assert pa.decode_plan(*shape, torch.bfloat16, prefix).variant == "split"
        assert pa.decode_plan(*shape, torch.bfloat16, prefix, False).variant == "simt"
        f32 = pa.decode_plan(*shape, torch.float32, prefix)
        assert f32.variant == "simt" and f32.workspace_floats == 0 and f32.smem_bytes <= SMEM_MAX
    B, C, Hq, Hkv, _, bs, nb = shape
    assert pa.decode_plan(B, C, Hq, Hkv, 40, bs, nb, torch.bfloat16).variant == "simt"


def _main_path_blocks(B, C, nb, bs, pos, groups=(), prefix=False):
    """Working blocks of a main-path launch (16 KV heads), counted by the
    split model at head dim 16 (the block map does not depend on it)."""
    rng = np.random.default_rng(13)
    Hq = Hkv = 16
    N = B * nb + 1
    tables = np.arange(1, N, dtype=np.int32).reshape(B, nb) if nb > 1 else np.arange(B, dtype=np.int32)[:, None]
    reps, nsh = np.arange(B, dtype=np.int32), np.zeros(B, np.int32)
    for rep, members, shared in groups:
        for m in members:
            tables[m, :shared] = tables[rep, :shared]
            reps[m], nsh[m] = rep, shared
    t = [torch.from_numpy(_rand(rng, *sh)) for sh in ((B, C, Hq, 16), (N, bs, Hkv, 16), (N, bs, Hkv, 16))]
    new = [torch.from_numpy(_rand(rng, B, C, Hkv, 16)) for _ in range(2)]
    plan = pa.decode_plan(B, C, Hq, Hkv, 128, bs, nb, torch.bfloat16, prefix)
    plan = dataclasses.replace(plan, hd=16)
    *_, working = split_model(plan, *t, torch.from_numpy(tables), *new, torch.tensor(pos, dtype=torch.int32),
                              reps, nsh, scale=0.25)
    return plan, working


def test_decode_plan_main_path_fills_the_card():
    """At least 132 working blocks (the H100's SMs) at every main-path shape:
    a static decode step's 3 splits of a 145-token page, the continuous
    chunk's 4 row tiles x 4 splits below position 256, and the continuous
    prefix decode (chip_smoke.py's prefix row): the group's 192 shared keys
    once, fewer blocks than the paged kernel on the same inputs."""
    plan, working = _main_path_blocks(4, 1, 1, 145, [135] * 4)
    assert plan.grid == (3, 16, 4) and working == 192
    plan, working = _main_path_blocks(1, 64, 20, 16, [192])
    assert plan.grid == (20, 16, 1) and working == 256
    pos = [262 + 2 * b for b in range(8)]
    groups = [(1, range(2, 8), 12)]
    plan, working = _main_path_blocks(8, 1, 20, 16, pos, groups, prefix=True)
    _, paged = _main_path_blocks(8, 1, 20, 16, pos)
    assert plan.grid == (5, 16, 8) and working == 352 and paged == 640


@pytest.mark.parametrize(
    "change",
    [
        {"smem_bytes": SMEM_MAX + 1},
        {"smem_bytes": 1024},
        {"variant": "wgmma"},
        {"s_split": 32},
        {"row_tile": 64},
        {"n_splits": 2},
        {"n_tiles": 2},
        {"grid": (3, 16, 8)},
        {"workspace_floats": 0},
        {"combine_blocks": 1},
        {"hd": 40},
    ],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()),
)
def test_decode_bad_plan_raises(change):
    plan = pa.decode_plan(4, 1, 16, 16, 128, 145, 1, torch.bfloat16)
    pa.check_plan(plan)
    with pytest.raises(ValueError):
        pa.check_plan(dataclasses.replace(plan, **change))


@pytest.mark.parametrize("change", [{"grid": (16, 4, 2)}, {"smem_bytes": 4096}, {"workspace_floats": 8},
                                    {"combine_blocks": 8}, {"n_gtiles": 1}, {"s_split": 64}])
def test_decode_bad_simt_plan_raises(change):
    plan = pa.decode_plan(8, 1, 16, 16, 128, 16, 20, torch.float32, True)
    pa.check_plan(plan)
    with pytest.raises(ValueError):
        pa.check_plan(dataclasses.replace(plan, **change))


def test_decode_plan_refuses_too_many_rows():
    with pytest.raises(ValueError):
        pa.decode_plan(70000, 1, 2, 2, 32, 4, 8, torch.bfloat16)


def test_cpu_calls_make_no_plan_and_count_nothing():
    _build.reset_launch_counts()
    before = pa.decode_plan.cache_info()
    B, C, Hq, Hkv, hd, bs, nb = 2, 1, 4, 2, 16, 16, 5
    q, kp, vp, kn, vn = (torch.ones(*s) for s in ((B, C, Hq, hd), (B * nb + 1, bs, Hkv, hd), (B * nb + 1, bs, Hkv, hd),
                                                  (B, C, Hkv, hd), (B, C, Hkv, hd)))
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32).reshape(B, nb)
    pos = torch.tensor([70, 3], dtype=torch.int32)
    reps, nsh = torch.tensor([0, 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    pa.paged_attention(q, kp, vp, tables, kn, vn, pos)
    ppa.prefix_paged_attention(q, kp, vp, tables, kn, vn, pos, reps, nsh)
    after = pa.decode_plan.cache_info()
    assert (after.hits, after.misses) == (before.hits, before.misses)
    assert not _build.LAUNCH_COUNTS and not _build.VARIANT_COUNTS


# ---------------------------------------------------------------------------
# the split algorithm, modelled in plain PyTorch
# ---------------------------------------------------------------------------
def _group_rep(reps, b):
    r = int(reps[b])
    return r if 0 <= r < len(reps) and int(reps[r]) == r else b


def _row_keys(p, width, window):
    """A query at position p reads keys [lo, hi] (empty when lo > hi)."""
    if p < 0:
        return 1, 0
    return (max(0, p - window + 1) if window > 0 else 0), min(p, width - 1)


def split_model(plan, q, kp, vp, tables, kn, vn, pos, reps=None, nsh=None, *, window=0, softcap=0.0, scale):
    """The split variant's blocks and merge in float32, following
    ``plan``: returns ``(out, k_pages, v_pages, working blocks)`` (the pages
    are copies, appended to) and checks the variant's invariants on the way."""
    B, C, Hq, hd = q.shape
    bs, Hkv = kp.shape[1], kp.shape[2]
    G, R, S = Hq // Hkv, C * (Hq // Hkv), plan.s_split
    width = tables.shape[1] * bs
    pos = [int(p) for p in pos]
    kp, vp = kp.clone(), vp.clone()
    parts, written, read = {}, set(), set()
    working = 0  # blocks with a row to compute

    def run(b):
        """The keys below which row b's splits are group splits: the
        representative's position; a member's shared pages, cut at its
        position and at its representative's run (0 for the paged kernel)."""
        if not plan.prefix:
            return 0
        rep = _group_rep(reps, b)
        rep_run = min(max(pos[rep], 0), width)
        if rep == b:
            return rep_run
        return min(min(max(int(nsh[b]), 0), tables.shape[1]) * bs, max(pos[b], 0), rep_run)

    gx, gy, _ = plan.grid
    for blk in range(plan.items):
        x, h, z = blk % gx, (blk // gx) % gy, blk // (gx * gy)
        unit, s = divmod(x, plan.n_splits)
        group = plan.prefix and _group_rep(reps, z) == z and (s + 1) * S <= run(z)
        if group:  # group tile `unit` of z's group, through z's table
            members = [b for b in range(B) if _group_rep(reps, b) == z]
            rows = [(members[gr // R], gr % R) for gr in range(unit * 16, min(unit * 16 + 16, len(members) * R))]
            rows = [(b, r) for b, r in rows if (s + 1) * S <= run(b)]
            new_b = None
        else:  # row tile `unit` of z
            rows = [(z, r) for r in range(unit * 16, min(unit * 16 + 16, R)) if (s + 1) * S > run(z)]
            new_b = z
        kind = "shared" if group else "own"
        active = []
        for b, r in rows:
            lo, hi = _row_keys(pos[b] + r // G, width, window)
            lo, hi = max(lo, s * S), min(hi, s * S + S - 1)
            if lo <= hi:
                active.append((b, r, lo, hi))
        if not active:
            continue
        assert (kind, h, z, unit, s) in plan.block_items(blk)
        if kind == "own":  # this block's appended slots
            for c in range(C):
                t = pos[z] + c
                if (c * G) // 16 == unit and 0 <= t < width and t // S == s:
                    slot = (int(tables[z, t // bs]), t % bs, h)
                    assert slot not in written, "an appended slot is written twice"
                    written.add(slot)
                    kp[slot] = kn[z, c, h]
                    vp[slot] = vn[z, c, h]
        working += 1
        k_lo, k_hi = min(a[2] for a in active), max(a[3] for a in active)
        keys, vals = torch.zeros(S, hd), torch.zeros(S, hd)
        t = torch.arange(k_lo, k_hi + 1)
        new = (t >= pos[new_b]) & (t < pos[new_b] + C) if new_b is not None else torch.zeros_like(t, dtype=bool)
        page, slot = tables[z].long()[t[~new] // bs], t[~new] % bs
        read.update(zip(page.tolist(), slot.tolist(), [h] * len(page)))
        keys[t[~new] - s * S], vals[t[~new] - s * S] = kp[page, slot, h], vp[page, slot, h]
        if new.any():
            c = t[new] - pos[new_b]
            keys[t[new] - s * S], vals[t[new] - s * S] = kn[new_b, c, h], vn[new_b, c, h]
        for b, r, lo, hi in active:
            x = keys @ q[b, r // G, h * G + r % G].float() * scale
            if softcap > 0:
                x = softcap * torch.tanh(x / softcap)
            t = torch.arange(s * S, s * S + S)
            x = torch.where((t >= lo) & (t <= hi), x, torch.tensor(-math.inf))
            m = x.max()
            p = torch.exp(x - m)
            key = (b, h, r, s)
            assert key not in parts, "a row's split is computed twice"
            parts[key] = (m, p.sum(), p @ vals)
    assert not written & read, "a block read an appended slot"

    out = torch.zeros(B, C, Hq, hd)
    used = set()
    for b in range(B):
        for h in range(Hkv):
            for r in range(R):
                lo, hi = _row_keys(pos[b] + r // G, width, window)
                if lo > hi:
                    continue
                order = [(b, h, r, s) for s in range(lo // S, hi // S + 1)]  # split order
                used.update(order)
                ps = [parts[k] for k in order]
                m = max(pm for pm, _, _ in ps)
                e = [torch.exp(pm - m) for pm, _, _ in ps]
                acc = sum(pacc * ei for (_, _, pacc), ei in zip(ps, e))
                l_ = sum(pl * ei for (_, pl, _), ei in zip(ps, e))
                out[b, r // G, h * G + r % G] = acc / l_
    assert used == set(parts), "a block computed a split no row reads"
    return out, kp, vp, working


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (B, C, Hq, Hkv, hd, bs, nb), pos, window, softcap: 64-key splits over
# 16-token pages (8 pages: 2 splits, 10: 3)
PAGED_MODEL_CASES = {
    "pos_split_minus_1": ((3, 1, 4, 2, 16, 16, 8), [63, 62, 10], 0, 0.0),
    "pos_split": ((3, 1, 4, 2, 16, 16, 8), [64, 0, 127], 0, 0.0),
    "pos_split_plus_1": ((3, 1, 4, 2, 16, 16, 8), [65, 127, 1], 0, 0.0),
    "chunk_across_split": ((3, 5, 4, 2, 16, 16, 10), [61, 126, 0], 0, 0.0),
    "window": ((3, 2, 4, 2, 16, 16, 10), [100, 70, 65], 40, 0.0),
    "softcap": ((2, 1, 4, 2, 16, 16, 10), [140, 66], 0, 25.0),
    "gqa_two_row_tiles": ((2, 3, 8, 1, 16, 16, 8), [66, 20], 0, 0.0),
    # head dim 256 (Gemma-2-9B's G=2, window, softcap 50) and G=8 / G=7
    "hd256_window_softcap": ((2, 2, 4, 2, 256, 16, 10), [100, 66], 40, 50.0),
    "hd256_g8": ((2, 1, 8, 1, 256, 16, 8), [66, 127], 0, 0.0),
    "g7_chunk": ((2, 3, 7, 1, 16, 16, 8), [62, 20], 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(PAGED_MODEL_CASES))
def test_split_model_matches_plain_ref_and_pallas(name):
    (B, C, Hq, Hkv, hd, bs, nb), pos, window, softcap = PAGED_MODEL_CASES[name]
    rng = np.random.default_rng(11)
    N = B * nb + 1
    tables = rng.permutation(np.arange(1, N)).astype(np.int32).reshape(B, nb)
    q, kp, vp, kn, vn = (_rand(rng, *s) for s in ((B, C, Hq, hd), (N, bs, Hkv, hd), (N, bs, Hkv, hd),
                                                   (B, C, Hkv, hd), (B, C, Hkv, hd)))
    posn = np.asarray(pos, np.int32)
    is_global = window == 0
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    t = [torch.from_numpy(a.copy()) for a in (q, kp, vp, tables, kn, vn, posn)]
    plan = pa.decode_plan(B, C, Hq, Hkv, hd, bs, nb, torch.bfloat16)
    got, kg, vg, _ = split_model(plan, *t, **kw)
    want, kw_p, vw_p = pa.paged_attention_plain(*[x.clone() for x in t], is_global, **kw)
    torch.testing.assert_close(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert torch.equal(kg, kw_p) and torch.equal(vg, vw_p)
    j_in = [jnp.asarray(a) for a in (q, kp, vp, tables, kn, vn, posn)]
    j_out, j_k, _ = jref.paged_attention_ref(*j_in, is_global, **kw)
    p_out, p_k, _ = pallas_paged(*j_in, is_global, interpret=True, **kw)
    for other in (j_out, p_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(kg.numpy()[1:], np.asarray(j_k)[1:])
    np.testing.assert_array_equal(kg.numpy(), np.asarray(p_k))


# (B, C, Hq, Hkv, hd, bs, nb), groups (rep, members, shared pages), pos,
# window, softcap
PREFIX_MODEL_CASES = {
    # 80 shared keys: split 1 (keys 64..127) straddles the end of the run
    "run_ends_mid_split": ((4, 1, 4, 2, 16, 16, 10), [(0, (1, 2), 5)], [130, 100, 81, 90], 0, 0.0),
    "run_of_whole_splits": ((4, 1, 4, 2, 16, 16, 10), [(1, (0, 2, 3), 8)], [150, 140, 128, 131], 0, 0.0),
    # members sharing 3 and 6 pages with one representative
    "members_differ": ((4, 1, 4, 2, 16, 16, 10), [(2, (0,), 3), (2, (3,), 6)], [120, 90, 130, 96], 0, 0.0),
    "window_softcap": ((3, 2, 4, 2, 16, 16, 10), [(0, (1, 2), 8)], [150, 140, 129], 70, 30.0),
    "gqa_chunk": ((3, 3, 8, 2, 16, 16, 8), [(1, (0, 2), 4)], [70, 64, 100], 0, 0.0),
    "hd256_g2_window_softcap": ((3, 1, 4, 2, 256, 16, 10), [(0, (1, 2), 8)], [150, 140, 129], 70, 50.0),
}


@pytest.mark.parametrize("name", sorted(PREFIX_MODEL_CASES))
def test_prefix_split_model_matches_plain_ref_and_pallas(name):
    """Shared splits once per group, own splits per row, the paged merge:
    exactly the paged model on the rows' own tables, and the references."""
    (B, C, Hq, Hkv, hd, bs, nb), groups, pos, window, softcap = PREFIX_MODEL_CASES[name]
    rng = np.random.default_rng(12)
    N = B * nb + 1
    tables = np.arange(1, N, dtype=np.int32).reshape(B, nb)
    reps, nsh = np.arange(B, dtype=np.int32), np.zeros(B, np.int32)
    for rep, members, shared in groups:
        for m in members:
            tables[m, :shared] = tables[rep, :shared]
            reps[m], nsh[m] = rep, shared
            assert pos[m] >= shared * bs
    q, kp, vp, kn, vn = (_rand(rng, *s) for s in ((B, C, Hq, hd), (N, bs, Hkv, hd), (N, bs, Hkv, hd),
                                                   (B, C, Hkv, hd), (B, C, Hkv, hd)))
    posn = np.asarray(pos, np.int32)
    is_global = window == 0
    kw = dict(scale=hd**-0.5, softcap=softcap, window=window)
    t = [torch.from_numpy(a.copy()) for a in (q, kp, vp, tables, kn, vn, posn)]
    plan = pa.decode_plan(B, C, Hq, Hkv, hd, bs, nb, torch.bfloat16, True)
    assert plan.n_gtiles >= 1
    got, kg, vg, _ = split_model(plan, *t, reps, nsh, **kw)
    own_plan = pa.decode_plan(B, C, Hq, Hkv, hd, bs, nb, torch.bfloat16)
    own, ko, vo, _ = split_model(own_plan, *t, **kw)
    # the same splits in the same order for every row: the paged model's values
    torch.testing.assert_close(got, own, atol=0, rtol=0)
    assert torch.equal(kg, ko) and torch.equal(vg, vo)
    treps, tnsh = torch.from_numpy(reps), torch.from_numpy(nsh)
    want, kw_p, _ = ppa.prefix_paged_attention_plain(*[x.clone() for x in t], treps, tnsh, is_global, **kw)
    torch.testing.assert_close(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert torch.equal(kg, kw_p)
    j_in = [jnp.asarray(a) for a in (q, kp, vp, tables, kn, vn, posn)]
    j_groups = (jnp.asarray(reps), jnp.asarray(nsh))
    j_out, j_k, _ = jref.prefix_paged_attention_ref(*j_in, *j_groups, is_global, **kw)
    p_out, p_k, _ = pallas_prefix(*j_in, *j_groups, is_global, interpret=True, **kw)
    for other in (j_out, p_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(kg.numpy()[1:], np.asarray(j_k)[1:])
    np.testing.assert_array_equal(kg.numpy(), np.asarray(p_k))
