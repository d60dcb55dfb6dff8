"""The port's paged decode and continuous engine against the JAX package.

On the same bridged weights of the reduced DeepSeekMoE-16B
(``capacity_factor=8.0``, so no token is dropped and rows cannot couple), in
float32 on the CPU: ``decode_step`` with per-row positions over a paged
cache gives the JAX logits at 1e-4, a chunked append through a row's table
gives the prefill logits, and ``serve_continuous`` gives exactly the JAX
engine's greedy tokens and the same ``EngineStats`` counters in the
scenarios of ``tests/test_continuous.py``, ``tests/test_kv_cache.py`` and
``tests/test_prefix_cache.py`` (both engines without a session, with the
same 16-token prompt bucket). The paths not ported yet raise
``NotImplementedError``; the robustness knobs raise the reference's
``ValueError``s on bad values and without the paged path, and deadlines
and cancels are served.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_paged_cache as jinit_paged_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decode_step, init_paged_cache, params_from_numpy, prefill  # noqa: E402
from repro_torch.serving import EngineStats, FaultInjector, InferenceEngine, Request, SamplingParams  # noqa: E402
from repro_torch.serving.kv_cache import BlockAllocator, BlockTable  # noqa: E402
from repro_torch.sharding.specs import ShardingPlan  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def moe_setup():
    cfg_j = reduced("deepseek-moe-16b", capacity_factor=8.0)
    cfg_t = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the paged model step
# ---------------------------------------------------------------------------
def test_paged_per_row_decode_matches_jax(moe_setup):
    """Two rows of different prompt lengths appended chunk by chunk at
    their own positions, then decoded per row over a shared block pool, in
    both frameworks (tests/test_kv_cache.py:157 over chunked appends)."""
    cfg_j, cfg_t, jparams, tparams = moe_setup
    bs, nb, N = 4, 6, 13
    tables = np.zeros((2, nb), np.int32)
    tables[0, :5] = [3, 1, 7, 9, 11]  # scattered pages; 0 is the trash page
    tables[1, :4] = [2, 4, 6, 12]
    jc = jinit_paged_cache(cfg_j, 2, N, bs, nb, dtype=jnp.float32)
    jc = jc._replace(block_tables=jnp.asarray(tables))
    tc = init_paged_cache(cfg_t, 2, N, bs, nb, dtype=torch.float32)
    assert tuple(tc.k.shape) == jc.k.shape and tuple(tc.block_tables.shape) == jc.block_tables.shape
    tc.block_tables = torch.from_numpy(tables)
    rng = np.random.default_rng(7)
    chunks = rng.integers(1, cfg_t.vocab_size, (2, 10)).astype(np.int32)
    for lo, hi in ((0, 6), (6, 10)):  # two chunks, the second straddles a page
        jl, jc = jdecode_step(jparams, cfg_j, jnp.asarray(chunks[:, lo:hi]), jc)
        tl, tc = decode_step(tparams, cfg_t, torch.from_numpy(chunks[:, lo:hi]).long(), tc)
        _close(tl, jl)
    # rows at different depths from here on
    pos = np.array([10, 7], np.int32)
    jc, tc.pos = jc._replace(pos=jnp.asarray(pos)), torch.from_numpy(pos.copy())
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(4):
        jl, jc = jdecode_step(jparams, cfg_j, jnp.asarray(tok)[:, None], jc)
        tl, tc = decode_step(tparams, cfg_t, torch.from_numpy(tok).long()[:, None], tc)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [14, 11]
    live = sorted(set(tables.ravel()) - {0})
    _close(tc.k[:, live], np.asarray(jc.k)[:, live])
    _close(tc.v[:, live], np.asarray(jc.v)[:, live])


@pytest.mark.parametrize("splits", [(4, 4, 4), (5, 7), (3, 6, 3)])
def test_chunked_append_matches_prefill(moe_setup, splits):
    """A prompt fed through a row's block table in uneven chunks gives the
    whole-prompt prefill logits of both frameworks (tests/test_kv_cache.py:180)."""
    cfg_j, cfg_t, jparams, tparams = moe_setup
    toks = np.arange(1, 13, dtype=np.int32).reshape(1, 12)
    want, _ = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(toks)}, max_len=12)
    own, _ = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks).long()}, 12)
    alloc = BlockAllocator(6, block_size=4)
    table = BlockTable(alloc, budget_tokens=16)
    table.ensure_tokens(12)
    cache = init_paged_cache(cfg_t, 1, 6, 4, 4, dtype=torch.float32)
    cache.block_tables = torch.from_numpy(table.padded(4)[None, :])
    off = 0
    for n in splits:
        logits, cache = decode_step(tparams, cfg_t, torch.from_numpy(toks[:, off : off + n]).long(), cache)
        off += n
    _close(logits, want)
    _close(logits, own)
    assert cache.pos.tolist() == [12]


# ---------------------------------------------------------------------------
# serve_continuous, token for token against the JAX engine
# ---------------------------------------------------------------------------
SHARED = list(range(1, 21))  # 20 tokens: padded to 32 at bucket 16
ENGINE_CASES = {
    # tests/test_continuous.py:94: mid-stream joins, mixed output budgets
    "midstream_joins": (
        [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], 8), ([2, 7, 1, 8, 2, 8], 3), ([1, 1, 2, 3, 5, 8, 13, 2, 1, 4, 7, 11], 6)],
        dict(max_batch=2),
    ),
    # tests/test_continuous.py:174: chunked prefill, chunks straddle blocks
    "chunked_prefill": ([(list(range(1, 40)), 6), ([2, 7, 1, 8], 5)], dict(max_batch=2, prefill_chunk=8, kv_block_size=8)),
    # tests/test_kv_cache.py:255: a pool of one request's worth
    "tiny_pool": (
        [([1, 2, 3, 4], 6), ([9, 8, 7], 6), ([2, 4, 6, 8, 1], 4)],
        dict(max_batch=3, kv_block_size=8, kv_blocks=4),
    ),
    # tests/test_prefix_cache.py:326: a donor and two identical followers
    "prefix_off": ([(SHARED + [40, 41], 6), (SHARED + [40, 41], 4), (SHARED + [40, 41], 4)],
                   dict(max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9)),
    "prefix_on": ([(SHARED + [40, 41], 6), (SHARED + [40, 41], 4), (SHARED + [40, 41], 4)],
                  dict(max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9, prefix_cache=True)),
}


# the port's own measurement counters, which the JAX engine does not keep
PORT_ONLY_STATS = ("prefix_grouped_steps", "decode_step_ms_sum", "decode_step_ms_max", "reshard_bytes")


@pytest.fixture(scope="module")
def served(moe_setup):
    """Each scenario served once by each engine: name -> (jax tokens, jax
    stats, port tokens, port stats, port dispatch counts)."""
    cfg_j, cfg_t, jparams, tparams = moe_setup
    cache = {}

    def serve(name):
        if name not in cache:
            reqs, kw = ENGINE_CASES[name]
            je = JaxEngine(cfg_j, jparams, kernel_backend="ref", **kw)
            te = InferenceEngine(cfg_t, tparams, device="cpu", **kw)
            je.scheduler.bucket = te.scheduler.bucket = 16
            for p, g in reqs:
                je.submit(JaxRequest(prompt=p, max_new_tokens=g))
                te.submit(Request(prompt=p, max_new_tokens=g))
            want = [c.tokens for c in je.serve_continuous()]
            ops.reset_counts()
            got = [c.tokens for c in te.serve_continuous()]
            cache[name] = (want, je.stats, got, te.stats, dict(ops.DISPATCH_COUNTS), te)
        return cache[name]

    return serve


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_serve_continuous_matches_jax(served, name):
    want, jstats, got, tstats, dispatch, eng = served(name)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in ENGINE_CASES[name][0]]
    fields = [f.name for f in dataclasses.fields(EngineStats) if f.name not in PORT_ONLY_STATS]
    assert {f: getattr(tstats, f) for f in fields} == {f: getattr(jstats, f) for f in fields}
    assert tstats.batches == 1 and tstats.joins == len(got)
    assert (tstats.prefix_grouped_steps > 0) == (name == "prefix_on")
    assert tstats.decode_step_ms_max > 0 and tstats.decode_step_ms_sum >= tstats.decode_step_ms_max
    assert eng._live is None  # fully drained
    assert not any("hopper" in k for k in dispatch)
    assert ("decode.ref_prefix" in dispatch) == (name == "prefix_on")


def test_prefix_cache_shares_and_stays_token_exact(served):
    """Both followers adopt the donor's 4 prompt blocks, skip 31 positions
    each and fork the partly shared tail once; the tokens equal the run with
    the cache off."""
    _, _, off, _, _, _ = served("prefix_off")
    _, _, on, st, dispatch, _ = served("prefix_on")
    assert on == off
    assert (st.prefix_hit_blocks, st.prefix_hit_tokens, st.cow_copies) == (8, 62, 2)
    assert st.effective_block_need < st.raw_block_need
    assert dispatch["decode.ref_prefix"] > 0


def test_engine_mirrors_and_groups(moe_setup):
    """A follower joins a prefix group only once its first chunk has put
    its blocks in the host mirror; the group's first sharer is its
    representative, the others share its leading blocks."""
    _, cfg_t, _, tparams = moe_setup
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=3, prefill_chunk=8, kv_block_size=8,
                          kv_blocks=12, prefix_cache=True)
    eng.scheduler.bucket = 16
    prompt = SHARED + [40, 41]
    eng.submit(Request(prompt=prompt, max_new_tokens=3))
    eng._begin_live_batch()
    live = eng._live
    assert eng.admit() == [0]
    while live.slots[0].prefilling:
        eng.step(SamplingParams())  # the donor's prompt, then registered
    for _ in range(2):
        eng.submit(Request(prompt=prompt, max_new_tokens=3))
    assert eng.admit() == [1, 2]
    assert (live.tables[1:] == 0).all()  # adopted, but not mirrored yet
    np.testing.assert_array_equal(eng._prefix_group_arrays(), [[0, 1, 2], [0, 0, 0]])
    eng.step(SamplingParams())  # follower 1's one chunk: forks the tail block
    np.testing.assert_array_equal(eng._prefix_group_arrays(), [[0, 1, 2], [0, 0, 0]])
    eng.step(SamplingParams())  # follower 2's
    np.testing.assert_array_equal(eng._prefix_group_arrays(), [[0, 1, 1], [0, 0, 3]])
    assert live.tables[1, :3].tolist() == live.tables[2, :3].tolist() == live.slots[0].table.blocks[:3]
    assert live.tables[1, 3] != live.tables[2, 3]
    assert eng.stats.cow_copies == 2


@pytest.mark.parametrize(
    "kw,err",
    [
        (dict(paged=False, kv_overcommit=0.5), ValueError),  # overcommit needs the paged path
        (dict(paged=False, prefix_cache=True), ValueError),
        (dict(kv_overcommit=1.5), ValueError),
        (dict(faults=lambda: FaultInjector().fail("nope")), ValueError),
        # a data axis serves (ROADMAP A.9): no error
        (dict(max_batch=4, plan=ShardingPlan(mesh=types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2}, rank=0, size=2, capturable=False,
            axis_index=lambda axes: 1), dp_axes=("data",))), None),
        (dict(replicate_experts=-1), ValueError),
        (dict(prefetch=True, prefetch_top_p=0.0), ValueError),
        (dict(kv_block_size=0), ValueError),
    ],
)
def test_unported_and_invalid_options_raise(moe_setup, kw, err):
    _, cfg_t, _, tparams = moe_setup
    if err is None:  # served: data rank 1 of the (2, 2) stand-in computes slots [2, 4); 3 slots run whole
        eng = InferenceEngine(cfg_t, tparams, device="cpu", **kw)
        plan, lo, hi = eng._rows("decode", eng.scheduler.max_batch)
        assert (plan.dp_axes, lo, hi) == (("data",), 2, 4)
        assert eng._rows("decode", 3)[0].dp_axes == () and eng._rows("decode", 3)[1:] == (0, 3)
        return
    with pytest.raises(err, match="paged|positive|>= 0|top_p|kv_overcommit|unknown fault site"):
        kw = {k: v() if callable(v) else v for k, v in kw.items()}
        InferenceEngine(cfg_t, tparams, device="cpu", **kw)


def test_deadlines_and_cancel_raise(moe_setup):
    """Deadlines and cancels are accepted and reaped (they raised before
    the robustness layer was ported): a request past its deadline, one
    cancelled while queued, and one still within its deadline, served
    against the JAX engine's tokens and counters. Unknown uids are not
    cancelled."""
    _, cfg_t, _, tparams = moe_setup
    eng = InferenceEngine(cfg_t, tparams, device="cpu", max_batch=2)
    jeng = JaxEngine(moe_setup[0], moe_setup[2], max_batch=2)
    for e, R in ((eng, Request), (jeng, JaxRequest)):
        e.scheduler.bucket = 16
        t = [0.0]
        e.clock = lambda t=t: t[0]
        e.submit(R(prompt=[1, 2], max_new_tokens=3, deadline_ms=5.0))
        e.submit(R(prompt=[3, 4, 5], max_new_tokens=3))
        e.submit(R(prompt=[6], max_new_tokens=3, deadline_ms=5e3))
        assert e.cancel(1) and not e.cancel(7)
        t[0] = 1.0
    got = [(c.uid, c.tokens, c.status) for c in eng.serve_continuous()]
    assert got == [(c.uid, c.tokens, c.status) for c in jeng.serve_continuous()]
    assert [c[2] for c in got] == ["deadline", "cancelled", "ok"] and len(got[2][1]) == 3
    assert (eng.stats.deadline_expired, eng.stats.cancelled) == (jeng.stats.deadline_expired, jeng.stats.cancelled)
    assert (eng.stats.deadline_expired, eng.stats.cancelled) == (1, 1)
