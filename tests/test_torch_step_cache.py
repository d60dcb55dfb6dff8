"""The port's captured-step path (``repro_torch.serving.step_cache``) on the CPU.

Every serving step runs a ``StepGraph``: a body that reads static buffers,
fed from host mirrors before the step. On the CPU the bodies run eagerly;
here they also run under ``FakeGraph``, which stands in for
``torch.cuda.CUDAGraph`` (a capture runs the body once, its counts
recorded; a replay runs it again from the current buffers into the
captured output, its counts suspended, as a real replay does not pass
through the kernel wrappers). Held against the JAX engine on the same
bridged weights (reduced DeepSeekMoE-16B, float32): greedy tokens and
``EngineStats`` exactly, through ``run()``, ``serve_continuous()`` with the
prefix cache off and on, and a resident INT4 session under
``fixed_plan("TP1", "TP2", "EP2", mechanism="int4_upload")``; eager and
captured give the same tokens and the same dispatch counts. Also: the keys
a run makes and reuses, invalidation on a leaf install and on a new live
batch, the count accounting (a replay counts as the launches it replays; a
worker thread's launches during a capture still count), and
``capture_steps=True`` on the CPU raising.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core import HAPSession as JaxSession  # noqa: E402
from repro.core.hap import fixed_plan as jfixed_plan  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import HAPSession, fixed_plan  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models import init_cache, params_from_numpy, prefill  # noqa: E402
from repro_torch.serving import EngineStats, InferenceEngine, Request  # noqa: E402
from repro_torch.serving.step_cache import StepCache  # noqa: E402

PLAN = ("TP1", "TP2", "EP2")
SHARED = list(range(1, 21))
# the scenarios: requests (prompt, budget), engine keywords, how it is served
SCENARIOS = {
    # two static batches of one shape class: the second replays the prefill
    "run": ([([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), ([11, 12, 13], 6), (list(range(14, 30)), 6)],
            dict(max_batch=2), "run"),
    # tests/test_prefix_cache.py:326: chunks, fused steps, forks, groups
    "continuous_off": ([(SHARED + [40, 41], 6), (SHARED + [40, 41], 4), (SHARED + [40, 41], 4)],
                       dict(max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9), "continuous"),
    "continuous_on": ([(SHARED + [40, 41], 6), (SHARED + [40, 41], 4), (SHARED + [40, 41], 4)],
                      dict(max_batch=3, prefill_chunk=8, kv_block_size=8, kv_blocks=9, prefix_cache=True),
                      "continuous"),
    # a multi-chunk joiner while a row decodes: fused chunk + decode steps
    "continuous_fused": ([([3, 1, 4, 1, 5], 8), (list(range(1, 30)), 4)],
                         dict(max_batch=2, prefill_chunk=8, kv_block_size=8, prefix_cache=True), "continuous"),
    # resident INT4 through a session: async restores, leaf installs per batch
    "resident": ([([1, 2, 3, 4], 6), ([5, 6, 7, 8, 9, 10], 6), (list(range(11, 31)), 6)],
                 dict(max_batch=2, resident_int4=True, use_int4_transition=True), "session"),
}
# timings, and the port's own counter, are not compared with the JAX engine
NOT_COMPARED = ("transition_ms_total", "last_transition_ms", "restore_wait_ms", "restore_overlap_ms",
                "prefix_grouped_steps", "decode_step_ms_sum", "decode_step_ms_max", "reshard_bytes")


class FakeGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``."""

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        with _build.recording():
            self.out.copy_(self.fn())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _captured(eng):
    """Put ``eng``'s steps under the fake capturer (gens start anew)."""
    eng.steps = StepCache(eng.device, True, FakeGraph)
    return eng


def _port_engine(setup, how, kw, captured):
    _, cfg_t, _, tparams = setup
    if how == "session":
        ts = HAPSession(cfg_t, "a6000", 1, source=fixed_plan(*PLAN, mechanism="int4_upload"), prompt_bucket=16,
                        gen_bucket=8)
        eng = ts.engine(tparams, device="cpu", **kw)
    else:
        eng = InferenceEngine(cfg_t, tparams, device="cpu", **kw)
        if how == "continuous":
            eng.scheduler.bucket = 16
    return _captured(eng) if captured else eng


def _serve(eng, reqs, req_cls, how):
    for p, g in reqs:
        eng.submit(req_cls(prompt=p, max_new_tokens=g))
    return [c.tokens for c in (eng.serve_continuous() if how == "continuous" else eng.run())]


@pytest.fixture(scope="module")
def jax_runs(moe_setup):
    cfg_j, _, jparams, _ = moe_setup
    cache = {}

    def get(name):
        if name not in cache:
            reqs, kw, how = SCENARIOS[name]
            if how == "session":
                js = JaxSession(cfg_j, "a6000", 1, source=jfixed_plan(*PLAN, mechanism="int4_upload"),
                                prompt_bucket=16, gen_bucket=8)
                je = js.engine(jparams, **kw)
            else:
                je = JaxEngine(cfg_j, jparams, kernel_backend="ref", **kw)
                if how == "continuous":
                    je.scheduler.bucket = 16
            cache[name] = (_serve(je, reqs, JaxRequest, how), je.stats)
        return cache[name]

    return get


@pytest.fixture(scope="module")
def port_runs(moe_setup):
    cache = {}

    def get(name, captured):
        if (name, captured) not in cache:
            reqs, kw, how = SCENARIOS[name]
            eng = _port_engine(moe_setup, how, kw, captured)
            ops.reset_counts()
            toks = _serve(eng, reqs, Request, how)
            cache[name, captured] = (toks, eng, dict(ops.DISPATCH_COUNTS), dict(ops.LAUNCH_COUNTS))
            # what the steps looked like at the end (close() releases them)
            eng.keys_at_end, eng.static_at_end = eng.steps.keys(), eng._static and eng._static[0]
            eng.step_stats_at_end = dataclasses.replace(eng.steps.stats)
            eng.close()
        return cache[name, captured]

    return get


def _exact(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(EngineStats) if f.name not in NOT_COMPARED}


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_path_equals_jax(jax_runs, port_runs, name, captured):
    """Greedy tokens and ``EngineStats`` equal the JAX engine's, eager and
    under the fake capturer; the captured run's dispatch counts equal the
    eager run's (a replay counts as what it replays)."""
    want, jstats = jax_runs(name)
    got, eng, dispatch, launches = port_runs(name, captured)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in SCENARIOS[name][0]]
    assert _exact(eng.stats) == _exact(jstats)
    st = eng.step_stats_at_end
    if captured:
        assert st.captures > 0 and st.replays > 0
        _, _, eager_dispatch, eager_launches = port_runs(name, False)
        assert dispatch == eager_dispatch and launches == eager_launches == {}
    else:
        assert st.captures == st.replays == 0 and st.eager_runs > 0
    assert not any("hopper" in k for k in dispatch)


def test_static_keys_and_reuse(port_runs):
    """Two static batches of one shape class: one prefill and one decode
    graph, each run eagerly on its first sight, captured on its second and
    replayed from then on."""
    _, eng, _, _ = port_runs("run", True)
    keys = eng.keys_at_end
    assert sorted(k[0] for k in keys) == ["decode", "prefill"]
    B, S, max_len = 2, 64, 64 + 6 + 1  # the sessionless 64-token bucket
    assert ("prefill", None, B, S, max_len, 0, "static", 1) in keys
    assert ("decode", None, B, max_len, 0, "static", 1) in keys
    st = eng.step_stats_at_end
    # batch 1: prefill and decode step 1 eager, decode step 2 captured and
    # replayed, steps 3-5 replayed; batch 2: prefill captured and replayed,
    # decode steps 1-5 replayed
    assert (st.eager_runs, st.captures, st.replays, st.dropped) == (2, 2, 4 + 1 + 5, 0)
    assert eng.static_at_end == (B, max_len)
    # close() releases the graphs and the cache
    assert len(eng.steps) == 0 and eng._static is None


def test_static_cache_is_replaced_when_the_shape_changes(moe_setup):
    """Output budgets of 3, 5 and 7 tokens give three max_len: each batch
    replaces the one static cache and drops its graphs, so the engine holds
    one cache and at most two graphs whatever the traffic; each budget's
    tokens equal a fresh engine's."""
    prompts = ([1, 2, 3], [4, 5, 6])
    eng = _port_engine(moe_setup, "run", dict(max_batch=2), True)
    for i, new in enumerate((3, 5, 7, 3, 3)):
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=new))
        got = [c.tokens for c in eng.run()]
        fresh = _port_engine(moe_setup, "run", dict(max_batch=2), False)
        assert got == _serve(fresh, [(p, new) for p in prompts], Request, "run")
        assert eng._static[0] == (2, 64 + new + 1)
        assert len(eng.steps) == 2 and {k[-1] for k in eng.steps.keys()} == {min(i, 3) + 1}
    # the 4th batch replaced the 7-token cache; the 5th reused the 4th's
    assert eng.steps.stats.dropped == 2 * 3 and eng.steps.cache_gen["static"] == 4
    eng.close()
    assert len(eng.steps) == 0 and eng._static is None


@pytest.mark.parametrize("name", ["continuous_off", "continuous_on", "continuous_fused"])
def test_continuous_keys_and_generation(moe_setup, name):
    """A continuous run keys its chunk, fused and paged-decode steps by
    chunk length, slot count, table width and the prefix cache, under the
    live batch's cache generation; the live batch's end drops them."""
    reqs, kw, _ = SCENARIOS[name]
    pfx = bool(kw.get("prefix_cache"))
    eng = _port_engine(moe_setup, "continuous", kw, True)
    seen = []
    new_cache = eng.steps.new_cache

    def spy(cache):
        graphs = {k: (g.eager_runs, g.graph is not None) for k, g in eng.steps._graphs.items()}
        seen.append((cache, eng.steps.cache_gen[cache], graphs))
        new_cache(cache)

    eng.steps.new_cache = spy
    _serve(eng, reqs, Request, "continuous")
    assert [(c, gen) for c, gen, _ in seen] == [("live", 0), ("live", 1)]  # the batch begins, then ends
    graphs = seen[1][2]
    keys = list(graphs)
    assert len(eng.steps) == 0 and eng.steps.stats.dropped == len(keys)
    # each step ran eagerly once; those that ran again were captured then
    assert all(runs == 1 for runs, _ in graphs.values())
    assert sum(c for _, c in graphs.values()) == eng.steps.stats.captures > 0
    n, mb = kw["max_batch"], 6  # the widest need, 32 + 6 + 1 positions, in 8-token blocks
    assert ("chunk", None, 8, n, mb, 0, "live", 1) in keys
    assert ("paged_decode", None, n, mb, pfx, 0, "live", 1) in keys
    fused = ("fused", None, 8, n, mb, pfx, 0, "live", 1)
    assert (fused in keys) == (eng.stats.fused_steps > 0) == (name == "continuous_fused")
    # the followers of continuous_on skip 31 of 32 positions: a 1-token chunk
    assert {k[2] for k in keys if k[0] == "chunk"} == ({8, 1} if name == "continuous_on" else {8})
    assert all(k[-3:] == (0, "live", 1) for k in keys)
    assert eng.steps.stats.replays > 0


def test_leaf_install_drops_graphs(moe_setup):
    """Installing expert leaves bumps the weights generation and drops
    every graph; the steps are captured anew and read the new leaves."""
    eng = _port_engine(moe_setup, "run", dict(max_batch=2), True)
    for p in ([1, 2, 3], [4, 5, 6]):
        eng.submit(Request(prompt=p, max_new_tokens=4))
    first = [c.tokens for c in eng.run()]
    assert len(eng.steps) == 2 and eng.steps.weights_gen == 0
    moe = eng.params["layers"]["moe"]
    eng._set_expert_leaves({n: moe[n].clone() for n in ("wi_gate", "wi_up", "wo")})
    assert len(eng.steps) == 0 and eng.steps.weights_gen == 1 and eng.steps.stats.dropped == 2
    for p in ([1, 2, 3], [4, 5, 6]):
        eng.submit(Request(prompt=p, max_new_tokens=4))
    assert [c.tokens for c in eng.run()] == first
    # each run: the prefill runs once (eager), decode step 2 is captured
    assert all(k[-3] == 1 for k in eng.steps.keys()) and eng.steps.stats.captures == 2
    # zeroed down-projections: the routed experts add nothing any more
    eng._set_expert_leaves({"wo": torch.zeros_like(moe["wo"])})
    for p in ([1, 2, 3], [4, 5, 6]):
        eng.submit(Request(prompt=p, max_new_tokens=4))
    cold = InferenceEngine(eng.cfg, eng.params, device="cpu", max_batch=2)
    for p in ([1, 2, 3], [4, 5, 6]):
        cold.submit(Request(prompt=p, max_new_tokens=4))
    assert [c.tokens for c in eng.run()] == [c.tokens for c in cold.run()]


@pytest.mark.parametrize("runs", [1, 2, 5])
def test_replays_add_the_recorded_counts(runs):
    """The first run is eager and counts as it launches; the second captures
    (the capture records and adds nothing) and replays; each replay adds
    the recorded launches, variants, shapes and dispatches; a worker
    thread's launch during the capture counts at once."""
    steps = StepCache("cpu", True, FakeGraph)
    worker_launches = []

    def body(g):
        _build.count_launch("paged_attention", "split")
        _build.count_launch("grouped_matmul", "wgmma", (68, 8, 16, 32))
        _build.count_launch("grouped_matmul", "wgmma", (68, 8, 32, 16))
        ops.record("decode.hopper")
        if steps.stats.captures == 0 and _build._capturing.__dict__.get("counts") is not None:
            t = threading.Thread(target=lambda: (_build.count_launch("int4_dequant"), worker_launches.append(1)))
            t.start()
            t.join()
        return g.bufs["x"] * 2

    g = steps.graph(("decode", None, 1), lambda: steps.buffers(x=((3,), torch.float32)), body, "static")
    ops.reset_counts()
    outs = []
    for i in range(runs):
        g.feed("x", np.arange(3) + i)
        outs.append(steps.run(g).clone())
    assert dict(ops.LAUNCH_COUNTS) == {"paged_attention": runs, "grouped_matmul": 2 * runs,
                                       **({"int4_dequant": 1} if worker_launches else {})}
    assert dict(_build.VARIANT_COUNTS) == {("paged_attention", "split"): runs, ("grouped_matmul", "wgmma"): 2 * runs}
    assert dict(_build.SHAPE_COUNTS) == {("grouped_matmul", (68, 8, 16, 32)): runs,
                                         ("grouped_matmul", (68, 8, 32, 16)): runs}
    assert dict(ops.DISPATCH_COUNTS) == {"decode.hopper": runs}
    assert worker_launches == ([1] if runs > 1 else [])
    assert (steps.stats.eager_runs, steps.stats.captures, steps.stats.replays) == (1, int(runs > 1), runs - 1)
    if runs > 1:
        assert dict(g.counts.launches) == {"paged_attention": 1, "grouped_matmul": 2}
    else:
        assert g.graph is None and g.counts is None
    for i, out in enumerate(outs):
        assert out.tolist() == [2.0 * (j + i) for j in range(3)]


def test_no_capture_while_a_restore_is_in_flight():
    """``may_capture=False`` runs the body eagerly and leaves the step
    uncaptured; the next allowed run captures it."""
    steps = StepCache("cpu", True, FakeGraph)
    g = steps.graph(("prefill", None, 1), lambda: steps.buffers(x=((2,), torch.float32)), lambda g: g.bufs["x"] + 1,
                    "static")
    for runs in (1, 2):
        steps.run(g, may_capture=False)
        assert g.graph is None and steps.stats.eager_runs == runs
    steps.run(g)
    assert g.graph is not None and steps.stats.captures == 1


def test_garbage_collector_paused_during_capture():
    """A collection on the capturing thread could destroy a dropped CUDA
    graph inside the capture, which its ``thread_local`` mode forbids: the
    cyclic collector is off while a step is captured, and back on after,
    also when the capture fails."""
    import gc

    seen = []

    class Spy(FakeGraph):
        def capture(self, fn):
            seen.append(gc.isenabled())
            return super().capture(fn)

    class Broken(FakeGraph):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    assert gc.isenabled()
    for factory in (Spy, Broken):
        steps = StepCache("cpu", True, factory)
        g = steps.graph(("decode", None, 1), lambda: steps.buffers(x=((2,), torch.float32)),
                        lambda g: g.bufs["x"] + 1, "static")
        steps.run(g)
        if factory is Spy:
            steps.run(g)
        else:
            with pytest.raises(RuntimeError, match="capture failed"):
                steps.run(g)
        assert gc.isenabled()
    assert seen == [False]


def test_capture_error_raises():
    """A capture that fails raises; the step stays uncaptured (no eager
    retry hides it). The first run is eager and does not capture."""

    class Broken(FakeGraph):
        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    steps = StepCache("cpu", True, Broken)
    g = steps.graph(("decode", None, 1), lambda: steps.buffers(x=((2,), torch.float32)), lambda g: g.bufs["x"] + 1,
                    "static")
    assert steps.run(g).tolist() == [1.0, 1.0]
    with pytest.raises(RuntimeError, match="capturing"):
        steps.run(g)
    assert g.graph is None and steps.stats.captures == 0 and steps.stats.eager_runs == 1


def test_capture_steps_true_on_the_cpu_raises(moe_setup):
    _, cfg_t, _, tparams = moe_setup
    with pytest.raises(ValueError, match="capture_steps"):
        InferenceEngine(cfg_t, tparams, device="cpu", capture_steps=True)
    assert not InferenceEngine(cfg_t, tparams, device="cpu").steps.capture
    assert not InferenceEngine(cfg_t, tparams, device="cpu", capture_steps=False).steps.capture


def test_prefill_fills_the_given_cache(moe_setup):
    """``prefill`` into a caller's cache gives the logits and K/V of a fresh
    one, keeps the cache's storage, sets its device ``pos``, and refuses a
    cache of another shape."""
    _, cfg_t, _, tparams = moe_setup
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, cfg_t.vocab_size, (2, 12)))
    want, fresh = prefill(tparams, cfg_t, {"tokens": toks}, 20)
    cache = init_cache(cfg_t, 2, 20, dtype=torch.float32)
    cache.k.fill_(7.0)  # a previous batch's entries past the prompt stay
    ptr = cache.k.data_ptr()
    got, out = prefill(tparams, cfg_t, {"tokens": toks}, 20, cache=cache)
    assert out is cache and cache.k.data_ptr() == ptr
    assert torch.equal(got, want)
    assert torch.equal(cache.k[:, :, :12], fresh.k[:, :, :12]) and torch.equal(cache.v[:, :, :12], fresh.v[:, :, :12])
    assert cache.pos.ndim == 0 and cache.pos.dtype == torch.int32 and int(cache.pos) == 12
    with pytest.raises(ValueError, match="contiguous cache"):
        prefill(tparams, cfg_t, {"tokens": toks}, 24, cache=cache)
