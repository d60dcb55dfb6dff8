"""The dry run's traces (``repro_torch.launch.dryrun``) on the CPU.

- The five hand kernels' wrappers on fake CUDA tensors: their plain
  versions' output shapes and dtypes, nothing built or launched, the call
  recorded by shape and its work tallied; on a real CPU tensor the
  ``hopper`` seam still raises.
- Fake against real: a 2-layer reduced model traced on a fake (2, 2) group
  gives each rank the output shapes, collective calls and payload bytes of
  a real four-rank gloo run of the same plan (prefill, decode, a train
  step).
- The probe's count: on a model whose layers are alike, a step's trace is
  the work outside the layers plus one probe a layer, exactly.
- One full-width trace: DeepSeekMoE-16B ``decode_32k`` on the 16x16 mesh,
  in seconds, without allocating its 5 GiB.

The file imports nothing of JAX: the gloo ranks import it.
"""

import dataclasses
import os
import resource
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import int4_dequant as dq  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefix_paged_attention as ppa  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh, release_fake_mesh  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
# (seq, global batch) of each step of the fake-against-real comparison
CASES = {"prefill": (16, 4), "decode": (32, 4), "train": (16, 4)}


@pytest.fixture(scope="module", autouse=True)
def _release_group():
    """The fake default group does not outlive this file."""
    yield
    release_fake_mesh()


@pytest.fixture
def no_build(monkeypatch):
    """Building or loading the kernel library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was built or loaded")

    for name in ("build", "library", "_nvcc"):
        monkeypatch.setattr(_build, name, refuse)
    monkeypatch.setattr(torch.cuda, "get_device_capability", refuse)
    ops.reset_counts()
    yield
    ops.reset_counts()


def _wrapper_cases():
    """(kernel, shape key, fn(device) -> the wrapper's result on tensors made
    there, plain(tensors) -> the plain version's, work)."""
    bf = torch.bfloat16

    def flash(dev, plain=False):
        q, k, v = (torch.empty((2, h, 64, 64), dtype=bf, device=dev) for h in (4, 2, 2))
        return (fa.flash_attention_plain if plain else fa.flash_attention)(q, k, v, window=16, softcap=0.0)

    def paged_args(dev):
        return (torch.zeros((2, 3, 4, 64), dtype=bf, device=dev), torch.zeros((5, 16, 2, 64), dtype=bf, device=dev),
                torch.zeros((5, 16, 2, 64), dtype=bf, device=dev),
                torch.tensor([[1, 2], [3, 4]], dtype=torch.int32) if dev == "cpu" else
                torch.zeros((2, 2), dtype=torch.int32, device=dev),
                torch.zeros((2, 3, 2, 64), dtype=bf, device=dev), torch.zeros((2, 3, 2, 64), dtype=bf, device=dev),
                torch.zeros((2,), dtype=torch.int32, device=dev))

    def paged(dev, plain=False):
        return (pa.paged_attention_plain if plain else pa.paged_attention)(*paged_args(dev))

    def prefix(dev, plain=False):
        groups = (torch.zeros((2,), dtype=torch.int32, device=dev), torch.zeros((2,), dtype=torch.int32, device=dev))
        return (ppa.prefix_paged_attention_plain if plain else ppa.prefix_paged_attention)(*paged_args(dev), *groups)

    def gmm(dev, plain=False):
        lhs, rhs = torch.zeros((3, 8, 64), dtype=bf, device=dev), torch.zeros((3, 64, 32), dtype=bf, device=dev)
        return (gm.grouped_matmul_plain if plain else gm.grouped_matmul)(lhs, rhs)

    def dequant(dev, plain=False):
        packed = torch.zeros((4, 32), dtype=torch.uint8, device=dev)
        s, z = (torch.ones((4, 1), dtype=torch.float32, device=dev) for _ in range(2))
        return dq.int4_dequant_plain(packed, s, z, bf) if plain else dq.int4_dequant(packed, s, z, out_dtype=bf)

    return [
        ("flash_attention", (2, 64, 4, 2, 64, 16, 0.0), flash, fa.work(2, 4, 2, 64, 64, 64, 2, True, 16)),
        ("paged_attention", (2, 3, 4, 2, 64), paged, pa.work(2, 3, 4, 2, 64, 32, 2)),
        ("prefix_paged_attention", (2, 3, 4, 2, 64), prefix, pa.work(2, 3, 4, 2, 64, 32, 2)),
        ("grouped_matmul", (3, 8, 64, 32), gmm, gm.work(3, 8, 64, 32, 2)),
        ("int4_dequant", (4, 64, "bfloat16"), dequant, dq.work(4, 64, 2)),
    ]


def _meta(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return tuple(_meta(t) for t in tree)


@pytest.mark.parametrize("case", _wrapper_cases(), ids=lambda c: c[0])
def test_wrappers_on_fake_tensors_build_nothing_and_tally(no_build, case):
    """Each wrapper on fake CUDA tensors returns its plain version's shapes
    and dtypes, builds and launches nothing, records the call under the
    shape its launch would have, and tallies its FLOPs and bytes."""
    name, key, fn, (flops, nbytes) = case
    want = _meta(fn("cpu", plain=True))
    with roofline.fake_tensors():
        got = fn("cuda")
        assert all(_build.is_fake(t) and t.device.type == "cuda" for t in (got if isinstance(got, tuple) else (got,)))
        got = _meta(got)
    assert got == want
    assert dict(_build.SHAPE_COUNTS) == {(name, key): 1} and not _build.LAUNCH_COUNTS
    assert (_build.TRACED_CALLS[name], _build.TRACED_FLOPS[name], _build.TRACED_BYTES[name]) == (1, flops, nbytes)


def test_the_seam_takes_fake_cuda_tensors_to_hopper_and_still_refuses_real_ones(no_build):
    """Under a fake mode the seam resolves a CUDA tensor to ``hopper``
    without asking the card (the target is the H100); on a real CPU tensor
    ``hopper`` raises, and outside a fake mode the card is asked (none here)."""
    with roofline.fake_tensors():
        q = torch.empty((1, 2, 8, 16), device="cuda")
        assert ops.resolve_backend(None, q.device) is ops.KernelBackend.HOPPER
        ops.attention(q, q, q)
    assert _build.TRACED_CALLS["flash_attention"] == 1 and ops.DISPATCH_COUNTS["attention.hopper"] == 1
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="hopper backend runs on CUDA"):
        ops.attention(q, q, q, backend="hopper")
    with pytest.raises(AssertionError, match="built or loaded"):
        ops.resolve_backend("hopper", "cuda")


def test_flash_work_counts_the_causal_window():
    """``work``'s pairs against a count of every (query, valid key)."""
    for S, win in ((64, 0), (64, 16), (5, 9), (33, 1)):
        pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
        assert fa.work(1, 1, 1, S, S, 1, 2, True, win)[0] == 4 * pairs
    assert fa.work(1, 1, 1, 4, 10, 1, 2, True, 0)[0] == 4 * sum(range(7, 11))
    assert fa.work(1, 1, 1, 4, 10, 1, 2, False, 0)[0] == 4 * 40


def test_a_float8_cache_is_refused_by_the_paged_kernel_as_on_the_card():
    """``--kv-dtype float8_e4m3fn``: the paged kernel takes bfloat16 or
    float32 caches, so the hopper trace refuses the cache; ``--kernel-backend
    ref`` traces it."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16", kv_cache_dtype="float8_e4m3fn")
    mesh = make_fake_mesh(2, 2, 0)
    plan = _plan(mesh, cfg, "decode", 4)
    with pytest.raises(ValueError, match="one dtype"):
        dryrun.trace(cfg, 32, 4, "decode", mesh, plan)
    res = dryrun.trace(cfg, 32, 4, "decode", mesh, plan, backend="ref")
    assert res.step.args[2].k.dtype == torch.float8_e4m3fn and res.out_shapes[0] == (2, cfg.vocab_size)


# -- fake against real ----------------------------------------------------------
def _cfg(layers: int = 2):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b").reduced(), num_layers=layers, dtype="float32")


def _plan(mesh, cfg, kind, batch):
    from repro_torch.sharding.specs import adapt_plan_for_batch, make_plan

    return adapt_plan_for_batch(make_plan(mesh, cfg), cfg, batch, kind)


def _real_step(mesh, cfg, kind, seq, batch):
    """One rank's step on real CPU tensors: (output shapes, collective
    calls, payload bytes)."""
    import collections

    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainState, make_train_step

    plan, rows = dryrun.rank_rows(_plan(mesh, cfg, kind, batch), batch, kind)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu", shard=(plan, mesh.coords))
    tok = torch.randint(0, cfg.vocab_size, (rows, seq if kind != "decode" else 1), generator=g, dtype=torch.int32)
    calls, payload = collections.Counter(mesh.calls), collections.Counter(mesh.payload)
    if kind == "prefill":
        with torch.no_grad():
            out = prefill(params, cfg, {"tokens": tok}, max_len=seq, backend="ref", plan=plan)
    elif kind == "decode":
        cache = init_cache(cfg, rows, seq, dtype=torch.float32, device="cpu", plan=plan)
        calls, payload = collections.Counter(mesh.calls), collections.Counter(mesh.payload)
        with torch.no_grad():
            out = decode_step(params, cfg, tok, cache, backend="ref", plan=plan)
    else:
        state = TrainState(params, adamw_init(params))
        out = make_train_step(cfg, plan)(state, {"tokens": tok, "labels": tok})
    done_calls, done_payload = collections.Counter(mesh.calls), collections.Counter(mesh.payload)
    done_calls.subtract(calls)
    done_payload.subtract(payload)
    return (dryrun._shapes(out), {k: v for k, v in done_calls.items() if v},
            {k: v for k, v in done_payload.items() if v})


def real_rank(mesh):
    """A gloo rank's steps on the (2, 2) mesh of the four ranks
    (``repro_torch.sharding.launch`` target)."""
    from repro_torch.sharding.mesh import RankMesh

    grid, cfg = RankMesh(None, data=2), _cfg()
    return {kind: _real_step(grid, cfg, kind, seq, batch) for kind, (seq, batch) in CASES.items()}


def test_fake_group_traces_what_real_ranks_run(tmp_path):
    """Each rank of a fake (2, 2) group against the same rank of four gloo
    processes: the same output shapes, collective calls and payload bytes,
    for prefill, a decode step and a train step (float32, TP-heads
    attention and EP experts over the model axis, two data rows)."""
    from repro_torch.sharding.launch import spawn

    real = spawn("test_torch_dryrun:real_rank", 4, backend="gloo", pythonpath=(TESTS,), workdir=str(tmp_path),
                 env={"OMP_NUM_THREADS": "1"}, timeout=300)
    cfg = _cfg()
    for rank in range(4):
        mesh = make_fake_mesh(2, 2, rank)
        assert mesh.coords == {"data": rank // 2, "model": rank % 2}
        for kind, (seq, batch) in CASES.items():
            res = dryrun.trace(cfg, seq, batch, kind, mesh, _plan(mesh, cfg, kind, batch))
            shapes, calls, payload = real[rank][kind]
            assert (res.out_shapes, res.calls, res.payload) == (shapes, calls, payload), (rank, kind)
            assert calls and payload  # the plan exchanges something in every step


# -- the probe's count ----------------------------------------------------------
@pytest.mark.parametrize("kind", list(CASES))
def test_a_step_is_the_outer_work_plus_one_probe_a_layer(kind):
    """DeepSeek reduced has alike layers (every one MoE, global attention):
    the trace at 2 layers less the trace at 1 is one probe, exactly, in
    FLOPs and collective calls, and for the serving steps in wire bytes (a
    train step's gradient all-reduce, one a stacked leaf, grows with the
    layers; the reference's probe leaves the update out too)."""
    seq, batch = CASES[kind]
    mesh = make_fake_mesh(2, 2, 1)
    two = dryrun.trace(_cfg(2), seq, batch, kind, mesh, _plan(mesh, _cfg(2), kind, batch), probe=True)
    one = dryrun.trace(_cfg(1), seq, batch, kind, mesh, _plan(mesh, _cfg(1), kind, batch))
    layer = two.layer
    assert two.costs.flops - one.costs.flops == layer.costs.flops > 0
    calls = {k: two.calls.get(k, 0) - one.calls.get(k, 0) for k in set(two.calls) | set(one.calls)}
    assert {k: v for k, v in calls.items() if v} == layer.calls
    for k in roofline.COLLECTIVES if kind != "train" else ():
        assert two.costs.coll[k] - one.costs.coll[k] == pytest.approx(layer.costs.coll[k], rel=1e-12, abs=1e-9)


# -- one full-width trace ---------------------------------------------------------
FULL_WIDTH_SECONDS = 120  # ~5 s alone on a CPU core of this project's dev box


def test_deepseek_decode_32k_traces_at_full_width_without_allocating(capsys):
    """DeepSeekMoE-16B ``decode_32k`` on the 16x16 mesh: rank 0 holds 8 rows
    of a (28, 8, 32768, 1, 128) bf16 cache and its parameter shard (5.45
    GiB); the trace prints the reference's lines, runs the hopper kernels
    (28 paged, 84 grouped matmuls) and raises the peak RSS by well under
    1 GB."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    ops.reset_counts()
    rep = dryrun.lower_one("deepseek-moe-16b", "decode_32k", probe=False)
    seconds = time.perf_counter() - t0
    grew = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - rss0
    out = capsys.readouterr().out.splitlines()
    assert seconds < FULL_WIDTH_SECONDS
    assert grew < 2**30 / 4, grew
    cache = 2 * 28 * 8 * 32768 * 1 * 128 * 2
    assert rep.peak_mem_bytes > 2_090_831_872 + cache
    assert dict(_build.TRACED_CALLS) == {"paged_attention": 28, "grouped_matmul": 84}
    assert not _build.LAUNCH_COUNTS
    assert out[0].startswith("deepseek-moe-16b x decode_32k [16x16] trace=")
    assert out[0].endswith("plan=(attn=tp_heads,kv=heads,ffn=ep,sp=False)")
    assert out[1].startswith("  memory/device: args=5.45GiB temps=") and out[2].startswith("  roofline: compute=")
    assert "-> memory-bound" in out[2]
    assert {line.split(":")[0].strip() for line in out[3:]} == {"all-gather", "all-reduce", "all-to-all"}
    assert rep.model_flops == roofline.model_flops_for(dryrun.get_config("deepseek-moe-16b"), "decode_32k")


def test_skips_and_flag_errors_are_the_reference_s(capsys):
    assert dryrun.lower_one("mistral-nemo-12b", "long_500k") is None
    assert capsys.readouterr().out == (
        "mistral-nemo-12b x long_500k: SKIP: full quadratic attention only (no sliding-window/SSM variant)\n")
    with pytest.raises(SystemExit):
        dryrun.main(["--source", "ilp", "--expert-mode", "ep"])
    assert "--expert-mode/--attn-mode/--kv-shard only apply to --source baseline" in capsys.readouterr().err


def test_production_mesh_refuses_a_real_group(tmp_path):
    """The dry run owns its default group: over a real one it refuses."""
    import torch.distributed as dist

    release_fake_mesh()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            make_production_mesh()
    finally:
        dist.destroy_process_group()
    mesh = make_production_mesh(multi_pod=True, rank=300)
    assert (mesh.name, mesh.world, mesh.shape, mesh.coords) == ("2x16x16", 512, {"data": 32, "model": 16},
                                                                {"data": 18, "model": 12})
