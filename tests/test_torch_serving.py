"""The port's static serving engine against ``repro.serving.InferenceEngine``.

Greedy decoding must give exactly the JAX engine's tokens on the prompts of
``tests/test_serving.py`` (the equivalence contract, across frameworks), on
the same bridged weights, in float32 on the CPU. Also: the engine never
falls back to the CPU on its own, and the port imports nothing of JAX or
of the JAX package.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.core.session import round_up as jround_up  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import InferenceEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import FifoScheduler as JaxFifo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import InferenceEngine, Request, SamplingParams  # noqa: E402
from repro_torch.serving.scheduler import FifoScheduler, round_up  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _both(setup, prompts, max_new, max_batch):
    """Serve ``prompts`` on both engines; returns (jax tokens, port tokens,
    port engine)."""
    cfg_j, cfg_t, jparams, tparams = setup
    je = JaxEngine(cfg_j, jparams, max_batch=max_batch)
    te = InferenceEngine(cfg_t, tparams, max_batch=max_batch, device="cpu")
    for p in prompts:
        je.submit(JaxRequest(prompt=p, max_new_tokens=max_new))
        te.submit(Request(prompt=p, max_new_tokens=max_new))
    return [c.tokens for c in je.run()], [c.tokens for c in te.run()], te


def test_greedy_tokens_equal_jax(moe_setup):
    """``test_serving.py::test_greedy_deterministic``'s prompts."""
    want, got, _ = _both(moe_setup, ([1, 2, 3, 4], [5, 6, 7, 8, 9, 10]), 8, 4)
    assert got == want
    assert all(len(t) == 8 for t in got)


def test_batched_and_single_equal_jax(moe_setup):
    """``test_serving.py::test_batched_equals_single``'s prompts, batched
    and one at a time."""
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8]]
    want, got, _ = _both(moe_setup, prompts, 6, 2)
    assert got == want
    singles = []
    for p in prompts:
        want_s, got_s, _ = _both(moe_setup, [p], 6, 1)
        assert got_s == want_s
        singles.append(got_s[0])
    assert got[0] == singles[0]


def test_queue_longer_than_max_batch_equal_jax(moe_setup):
    """Four requests of uneven length through max_batch 2: two batches."""
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10], [11, 12], [13, 14, 15, 16, 17, 18, 19]]
    want, got, eng = _both(moe_setup, prompts, 5, 2)
    assert got == want
    assert eng.stats.batches == 2


def test_scheduler_copy_matches_reference():
    for x, q in ((0, 64), (1, 64), (64, 64), (65, 64), (127, 16)):
        assert round_up(x, q) == jround_up(x, q)
    prompts = [[1, 2, 3], list(range(1, 70)), [], [9] * 64]
    ours, theirs = FifoScheduler(max_batch=3), JaxFifo(max_batch=3)
    for p in prompts:
        ours.submit(p, 4)
        theirs.submit(p, 4)
    while len(theirs):
        a, b = ours.next_batch(), theirs.next_batch()
        assert [r.uid for r in a] == [r.uid for r in b]
        assert [ours.prompt_bucket(r) for r in a] == [theirs.prompt_bucket(r) for r in b]
        for x, y in zip(ours.pad_batch(a), theirs.pad_batch(b)):
            np.testing.assert_array_equal(x, y)
    assert ours.next_batch() is None


def test_temperature_sampling_is_seeded(moe_setup):
    _, cfg_t, _, tparams = moe_setup
    runs = []
    for _ in range(2):
        eng = InferenceEngine(cfg_t, tparams, max_batch=1, device="cpu")
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=5))
        runs.append(eng.run(SamplingParams(temperature=0.8, top_k=16, seed=3))[0].tokens)
    assert runs[0] == runs[1] and len(runs[0]) == 5
    assert all(0 <= t < cfg_t.vocab_size for t in runs[0])


def test_engine_without_cuda_raises(moe_setup, monkeypatch):
    _, cfg_t, _, tparams = moe_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        InferenceEngine(cfg_t, tparams)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 25
    bad = [
        (f.relative_to(ROOT).as_posix(), m)
        for f in files
        for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []
