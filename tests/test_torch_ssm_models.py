"""The port's mamba and hybrid families against the JAX package.

Falcon-Mamba-7B (pure mamba1, no attention, no FFN) and Hymba-1.5B
(attention heads and mamba heads in parallel in every layer, a dense SwiGLU
FFN, sliding-window attention on its local layers): the config copies equal
the reference's, ``param_shapes`` equals the reference's at full size, and
on the bridged weights of the reduced configs, in float32 on the CPU,
prefill gives the reference's logits at 1e-4 and the same K/V, conv and
SSM caches, four decode steps give the same logits and caches, a prefill
of the prompt and four more tokens gives the logits of the fourth of
those decode steps (in each package), and the contiguous
``merge_cache_rows`` gives the reference's merged cache. Hymba's reduced
window is 16 tokens, the prompts 24.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import decode_step as jdecode_step  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import param_shapes as jparam_shapes  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.transformer import merge_cache_rows as jmerge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decode_step, merge_cache_rows, param_shapes, params_from_numpy, prefill  # noqa: E402

TOL = 1e-4
FAMILIES = ("falcon-mamba-7b", "hymba-1.5b")
# full-size parameter counts from param_shapes (tied embeddings)
PARAMS = {"falcon-mamba-7b": 7_006_326_784, "hymba-1.5b": 1_611_062_400}
B, S, MAX_LEN, STEPS = 2, 24, 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    name = request.param
    cfg_j = reduced(name)
    cfg_t = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(1, cfg_t.vocab_size, (B, S + STEPS)).astype(np.int32)
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu"), toks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _caches_close(tc, jc, tol=TOL):
    for name in ("k", "v", "conv", "ssm"):
        want = getattr(jc, name)
        if want is None:
            assert getattr(tc, name) is None, name
        else:
            _close(getattr(tc, name), want, tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_config_copy_and_shapes_equal_reference(name):
    cfg = get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jget_config(name).reduced())
    shapes = param_shapes(cfg)
    assert shapes == jparam_shapes(jget_config(name))

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

    assert total(shapes) == PARAMS[name]
    assert ("attn" in shapes["layers"]) == cfg.has_attention and ("ffn" in shapes["layers"]) == (name != "falcon-mamba-7b")


def test_prefill_and_decode_equal_reference(setup):
    """Prefill logits and every cache, then four greedy decode steps."""
    cfg_j, cfg_t, jparams, tparams, toks = setup
    jl, jc = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
    tl, tc = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks[:, :S]).long()}, MAX_LEN)
    _close(tl, jl)
    _caches_close(tc, jc)
    assert int(tc.pos) == int(jc.pos) == S
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jdecode_step(jparams, cfg_j, jnp.asarray(nxt)[:, None], jc)
        tl, tc = decode_step(tparams, cfg_t, torch.from_numpy(nxt).long()[:, None], tc)
        _close(tl, jl)
    _caches_close(tc, jc)
    assert int(tc.pos) == int(jc.pos) == S + STEPS


def test_prefill_equals_decode(setup):
    """Prefill of the prompt plus four tokens against the prompt's prefill
    and those four tokens decoded one by one: the last logits agree, in
    the port as in the reference (the state hand-off from prefill to
    decode, through left-padding-free prompts)."""
    cfg_j, cfg_t, jparams, tparams, toks = setup
    whole, _ = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks).long()}, MAX_LEN)
    _, cache = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks[:, :S]).long()}, MAX_LEN)
    for t in range(S, S + STEPS):
        logits, cache = decode_step(tparams, cfg_t, torch.from_numpy(toks[:, t : t + 1]).long(), cache)
    _close(logits, whole)
    jwhole, _ = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    _close(whole, jwhole)


def test_merge_cache_rows_equals_reference(setup):
    """A B=1 prefill merged into row 1 of a live B=3 cache with per-row
    positions, in each package."""
    cfg_j, cfg_t, jparams, tparams, toks = setup
    live_toks = np.random.default_rng(2).integers(1, cfg_t.vocab_size, (3, S)).astype(np.int32)
    _, jlive = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(live_toks)}, MAX_LEN)
    _, tlive = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(live_toks).long()}, MAX_LEN)
    pos = np.array([S, S + 3, S + 1], np.int32)
    jlive = jlive._replace(pos=jnp.asarray(pos))
    tlive.pos = torch.from_numpy(pos.copy())
    _, jsub = jprefill(jparams, cfg_j, {"tokens": jnp.asarray(toks[:1, :16])}, MAX_LEN)
    _, tsub = prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks[:1, :16]).long()}, MAX_LEN)
    ptrs = [t.data_ptr() for t in (tlive.k, tlive.conv, tlive.ssm) if t is not None]
    want = jmerge(jlive, jsub, [1])
    got = merge_cache_rows(tlive, tsub, [1])
    _caches_close(got, want)
    assert got.pos.tolist() == np.asarray(want.pos).tolist() == [S, 16, S + 1]
    assert [t.data_ptr() for t in (got.k, got.conv, got.ssm) if t is not None] == ptrs
