"""The port's mamba1 mixer (``repro_torch.models.mamba``) against
``repro.models.mamba``.

On layer 0 of the bridged weights of the reduced Falcon-Mamba-7B, in
float32 on the CPU, on the same seeded inputs: the causal conv, the SSM
inputs, the chunked mixer and the decode step agree with the reference at
1e-5; the chunks cover sizes that divide S and lengths that force the
reference's rule to a smaller chunk. The mixer's final (conv window, SSM
state) equals the reference's ``_mamba_with_state`` tail and
``_mamba_final_state``, which run the recurrence a second time for it, and
the port's mixer equals its own decode step run token by token.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX layer-0 mamba leaves, the same bridged)."""
    cfg_j = reduced("falcon-mamba-7b")
    cfg_t = dataclasses.replace(get_config("falcon-mamba-7b").reduced(), dtype="float32")
    jp = jax.tree.map(lambda x: x[0], jinit_params(cfg_j, jax.random.PRNGKey(0))["layers"]["mamba"])
    return cfg_j, cfg_t, jp, params_from_numpy(jp, "cpu")


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_causal_conv_and_ssm_inputs(setup):
    cfg_j, cfg_t, jp, tp = setup
    x = _x((2, 13, cfg_t.ssm_d_inner), 1)
    conv_j = jmamba._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    conv_t = mamba._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    _close(conv_t, conv_j)
    for got, want in zip(mamba._ssm_inputs(conv_t, tp, cfg_t), jmamba._ssm_inputs(conv_j, jp, cfg_j)):
        assert got.dtype == torch.float32
        _close(got, want)


# (S, chunk): chunks that divide S, one chunk of all of S, and lengths the
# chunk rule shrinks (36 -> 12, 50 -> 10, 7 -> 7)
CHUNKS = [(40, 8), (40, 256), (32, 4), (36, 16), (50, 16), (7, 256)]


@pytest.mark.parametrize("S,chunk", CHUNKS)
def test_mixer_and_final_state_equal_reference(setup, S, chunk):
    cfg_j, cfg_t, jp, tp = setup
    x = _x((2, S, cfg_t.d_model), S)
    assert mamba.chunk_size(S, chunk) == next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
    want = jmamba.mamba_mixer(jnp.asarray(x), jp, cfg_j, chunk=chunk)
    got, state = mamba.mamba_mixer(torch.from_numpy(x), tp, cfg_t, chunk=chunk)
    _close(got, want)
    _close(state.ssm, jtf._mamba_final_state(jnp.asarray(x), jp, cfg_j, chunk=chunk))
    _, (tail, _) = jtf._mamba_with_state(jnp.asarray(x), jp, cfg_j)
    _close(state.conv, tail)
    assert state.ssm.dtype == torch.float32 and tuple(state.conv.shape) == (2, cfg_t.ssm_conv - 1, cfg_t.ssm_d_inner)


def test_decode_steps_equal_reference_in_place(setup):
    """Five steps from a random cache: outputs and the cache at 1e-5, the
    port's cache tensors updated in place."""
    cfg_j, cfg_t, jp, tp = setup
    conv = _x((2, cfg_t.ssm_conv - 1, cfg_t.ssm_d_inner), 3)
    ssm = _x((2, cfg_t.ssm_d_inner, cfg_t.ssm_state), 4)
    jc = jmamba.MambaCache(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm))
    tc = mamba.MambaCache(conv=torch.from_numpy(conv.copy()), ssm=torch.from_numpy(ssm.copy()))
    ptrs = (tc.conv.data_ptr(), tc.ssm.data_ptr())
    for step in range(5):
        x = _x((2, 1, cfg_t.d_model), 10 + step)
        want, jc = jmamba.mamba_decode_step(jnp.asarray(x), jp, cfg_j, jc)
        got = mamba.mamba_decode_step(torch.from_numpy(x), tp, cfg_t, tc)
        _close(got, want)
        _close(tc.conv, jc.conv)
        _close(tc.ssm, jc.ssm)
    assert (tc.conv.data_ptr(), tc.ssm.data_ptr()) == ptrs


def test_mixer_equals_its_decode_steps(setup):
    """The chunked mixer over 24 tokens against the port's own decode step
    fed them one at a time from an empty cache (the reference's
    tests/test_mamba.py idea): outputs and final state."""
    _, cfg_t, _, tp = setup
    x = torch.from_numpy(_x((2, 24, cfg_t.d_model), 5))
    full, state = mamba.mamba_mixer(x, tp, cfg_t, chunk=8)
    cache = mamba.init_cache(cfg_t, 2, dtype=torch.float32)
    seq = torch.cat([mamba.mamba_decode_step(x[:, t : t + 1], tp, cfg_t, cache) for t in range(24)], dim=1)
    _close(full, seq, 1e-4)
    _close(state.ssm, cache.ssm, 1e-4)
    _close(state.conv, cache.conv, 1e-4)
