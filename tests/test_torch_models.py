"""The port's config, weights bridge, layers and model against the JAX package.

The JAX weights from ``repro.models.init_params(cfg, PRNGKey(0))`` are
bridged into torch (torch cannot replay ``jax.random``), the same inputs go
through both frameworks in float32 on the CPU, and the results agree within
the stated tolerances; router top-k indices agree exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.models.params import param_shapes as jparam_shapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, moe, transformer  # noqa: E402
from repro_torch.models.params import init_params, param_shapes, params_from_numpy  # noqa: E402

NAME = "deepseek-moe-16b"
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _torch_cfg(**overrides):
    cfg = get_config(NAME).reduced()
    return dataclasses.replace(cfg, dtype="float32", **overrides)


CONFIGS = {"main": dict(capacity_factor=8.0), "gqa": dict(capacity_factor=8.0, num_kv_heads=2)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    over = CONFIGS[request.param]
    cfg_j, cfg_t = reduced(NAME, **over), _torch_cfg(**over)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def test_config_copy_equals_reference():
    assert dataclasses.asdict(get_config(NAME)) == dataclasses.asdict(jget_config(NAME))
    assert dataclasses.asdict(get_config(NAME).reduced()) == dataclasses.asdict(jget_config(NAME).reduced())
    assert param_shapes(get_config(NAME)) == jparam_shapes(jget_config(NAME))


def test_bridge_keeps_keys_shapes_and_values(setup):
    _, cfg_t, jparams, tparams = setup
    jf, tf = _flat(jparams), _flat(tparams)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == tuple(jf[k].shape), k
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    # the port's own init has the same leaves, shapes and dtype
    own = _flat(init_params(cfg_t, torch.Generator().manual_seed(0), "cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in tf.items()}
    assert all(v.dtype == torch.float32 for v in own.values())
    assert torch.all(own["layers/ln1"] == 1)


def test_bridge_reads_bfloat16():
    a = jnp.asarray(_rand(0, 3, 5), jnp.bfloat16)
    t = params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_rms_norm_and_rope_match_jax():
    x, w = _rand(1, 2, 5, 3, 16), _rand(2, 16)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6), jcommon.rms_norm(x, w, 1e-6), 2e-5)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [7]], np.int32)
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0),
           jcommon.apply_rope(x, pos, 10000.0), 2e-5)


def test_route_dispatch_combine_match_jax(setup):
    cfg_j, cfg_t, jparams, tparams = setup
    T, d = 24, cfg_t.d_model
    x = _rand(3, T, d)
    router = np.array(jparams["layers"]["moe"]["router"][0])
    g_j, i_j, a_j = jmoe.route(x, router, cfg_j)
    g_t, i_t, a_t = moe.route(torch.from_numpy(x), torch.from_numpy(router), cfg_t)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(g_t, g_j, 2e-5)
    _close(a_t, a_j, 2e-5)
    E, C = cfg_t.n_routed_experts, 8  # small C: capacity drops happen
    fe_j, pe_j, keep_j, fg_j = jmoe.make_dispatch(i_j, g_j, E, C)
    fe, pe, keep, fg = moe.make_dispatch(i_t, g_t, E, C)
    assert not keep.all()
    np.testing.assert_array_equal(pe.numpy(), np.asarray(pe_j))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    buf_j, map_j = jmoe.dispatch(x, fe_j, pe_j, E, C)
    buf, idx_map = moe.dispatch(torch.from_numpy(x), fe, pe, E, C)
    np.testing.assert_array_equal(idx_map.numpy(), np.asarray(map_j))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(buf_j))
    y_buf = _rand(4, E, C, d)
    _close(moe.combine(torch.from_numpy(y_buf), fe, pe, keep, fg, T),
           jmoe.combine(y_buf, fe_j, pe_j, keep_j, fg_j, T), 2e-5)


def test_moe_local_matches_jax(setup):
    cfg_j, cfg_t, jparams, tparams = setup
    x = _rand(5, 40, cfg_t.d_model)
    lp_j = jax.tree.map(lambda a: a[1], jparams["layers"]["moe"])
    lp_t = {k: v[1] for k, v in tparams["layers"]["moe"].items()}
    y_j, aux_j, idx_j = jmoe._moe_local(x, lp_j, cfg_j)
    y_t, aux_t, idx_t = moe._moe_local(torch.from_numpy(x), lp_t, cfg_t)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(y_t, y_j)
    _close(aux_t, aux_j)
    out_j = jmoe.apply_moe(x[None], lp_j, cfg_j, None)
    out_t = moe.apply_moe(torch.from_numpy(x)[None], lp_t, cfg_t)
    _close(out_t.y, out_j.y)


def test_prefill_and_decode_match_jax(setup):
    """Prefill logits and 4 teacher-forced decode steps, float32."""
    cfg_j, cfg_t, jparams, tparams = setup
    B, S, steps = 2, 24, 4
    toks = np.random.default_rng(6).integers(1, cfg_t.vocab_size, (B, S)).astype(np.int32)
    max_len = S + steps + 1
    j_logits, j_cache = jtf.prefill(jparams, cfg_j, {"tokens": jnp.asarray(toks)}, max_len)
    t_logits, t_cache = transformer.prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks).long()}, max_len)
    _close(t_logits, j_logits)
    _close(t_cache.k, j_cache.k)
    assert t_cache.pos == int(j_cache.pos) == S
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        j_logits, j_cache = jtf.decode_step(jparams, cfg_j, jnp.asarray(nxt)[:, None], j_cache)
        t_logits, t_cache = transformer.decode_step(tparams, cfg_t, torch.from_numpy(nxt).long()[:, None], t_cache)
        _close(t_logits, j_logits)
    _close(t_cache.v, j_cache.v)
    assert t_cache.pos == int(j_cache.pos)


def test_unported_family_raises():
    # an unknown block type is not ported; an encoder-only model is (ROADMAP
    # A.7), but has no prefill: the reference asserts cfg.causal there
    cfg = dataclasses.replace(_torch_cfg(), block_type="rwkv")
    with pytest.raises(NotImplementedError):
        transformer.prefill({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, 8)
    cfg = dataclasses.replace(_torch_cfg(), causal=False)
    with pytest.raises(ValueError, match="prefill/decode only for decoder models"):
        transformer.prefill({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, 8)
