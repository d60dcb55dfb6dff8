"""The port's other attention-only families against the JAX package: configs,
parameter shapes, the weight bridge and the model forward.

For each of the eight families beside DeepSeekMoE-16B (the paper's
generalisation set Mixtral-8x7B, Qwen1.5-MoE-A2.7B and Qwen2-57B-A14B, and
the reference registry's Qwen3-30B-A3B, Gemma-7B, Gemma-2-9B, Gemma-3-27B
and Mistral-Nemo-12B): the config copy equals the reference's, full and
reduced; ``param_shapes`` of the FULL config equals the reference's (shapes
only, nothing allocated); the bridge keeps every leaf; and on the bridged
weights of the reduced config, in float32 on the CPU, prefill and four
teacher-forced decode steps give the JAX logits within 1e-4 (the two
frameworks sum in other orders; float32 keeps that near 1e-6), with the
router's top-k indices equal for the MoE families. A second reduced variant
per family keeps the family's own GQA group (8, 7, 4 or 2 query heads per
KV head) with 8 (7) query heads, so its query width differs from d_model.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.models.params import param_shapes as jparam_shapes  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.params import init_params, param_shapes, params_from_numpy  # noqa: E402

FAMILIES = ("gemma-7b", "gemma2-9b", "gemma3-27b", "mistral-nemo-12b", "mixtral-8x7b", "qwen1.5-moe-a2.7b",
            "qwen2-57b-a14b", "qwen3-moe-30b-a3b")
TOL = 1e-4


def _group_variant(name):
    """The family's own GQA group at reduced width: (num_heads, num_kv_heads),
    or None for a family without GQA (group 1)."""
    full = get_config(name)
    G = full.num_heads // full.num_kv_heads
    if G == 1:
        return None
    heads = 7 if G == 7 else 8
    return heads, heads // min(G, heads)


CASES = [(n, "reduced") for n in FAMILIES] + [(n, "gqa") for n in FAMILIES if _group_variant(n)]


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _configs(name, variant):
    over = {}
    if variant == "gqa":
        heads, kv = _group_variant(name)
        over = dict(num_heads=heads, num_kv_heads=kv)
    cfg_t = dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    return reduced(name, **over), cfg_t


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def setup(request):
    name, variant = request.param
    cfg_j, cfg_t = _configs(name, variant)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def test_registry_holds_deepseek_and_the_eight_families():
    # and the two families with mamba layers (tests/test_torch_ssm_models.py)
    # and the audio and vision models (tests/test_torch_frontends.py)
    assert list_configs() == tuple(sorted(("deepseek-moe-16b", "falcon-mamba-7b", "hymba-1.5b", "hubert-xlarge",
                                           "llava-next-mistral-7b") + FAMILIES))


@pytest.mark.parametrize("name", FAMILIES)
def test_config_copy_equals_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == dataclasses.asdict(jget_config(name).reduced())


@pytest.mark.parametrize("name", FAMILIES)
def test_full_param_shapes_equal_reference(name):
    """The full-width leaves, as shapes only: the dense ``ffn``, the post
    norms, an untied ``lm_head``, a shared expert of its own width."""
    cfg = get_config(name)
    shapes = param_shapes(cfg)
    assert shapes == jparam_shapes(jget_config(name))
    layers = shapes["layers"]
    assert ("lm_head" in shapes) == (not cfg.tie_embeddings)
    assert ("ln1_post" in layers and "ln2_post" in layers) == cfg.use_post_norm
    assert ("ffn" in layers) == (cfg.ffn_type == "dense") and ("moe" in layers) == cfg.is_moe
    if cfg.n_shared_experts:
        assert layers["moe"]["shared_wo"] == (cfg.num_layers, cfg.shared_d_ff * cfg.n_shared_experts, cfg.d_model)


def test_bridge_keeps_keys_shapes_and_values(setup):
    _, cfg_t, jparams, tparams = setup
    jf, tf = _flat(jparams), _flat(tparams)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == tuple(jf[k].shape), k
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    own = _flat(init_params(cfg_t, torch.Generator().manual_seed(0), "cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in tf.items()}
    assert all(v.dtype == torch.float32 for v in own.values())


def test_prefill_and_decode_match_jax(setup):
    """Prefill logits, the primed cache and 4 teacher-forced decode steps,
    float32. 24 prompt tokens: past the reduced 16-token sliding window of
    Gemma-2/3's local layers."""
    cfg_j, cfg_t, jparams, tparams = setup
    B, S, steps = 2, 24, 4
    toks = np.random.default_rng(6).integers(1, cfg_t.vocab_size, (B, S)).astype(np.int32)
    max_len = S + steps + 1
    j_logits, j_cache = jtf.prefill(jparams, cfg_j, {"tokens": jnp.asarray(toks)}, max_len)
    t_logits, t_cache = transformer.prefill(tparams, cfg_t, {"tokens": torch.from_numpy(toks).long()}, max_len)
    _close(t_logits, j_logits)
    _close(t_cache.k, j_cache.k)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        j_logits, j_cache = jtf.decode_step(jparams, cfg_j, jnp.asarray(nxt)[:, None], j_cache)
        t_logits, t_cache = transformer.decode_step(tparams, cfg_t, torch.from_numpy(nxt).long()[:, None], t_cache)
        _close(t_logits, j_logits)
    _close(t_cache.v, j_cache.v)
    assert int(t_cache.pos) == int(j_cache.pos) == S + steps
    if cfg_t.final_logit_softcap:
        assert float(t_logits.abs().max()) < cfg_t.final_logit_softcap


@pytest.mark.parametrize("name", [n for n in FAMILIES if get_config(n).is_moe])
def test_routing_and_moe_layer_match_jax(name):
    """Top-k routing indices equal and the MoE layer's output within 1e-4,
    at the reduced config's capacity (1.25: tokens are dropped) and at the
    reduced top-k of the family, on a layer's weights."""
    cfg_j, cfg_t = _configs(name, "reduced")
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    lp_j = jax.tree.map(lambda a: a[1], jparams["layers"]["moe"])
    lp_t = {k: torch.from_numpy(np.array(v)) for k, v in lp_j.items()}
    x = np.random.default_rng(5).standard_normal((40, cfg_t.d_model)).astype(np.float32)
    g_j, i_j, _ = jmoe.route(x, np.asarray(lp_j["router"]), cfg_j)
    g_t, i_t, _ = moe.route(torch.from_numpy(x), lp_t["router"], cfg_t)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(g_t, g_j, 2e-5)
    y_j, _, idx_j = jmoe._moe_local(x, lp_j, cfg_j)
    y_t, _, idx_t = moe._moe_local(torch.from_numpy(x), lp_t, cfg_t)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(y_t, y_j)
    out_j = jmoe.apply_moe(x[None], lp_j, cfg_j, None)
    out_t = moe.apply_moe(torch.from_numpy(x)[None], lp_t, cfg_t)
    _close(out_t.y, out_j.y)


@pytest.mark.parametrize("name", [n for n in FAMILIES if get_config(n).is_moe])
def test_routing_with_the_family_top_k_and_ties(name):
    """The family's own top-k (2, 4 or 8) over 16 experts (Mixtral: its 8),
    with exact ties: duplicated router columns, and all-zero tokens whose
    probabilities are all equal. Both packages order by probability, the
    lower expert index first among equal ones."""
    full = get_config(name)
    E = min(full.n_routed_experts, 16)
    over = dict(n_routed_experts=E, top_k=full.top_k)
    cfg_j, cfg_t = reduced(name, **over), dataclasses.replace(get_config(name).reduced(), dtype="float32", **over)
    rng = np.random.default_rng(11)
    router = rng.standard_normal((cfg_t.d_model, E)).astype(np.float32) * 0.1
    router[:, 1::4] = router[:, ::4]  # experts 4i + 1 tie with 4i
    x = rng.standard_normal((24, cfg_t.d_model)).astype(np.float32)
    x[:3] = 0.0  # every expert equally likely
    g_j, i_j, a_j = jmoe.route(x, router, cfg_j)
    g_t, i_t, a_t = moe.route(torch.from_numpy(x), torch.from_numpy(router), cfg_t)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert i_t[0].tolist() == list(range(full.top_k))
    _close(g_t, g_j, 2e-5)
    _close(a_t, a_j, 2e-5)
