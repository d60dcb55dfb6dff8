"""The port's audio and vision models against the JAX package.

HuBERT-XLarge (encoder-only, bidirectional, audio frame embeddings through
``frontend_proj``, a plain GELU FFN) and LLaVA-NeXT-Mistral-7B (image patch
embeddings through ``frontend_proj`` ahead of the text, a causal Mistral
decoder): the config copies equal the reference's, full and reduced;
``param_shapes`` equals the reference's at full size (945,788,160 and
7,245,926,400 parameters); and on the bridged weights of the reduced
configs, in float32 on the CPU, ``embed_inputs`` (audio, vision, text) and
``forward_hidden`` give the reference's values at 1e-5, LLaVA's prefill of
an image prompt and four decode steps give its logits at 1e-4, and each
decode step's logits equal ``forward_hidden`` over the longer sequence, in
each package. ``full_attention`` with a last KV chunk shorter than the
others equals the same call in one chunk and the reference's (causal,
windowed, bidirectional). HuBERT has no prefill or decode, and the serving engine takes
neither model: each refuses with a clear error. ``input_specs``,
``cache_specs`` and ``supported_shapes`` give the reference's shapes, dtypes
and strings for every config and input shape, and ``make_batch`` its keys,
shapes and dtypes.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced  # noqa: E402
from repro.configs import ASSIGNED_ARCHS as JASSIGNED  # noqa: E402
from repro.configs import PAPER_ARCHS as JPAPER  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import io as jio  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.models.params import param_shapes as jparam_shapes  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cache_specs,
    decode_step,
    embed_inputs,
    forward_hidden,
    init_params,
    input_specs,
    make_batch,
    param_shapes,
    params_from_numpy,
    prefill,
    supported_shapes,
    unembed,
)
from repro_torch.models.io import INPUT_SHAPES  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

MODELS = ("hubert-xlarge", "llava-next-mistral-7b")
# full-size parameter counts from param_shapes
PARAMS = {"hubert-xlarge": 945_788_160, "llava-next-mistral-7b": 7_245_926_400}
TOL = 1e-5
B, N_TEXT, STEPS = 2, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so this file's workers leave
    the cores to the suite's other (timing-sensitive) workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    return reduced(name), dataclasses.replace(get_config(name).reduced(), dtype="float32")


@pytest.fixture(scope="module", params=MODELS)
def setup(request):
    cfg_j, cfg_t = _configs(request.param)
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def _inputs(cfg, seed=1, n_text=N_TEXT, seq=24):
    """A numpy batch of the model's modality: frames, or patches and text."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, seq, cfg.frontend_dim)).astype(np.float32)}
    return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.frontend_dim)).astype(np.float32),
            "tokens": rng.integers(1, cfg.vocab_size, (B, n_text)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_registry_and_arch_lists_equal_reference():
    assert ASSIGNED_ARCHS == JASSIGNED and PAPER_ARCHS == JPAPER
    for name in ASSIGNED_ARCHS + PAPER_ARCHS:
        assert get_config(name).name == name


@pytest.mark.parametrize("name", MODELS)
def test_config_copy_and_shapes_equal_reference(name):
    cfg = get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(name))
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jget_config(name).reduced())
    shapes = param_shapes(cfg)
    assert shapes == jparam_shapes(jget_config(name))

    def total(tree):
        return sum(total(v) if isinstance(v, dict) else math.prod(v) for v in tree.values())

    assert total(shapes) == PARAMS[name]
    assert shapes["frontend_proj"] == (cfg.frontend_dim, cfg.d_model)
    ffn = shapes["layers"]["ffn"]
    assert set(ffn) == ({"wi", "wo"} if name == "hubert-xlarge" else {"wi_gate", "wi_up", "wo"})


def test_init_and_bridge_reach_every_leaf(setup):
    """``init_params`` draws, and the bridge keeps, the reference's leaves
    (``frontend_proj`` and the plain FFN's ``wi`` among them) at their
    shapes; the bridged values are the reference's exactly."""
    cfg_j, cfg_t, jparams, tparams = setup
    mine = init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")

    def walk(a, b, c):
        assert set(a) == set(b) == set(c)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], c[k])
            else:
                assert tuple(a[k].shape) == tuple(b[k].shape) == tuple(c[k].shape), k
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))

    walk(jparams, tparams, mine)


def test_embed_inputs_equal_reference(setup):
    """Audio frames, or patches ahead of the text, and plain text."""
    cfg_j, cfg_t, jparams, tparams = setup
    batch = _inputs(cfg_t)
    _close(embed_inputs(tparams, cfg_t, _torch(batch)), jtf.embed_inputs(jparams, cfg_j, _jax(batch), None))
    # the same weights read as a text model: token embeddings alone
    text = {"tokens": np.random.default_rng(2).integers(0, cfg_t.vocab_size, (B, 8)).astype(np.int32)}
    cfg_j, cfg_t = (dataclasses.replace(c, frontend="none") for c in (cfg_j, cfg_t))
    _close(embed_inputs(tparams, cfg_t, _torch(text)), jtf.embed_inputs(jparams, cfg_j, _jax(text), None))


@pytest.mark.parametrize("collect_kv", [False, True])
def test_forward_hidden_equals_reference(setup, collect_kv):
    """HuBERT bidirectional, LLaVA causal over patches and text: the hidden
    states, and with ``collect_kv`` the stacked K/V, at 1e-5."""
    cfg_j, cfg_t, jparams, tparams = setup
    batch = _inputs(cfg_t)
    jh, jkv, _ = jtf.forward_hidden(jparams, cfg_j, jtf.embed_inputs(jparams, cfg_j, _jax(batch), None), None,
                                    collect_kv=collect_kv)
    h, kv, aux = forward_hidden(tparams, cfg_t, embed_inputs(tparams, cfg_t, _torch(batch)), collect_kv=collect_kv)
    _close(h, jh)
    assert float(aux) == 0.0
    if collect_kv:
        assert kv[0].shape == jkv[0].shape
        _close(kv[0], jkv[0])
        _close(kv[1], jkv[1])
    else:
        assert kv is None


def _llava():
    cfg_j, cfg_t = _configs("llava-next-mistral-7b")
    jparams = jinit_params(cfg_j, jax.random.PRNGKey(3))
    return cfg_j, cfg_t, jparams, params_from_numpy(jparams, "cpu")


def test_llava_prefill_and_decode_equal_reference():
    """An image prompt (16 patches + 12 text tokens) prefilled into a cache
    of S + 8 + num_patches positions, then four greedy decode steps: the
    logits at 1e-4 and the K/V caches; each step's logits equal the last
    position of ``forward_hidden`` over the prompt and the tokens taken so
    far, in each package."""
    cfg_j, cfg_t, jparams, tparams = _llava()
    batch = _inputs(cfg_t, seed=4)
    S = cfg_t.num_patches + N_TEXT
    max_len = S + 8 + cfg_t.num_patches
    jl, jc = jtf.prefill(jparams, cfg_j, _jax(batch), max_len)
    tl, tc = prefill(tparams, cfg_t, _torch(batch), max_len)
    _close(tl, jl, 1e-4)
    _close(tc.k[:, :, :S], jc.k[:, :, :S], 1e-4)
    assert int(tc.pos) == int(jc.pos) == S
    toks = batch["tokens"]
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        toks = np.concatenate([toks, nxt], axis=1)
        jl, jc = jtf.decode_step(jparams, cfg_j, jnp.asarray(nxt), jc)
        tl, tc = decode_step(tparams, cfg_t, torch.from_numpy(nxt).long(), tc)
        _close(tl, jl, 1e-4)
        longer = dict(batch, tokens=toks)
        jh, _, _ = jtf.forward_hidden(jparams, cfg_j, jtf.embed_inputs(jparams, cfg_j, _jax(longer), None), None)
        _close(jl, jtf.unembed(jparams, cfg_j, jh[:, -1:])[:, 0], 1e-4)
        th, _, _ = forward_hidden(tparams, cfg_t, embed_inputs(tparams, cfg_t, _torch(longer)))
        _close(tl, unembed(tparams, cfg_t, th[:, -1:])[:, 0], 1e-4)
    _close(tc.k, jc.k, 1e-4)
    assert int(tc.pos) == S + STEPS


@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
def test_full_attention_ragged_last_kv_chunk(mask):
    """``full_attention`` over 40 keys in chunks of 16 (the last one 8 long,
    as a vision prompt's 2,880 patches and its text leave a short last
    chunk of 1024), with a per-row ``kv_len``: equal to the same call in
    one chunk, and to the reference's ``full_attention`` in chunks of 8
    (which divide 40: the reference asserts that they do), at 1e-5."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    cfg_j, cfg_t = _configs("hubert-xlarge" if mask == "bidirectional" else "llava-next-mistral-7b")
    if mask == "window":
        cfg_j, cfg_t = (dataclasses.replace(c, sliding_window=12) for c in (cfg_j, cfg_t))
    rng = np.random.default_rng(7)
    Sk, hd = 40, cfg_t.head_dim
    q = rng.standard_normal((2, Sk, 4, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, hd)).astype(np.float32) for _ in range(2))
    pos, kv_len = np.arange(Sk, dtype=np.int32), np.array([Sk, 29], dtype=np.int32)
    is_global = mask != "window"

    def port(kv_chunk):
        return tattn.full_attention(*map(torch.from_numpy, (q, k, v)), cfg_t, is_global, torch.from_numpy(pos),
                                    torch.from_numpy(pos), torch.from_numpy(kv_len), kv_chunk=kv_chunk)

    ragged = port(16)
    _close(ragged, port(Sk), TOL)
    want = jattn.full_attention(*map(jnp.asarray, (q, k, v)), cfg_j, is_global, jnp.asarray(pos), jnp.asarray(pos),
                                jnp.asarray(kv_len), kv_chunk=8)
    _close(ragged, want, TOL)


def test_hubert_and_the_engine_refuse():
    """HuBERT has no prefill or decode (the reference asserts
    ``cfg.causal``); the engine serves token prompts of decoders only."""
    _, cfg = _configs("hubert-xlarge")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    feats = {"features": torch.from_numpy(_inputs(cfg)["features"])}
    with pytest.raises(ValueError, match="prefill/decode only for decoder models"):
        prefill(params, cfg, feats, 32)
    with pytest.raises(ValueError, match="prefill/decode only for decoder models"):
        decode_step(params, cfg, torch.zeros((B, 1), dtype=torch.long), None)
    with pytest.raises(ValueError, match="not an encoder-only model"):
        InferenceEngine(cfg, params, device="cpu")
    _, llava = _configs("llava-next-mistral-7b")
    with pytest.raises(ValueError, match="not a model with vision inputs"):
        InferenceEngine(llava, {}, device="cpu")


def _spec_of(x):
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_input_and_cache_specs_equal_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert supported_shapes(cfg) == jio.supported_shapes(jcfg)
    for shape in INPUT_SHAPES:
        got, want = input_specs(cfg, shape), jio.input_specs(jcfg, shape)
        assert set(got) == set(want)
        if "batch" in want:
            assert list(got["batch"]) == list(want["batch"])
            for k, v in want["batch"].items():
                assert got["batch"][k].device.type == "meta"
                assert _spec_of(got["batch"][k]) == (tuple(v.shape), str(v.dtype)), (shape, k)
        else:
            assert _spec_of(got["token"]) == (tuple(want["token"].shape), str(want["token"].dtype))
            for f in ("k", "v", "conv", "ssm", "pos"):
                g, w = getattr(got["cache"], f), getattr(want["cache"], f)
                assert (g is None) == (w is None), f
                if w is not None:
                    assert _spec_of(g) == (tuple(w.shape), str(w.dtype)), (shape, f)
    c, jc = cache_specs(cfg, 2, 64), jio.cache_specs(jcfg, 2, 64)
    assert (c.k is None) == (jc.k is None) and (c.conv is None) == (jc.conv is None)


@pytest.mark.parametrize("name", ("deepseek-moe-16b",) + MODELS)
@pytest.mark.parametrize("with_labels", [True, False])
def test_make_batch_keys_shapes_dtypes_equal_reference(name, with_labels):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    got = make_batch(cfg, 40, 2, torch.Generator().manual_seed(0), with_labels=with_labels, device="cpu")
    want = jio.make_batch(reduced(name), 40, 2, jax.random.PRNGKey(0), with_labels=with_labels)
    assert list(got) == list(want)
    for k, v in want.items():
        assert _spec_of(got[k]) == (tuple(v.shape), str(v.dtype)), k
        if v.dtype == jnp.int32:
            assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
