"""The frozen counts against the hand-worked numbers of the two cells."""

import json

import pytest

from conftest import ROOT, TINY
from hapbench import counts


def config(name):
    return json.loads((ROOT / "hapbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, params_b, gib", [("deepseek-moe-16b", 16.88, 31.4), ("mixtral-8x7b-l16", 23.48, 43.7)])
def test_parameters_and_weight_memory(name, params_b, gib):
    n = counts.total_params(config(name))
    assert round(n / 1e9, 2) == params_b
    assert round(n * counts.BF16_BYTES / 2**30, 1) == gib


def test_deepseek_decode_step_reads_32_9_gb():
    nbytes = counts.decode_step_weight_bytes(config("deepseek-moe-16b"))
    assert round(nbytes / 1e9, 1) == 32.9
    assert round(nbytes / counts.H100_HBM_BYTES_PER_S * 1e3, 1) == 9.8  # the byte floor of a step, ms


@pytest.mark.parametrize("name, kib", [("deepseek-moe-16b", 224), ("mixtral-8x7b-l16", 64)])
def test_kv_bytes_per_token(name, kib):
    assert counts.kv_bytes_per_token(config(name)) == kib * 1024


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mixtral-8x7b-l16"])
def test_counts_agree_with_the_program_config(name):
    """The frozen arithmetic counts what the program's own config counts."""
    from hapbench.harness import model_config

    cfg = config(name)
    assert counts.total_params(cfg) == model_config(cfg).total_params()


def test_gmm_work_and_its_bound():
    flops, nbytes = counts.gmm_work(64, 64, 2048, 1408)
    assert flops == 2 * 64 * 64 * 2048 * 1408
    assert nbytes == (64 * 2048 * 1408 + 64 * 64 * 2048 + 64 * 64 * 1408) * 2
    assert counts.least_time_s(flops, nbytes)[1] == "bytes"  # decode: the weights bound it
    assert counts.least_time_s(*counts.gmm_work(8, 4096, 4096, 14336))[1] == "operations"


def test_sequence_flops_is_the_sum_over_tokens():
    cfg = dict(TINY)
    per_token = 2 * counts.active_matmul_params(cfg)
    per_key = counts.attention_flops_per_key(cfg)
    prompt, new = 7, 5
    want = sum(per_token + per_key * (p + 1) for p in range(prompt + new - 1))
    assert counts.sequence_flops(cfg, prompt, new) == want
    # top-k of the routed experts, every shared one, the router, attention and the head
    d = cfg["d_model"]
    layer = d * 4 * 16 * 2 + d * 2 * 16 * 2 + 2 * 3 * d * 32 + 1 * 3 * d * 32 + d * 4
    assert counts.active_matmul_params(cfg) == 2 * layer + 128 * d
