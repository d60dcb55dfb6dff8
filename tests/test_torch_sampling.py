"""Temperature sampling's uniforms (``repro_torch.serving.sampling``).

The Gumbel-max draw forms ``-log(-log(u))``. ``torch.rand`` draws ``u``
from [0, 1); at u = 0 the noise is -inf and that token could never be
drawn, whatever its logit. The reference draws from [tiny, 1)
(``jax.random.gumbel``), and so does the port.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.sampling import SamplingParams, sample  # noqa: E402


def _rand_with_zero_at(col):
    def fake(shape, generator=None, device=None, **kw):
        u = torch.full(shape, 0.5, device=device)
        u[:, col] = 0.0
        return u

    return fake


@pytest.mark.parametrize("top_k", [0, 3])
@pytest.mark.parametrize("rows", [None, (1, 3, 4)])
def test_a_zero_uniform_still_draws_its_dominant_token(monkeypatch, top_k, rows):
    """``torch.rand`` patched to give 0 in the column whose logit dominates:
    that column is still drawn (the old form gave it -inf noise)."""
    col, V = 5, 11
    n = 4 if rows is None else rows[2]
    b = n if rows is None else rows[1] - rows[0]
    logits = torch.zeros((b, V))
    logits[:, col] = 12.0
    monkeypatch.setattr(torch, "rand", _rand_with_zero_at(col))
    out = sample(logits, SamplingParams(temperature=1.0, top_k=top_k), torch.Generator().manual_seed(0), rows)
    assert out.tolist() == [col] * b


def test_the_uniforms_are_clamped_to_tiny_and_nothing_else():
    """Away from 0 the draws are unchanged: the same generator gives the
    same tokens as the unclamped Gumbel-max form."""
    logits = torch.randn((6, 50), generator=torch.Generator().manual_seed(1))
    got = sample(logits, SamplingParams(temperature=0.7), torch.Generator().manual_seed(3))
    u = torch.rand((6, 50), generator=torch.Generator().manual_seed(3))
    assert bool((u > 0).all())
    want = torch.argmax(logits / 0.7 - torch.log(-torch.log(u)), dim=-1)
    assert torch.equal(got, want)


def test_greedy_is_argmax():
    logits = torch.randn((3, 9), generator=torch.Generator().manual_seed(2))
    assert torch.equal(sample(logits, SamplingParams()), torch.argmax(logits, dim=-1))
