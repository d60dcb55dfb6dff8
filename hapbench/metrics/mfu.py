"""The whole step's share of the card's bf16 peak: the model FLOPs of every
request the window served (``hapbench.counts.sequence_flops``: 2 x the active
parameters a token multiplies by, plus attention over its real context; no
padding of any kind) over the window times 989 TFLOP/s."""

from hapbench import counts


def read(rec):
    if rec.window_s <= 0 or not rec.requests:
        return None
    flops = sum(counts.sequence_flops(rec.config, p, n) for p, n in rec.requests)
    return 100.0 * flops / (rec.window_s * counts.H100_BF16_FLOPS)
