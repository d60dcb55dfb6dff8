#!/usr/bin/env python3
"""How far prefill and decode of the mamba families part on the card, by
depth and dtype, beside the same path's own rounding noise.

Run from the root of a checkout on a machine with one CUDA sm_90 card:
``python3 tools/mamba_rounding.py``. For Falcon-Mamba-7B and Hymba-1.5B at
full width on seeded random weights (``chip_smoke.py``'s seed), at each of
the first ``--depths`` layers (every layer when a depth is 0), in bf16 and
in float32 (the bf16 weights cast up), on ``chip_smoke.py``'s first serve
batch (4 prompts left-padded to 128 tokens) it prints one JSON line of
``chip_smoke._prefill_vs_decode``'s readings of the last logits:
``rel_l2_err``, the prompts
prefilled and 4 greedy decode steps against one prefill of the prompts and
those 4 tokens; ``batch_noise_rel_l2``, that prefill against each row
prefilled alone, B=1: the same code path, rounded otherwise (other matmul
shapes).

A wrong scan or state hand-off gives unrelated logits (rel L2 near 1.4);
rounding gives readings like the noise. The last line is the card's name
and power limit as ``nvidia-smi`` prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

DEPTHS = {"falcon-mamba-7b": (4, 16, 0), "hymba-1.5b": (4, 0)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=list(DEPTHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mamba_rounding: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    with torch.inference_mode():
        for name in args.models:
            cfg = get_config(name)
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(chip_smoke.SEED), "cuda")
            tokens = chip_smoke._first_batch(cfg)
            for depth in DEPTHS[name]:
                depth = depth or cfg.num_layers
                kept = dict(params, layers=chip_smoke._first_layers(params["layers"], depth))
                for dtype in ("bfloat16", "float32"):
                    c = dataclasses.replace(cfg, num_layers=depth, dtype=dtype)
                    p = kept if dtype == "bfloat16" else chip_smoke._cast(kept, torch.float32)
                    print(json.dumps({"model": name, "layers": depth, "dtype": dtype,
                                      **chip_smoke._prefill_vs_decode(c, p, tokens)}), flush=True)
                    del p
                    torch.cuda.empty_cache()
            del params, kept
            torch.cuda.empty_cache()
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
