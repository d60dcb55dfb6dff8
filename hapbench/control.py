"""The readings a cell's limit is set from, and the control's verdict, on the card.

    python3 hapbench/control.py --workload <cell> --seeds 11,12,13 [--seconds 0]

For each seed, in one process: a run of the cell as the benchmark makes it
(weights and traffic from the seed, set-up, a window of whole jobs; with
``--seconds 0`` one job), its served-token gaps under the float32 reference
(the program's reading), and on the same sample the float8 control's and
the bf16 witness's (``check.stand_in_gaps``): each set's mean, widest,
median, 99th percentile and share of non-zero gaps, and each judged by
``check.verdict`` at the cell's own limit. One JSON line a seed, then one
line of verdicts. Exits with 1 where the float8 control came out correct on
any seed: the limit then does not part it from the program.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    import argparse

    import torch

    from hapbench import harness, manifest

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    verdicts = {"program": [], "fp8": [], "bf16": []}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, control=True)
        for k, v in r["control"].items():
            verdicts[k].append(v["correct"])
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"], **r["control"],
                          "attempted": r["attempted"], "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "detail": r["detail"], "run_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    print(f"card: {harness.power_limit()}", flush=True)
    limit = cell.limits["mean_logit_gap"]
    print(" ".join(f"{k} correct on {sum(v)} of {len(v)} seeds at mean_logit_gap {limit};"
                   for k, v in verdicts.items()), flush=True)
    return 1 if any(verdicts["fp8"]) else 0


if __name__ == "__main__":
    sys.exit(main())
