"""Run one cell of the benchmark once on the card and print its result.

    python3 hapbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m hapbench.run ...``) from the root of a checkout. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers end
standard error. Without enough CUDA cards, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()  # process start, for setup_s: before anything is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# no module of these may be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The modules of ``names`` (by default those loaded) whose top-level
    name, the part before the first dot, is one of ``FORBIDDEN``, compared
    whole: ``repro_torch`` is not ``repro``."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache of the program inside the checkout, at a
    # fixed path: the kernel library builds under build/repro_torch/ there
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    from hapbench import harness, manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hapbench: {args.workload} needs {cell.chips} CUDA card(s), found {n}; no result", file=sys.stderr)
        return 2
    out_dir = ROOT / "hapbench_out"
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, out_dir)
    found = forbidden_modules()
    if found:
        print(f"hapbench: the run loaded {found}; no result", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for line in harness.as_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
