"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic and lists the metrics. Everything else is a
file of its own, found by name:

  the configuration   the file ``configs`` gives it (``hapbench/configs/<name>.json``)
  the traffic         ``hapbench/traffic/<traffic>.json``
  the limits          ``hapbench/limits/<cell>.json``: each number compared, its limit
  a metric            ``hapbench/metrics/<metric>.py``, whose ``read(record)``
                      returns the number, or None where it finds nothing to read

Adding a cell, a configuration, a traffic mix or a metric is adding files
and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]  # the manifest's entries of the metrics this cell reports
    per_layer: List[Dict]


def load(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "hapbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "hapbench" / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``hapbench/metrics/<metric>.py``."""
    path = root / "hapbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("hapbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
