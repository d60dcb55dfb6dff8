"""Reading a ``torch.profiler`` trace of the timed jobs.

The window is the host span ``hapbench.window`` that the harness opens
around the traced jobs. From the device's events inside it (kernels,
copies and sets; annotations left out): the seconds in which any ran (their
union), each kernel's seconds by name, and the idle gaps between them, each
named by the host operation that overlapped it most (the innermost on a
tie), or ``host (no traced op)`` where Python ran between operations.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "hapbench.window"
SHORT_GAP_S = 20e-6  # gaps shorter than this are summed under one name
NO_OP = "host (no traced op)"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: Dict[str, float]  # seconds by full device op name, clipped to the window
    idle_s: Dict[str, float]  # idle seconds by the host op that overlapped each gap
    events: int


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The disjoint union of the (non-empty) intervals [start, end): its starts and ends."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def read(prof, out: Optional[Path] = None) -> Optional[Trace]:
    """The window's device busy time, kernel times and idle gaps; with
    ``out`` the device events are also written there (``.npz``)."""
    from torch._C._autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    w0 = w1 = None
    names: Dict[str, int] = {}
    dev: List[Tuple[int, int, int]] = []
    cpu: List[Tuple[int, int, int]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), names.setdefault(name, len(names))))
        elif name == WINDOW:
            w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), names.setdefault(name, len(names))))
    if w0 is None:
        return None
    by_id = {i: n for n, i in names.items()}
    d = np.array(dev, np.int64).reshape(-1, 3)
    d = d[(d[:, 1] > w0) & (d[:, 0] < w1)]
    ds, de = np.clip(d[:, 0], w0, w1), np.clip(d[:, 1], w0, w1)
    device_s: Dict[str, float] = collections.Counter()
    for i, dur in zip(d[:, 2], de - ds):
        device_s[by_id[int(i)]] += dur / 1e9
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(out, start_ns=ds - w0, dur_ns=de - ds, name=d[:, 2],
                            names=np.array(json.dumps([by_id[i] for i in range(len(by_id))])))
    busy = 0.0
    idle: Dict[str, float] = collections.Counter()
    if len(d):
        us, ue = _union(ds, de)
        busy = float((ue - us).sum()) / 1e9
        gs, ge = np.append(w0, ue), np.append(us, w1)
    else:
        gs, ge = np.array([w0]), np.array([w1])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    c = np.array(cpu, np.int64).reshape(-1, 3)
    c = c[np.argsort(c[:, 0], kind="stable")]
    lookback = int(1e9)
    for a, b in zip(gs, ge):
        if (b - a) / 1e9 < SHORT_GAP_S:
            idle[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += (b - a) / 1e9
            continue
        lo, hi = np.searchsorted(c[:, 0], [a - lookback, b])
        seg = c[lo:hi]
        ov = np.minimum(seg[:, 1], b) - np.maximum(seg[:, 0], a)
        if not len(seg) or ov.max() <= 0:
            idle[NO_OP] += (b - a) / 1e9
            continue
        best = np.lexsort((seg[:, 1] - seg[:, 0], -ov))[0]
        idle[by_id[int(seg[best, 2])]] += (b - a) / 1e9
    return Trace((w1 - w0) / 1e9, busy, dict(device_s), dict(idle), int(len(d)))


def breakdown(t: Trace, n: int = 10) -> Dict[str, List[list]]:
    """The device operations that took most time, by short name, and the
    idle time by what the host was doing: at most ``n`` of each."""
    ops: Dict[str, float] = collections.Counter()
    for name, s in t.device_s.items():
        ops[short_name(name)] += s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(t.idle_s.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k[:120], v] for k, v in gaps]}
