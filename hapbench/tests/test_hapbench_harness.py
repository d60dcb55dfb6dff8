"""The harness on the CPU: traffic from the seed, cells found by name, the
manifest within the benchmark's rules, a run that finds no card, and whole
runs of a tiny cell."""

import dataclasses
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest

from conftest import ROOT, TINY, TINY_TRAFFIC
from hapbench import harness, manifest, traffic, weights

CELLS = ["deepseek-moe-16b.azure_conv", "mixtral-8x7b-l16.azure_code"]
SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


def lengths(reqs):
    return Counter((len(r.prompt), r.new_tokens) for r in reqs)


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_the_same_for_a_seed_and_differs_across_seeds(cell):
    c = manifest.cell(cell)
    V = c.config["vocab_size"]
    jobs = {s: traffic.job(c.traffic, V, s, 0) for s in SEEDS}
    again = traffic.job(c.traffic, V, SEEDS[2], 0)
    assert all(np.array_equal(a.prompt, b.prompt) and a.new_tokens == b.new_tokens
               for a, b in zip(again, jobs[SEEDS[2]]))
    firsts = {s: tuple(j[0].prompt[:16]) for s, j in jobs.items()}
    assert len(set(firsts.values())) == len(SEEDS)
    # every seed runs the same schedule: the same lengths in the same order
    order = [(len(r.prompt), r.new_tokens) for r in jobs[0]]
    assert all([(len(r.prompt), r.new_tokens) for r in j] == order for j in jobs.values())
    # the next job of a run: the same work in another order, other tokens
    second = traffic.job(c.traffic, V, SEEDS[1], 1)
    assert lengths(second) == lengths(jobs[0]) and [(len(r.prompt), r.new_tokens) for r in second] != order
    assert not np.array_equal(second[0].prompt, jobs[SEEDS[1]][0].prompt)
    t = c.traffic
    for r in jobs[0]:
        assert t["prompt_tokens"]["min"] <= len(r.prompt) <= t["prompt_tokens"]["max"]
        assert t["new_tokens"]["min"] <= r.new_tokens <= t["new_tokens"]["max"]
        assert 0 <= r.prompt.min() and r.prompt.max() < V
    assert len(jobs[0]) == t["requests_per_job"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_warm_job_covers_every_last_chunk_of_the_traffic(cell):
    c = manifest.cell(cell)
    want = {traffic.final_chunk(len(r.prompt), c.traffic) for r in traffic.job(c.traffic, 100, 1, 0)}
    warm = traffic.warm_job(c.traffic, 100, 1)
    assert {traffic.final_chunk(len(r.prompt), c.traffic) for r in warm} == want
    assert len(warm) == len(want) and all(r.new_tokens == c.traffic["warm_new_tokens"] for r in warm)


def test_shared_prefixes_are_shared_within_a_job():
    t = dict(TINY_TRAFFIC, shared_prefix=dict(groups=2, tokens=dict(dist="fixed", value=24)))
    reqs = traffic.job(t, 100, 3, 0)
    heads = {tuple(r.prompt[:24]) for r in reqs}
    assert len(heads) == 2
    assert all(len(r.prompt) >= 24 + t["prompt_tokens"]["min"] for r in reqs)


def test_weights_come_from_the_seed():
    a, b, c = (weights.make(TINY, s, "cpu") for s in (5, 5, 6))
    assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(_leaves(a), _leaves(b)))
    assert not np.array_equal(a["embed"].numpy(), c["embed"].numpy())
    assert a["layers"]["moe"]["wi_gate"].shape == (2, 4, 64, 32)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_manifest_keeps_the_benchmark_rules():
    bench = manifest.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["hapbench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hapbench/") and (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and all(k in conf for k in c["reduced"])
    wl = bench["workloads"]
    assert len({(w["config"], w["traffic"]) for w in wl}) == len(wl)
    for w in wl:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (ROOT / "hapbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "hapbench" / "limits" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in wl}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "out_tok_s", "peak_mem_gib"} <= e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells and UNIT.match(m["unit"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "hapbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_resolves_by_name(cell):
    c = manifest.cell(cell)
    assert c.config["name"] == cell.split(".")[0] and c.limits["mean_logit_gap"] > 0
    assert {m["name"] for m in c.end_to_end} == {"out_tok_s", "peak_mem_gib", "setup_s"}
    assert all(callable(manifest.reader(m["name"])) for m in c.end_to_end + c.per_layer)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_config_traffic_and_metric_are_added_as_files_alone(tmp_path):
    """A later change adds a cell by adding files and entries: no file of the
    benchmark changes, and the harness finds each piece by its name."""
    shutil.copytree(ROOT / "hapbench", tmp_path / "hapbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path / "hapbench")
    h = tmp_path / "hapbench"
    (h / "configs" / "tiny-moe.json").write_text(json.dumps(dict(TINY, name="tiny-moe")))
    (h / "traffic" / "tiny_shared.json").write_text(json.dumps(dict(
        TINY_TRAFFIC, shared_prefix=dict(groups=2, tokens=dict(dist="fixed", value=32)),
        engine=dict(TINY_TRAFFIC["engine"], prefix_cache=True))))
    (h / "limits" / "tiny-moe.tiny_shared.json").write_text(json.dumps({"mean_logit_gap": 0.5}))
    (h / "metrics" / "jobs_run.py").write_text("def read(rec):\n    return rec.jobs\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-moe", "source": "a test", "file": "hapbench/configs/tiny-moe.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-moe.tiny_shared", "config": "tiny-moe", "traffic": "tiny_shared",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "jobs_run", "unit": "jobs", "better": "higher", "source": "host_clock",
                               "layer": "engine loop (serving/engine.py)", "moves": "out_tok_s",
                               "workloads": ["tiny-moe.tiny_shared"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path / "hapbench")
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added
    c = manifest.cell("tiny-moe.tiny_shared", root=tmp_path)
    assert c.config["name"] == "tiny-moe" and c.traffic["engine"]["prefix_cache"] is True
    assert [m["name"] for m in c.per_layer] == ["jobs_run"]
    blank = {f.name: None for f in dataclasses.fields(harness.Record)}
    assert manifest.reader("jobs_run", root=tmp_path)(harness.Record(**{**blank, "jobs": 3})) == 3
    assert manifest.cell(CELLS[0], root=tmp_path).per_layer == manifest.cell(CELLS[0]).per_layer


def test_a_run_without_a_card_fails_and_prints_no_result():
    res = subprocess.run([sys.executable, "hapbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA" in res.stderr


def test_a_run_outside_a_checkout_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run."""
    shutil.copytree(ROOT / "hapbench", tmp_path / "hapbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "hapbench/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "{" not in res.stdout


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_whole_on_the_cpu(tiny_cell, trace):
    r = harness.run_cell(tiny_cell, 2**31 + 9, 0.0, bool(trace), "cpu", time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] == TINY_TRAFFIC["requests_per_job"]
    assert list(r)[-1] == "checks" and r["checks"]["mean_logit_gap"]["value"] < 1e-3
    if trace:
        assert {"decode_step_ms", "rows_per_step", "host_gap_share", "mfu"} <= set(r["metrics"])
        # no device: no device metric, never a 0 in its place
        assert not {"gmm_roofline", "other_device_share", "idle_share"} & set(r["metrics"])
        assert r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {"out_tok_s", "setup_s"}  # no card: no memory peak
    assert r["detail"]["decode_steps"] > 0 and r["detail"]["checked_tokens"] >= 3 * 4


def test_the_engine_and_the_traffic_must_agree_on_the_prompt_bucket(tiny_cell):
    tiny_cell.traffic["prompt_bucket"] = 16
    with pytest.raises(ValueError, match="pads prompts"):
        harness.run_cell(tiny_cell, 1, 0.0, False, "cpu", time.perf_counter())


class _Event:
    def __init__(self, name, device, start, dur, annotation=False):
        from torch._C._autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_the_trace_reader_takes_busy_time_kernels_and_idle_gaps(tmp_path):
    from types import SimpleNamespace

    from hapbench import trace as trace_mod

    us = 1000
    events = [
        _Event(trace_mod.WINDOW, False, 0, 1000 * us, annotation=True),
        _Event("void repro::grouped_matmul_wgmma_kernel<__nv_bfloat16>(int)", True, 100 * us, 300 * us),
        _Event("void at::native::elementwise_kernel<4>(int)", True, 350 * us, 100 * us),  # overlaps the first
        _Event("Memcpy HtoD (Pinned -> Device)", True, 600 * us, 50 * us),
        _Event("a device annotation", True, 0, 1000 * us, annotation=True),  # not device work
        _Event("cudaGraphLaunch", False, 460 * us, 100 * us),
        _Event("cudaStreamSynchronize", False, 650 * us, 400 * us),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    t = trace_mod.read(prof, tmp_path / "t.npz")
    assert t.window_s == 1e-3 * 1 and t.events == 3
    assert abs(t.busy_s - 400e-6) < 1e-12  # [100, 450) and [600, 650) us
    assert abs(t.device_s["void repro::grouped_matmul_wgmma_kernel<__nv_bfloat16>(int)"] - 300e-6) < 1e-12
    # gaps: [0, 100) no host op, [450, 600) mostly the graph launch, [650, 1000) the sync
    assert abs(t.idle_s[trace_mod.NO_OP] - 100e-6) < 1e-12
    assert abs(t.idle_s["cudaGraphLaunch"] - 150e-6) < 1e-12
    assert abs(t.idle_s["cudaStreamSynchronize"] - 350e-6) < 1e-12
    b = trace_mod.breakdown(t)
    assert b["device_ops"][0] == ["repro::grouped_matmul_wgmma_kernel", 300e-6]
    assert (tmp_path / "t.npz").is_file()
