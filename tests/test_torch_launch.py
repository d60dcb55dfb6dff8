"""The port's serve launcher and its supports against the JAX package's:
``cached_latency_model`` (memo, disk cache under a name of its own),
``make_host_mesh``, and ``python -m repro_torch.launch.serve`` against
``python -m repro.launch.serve``.

Both launchers run in process on the same flags. The printed report must
be the same line for line, with every millisecond figure masked (host
clocks), and the port's tokens, served from the reference's weights
bridged over, must equal the reference engine's (caught by wrapping its
``run``/``serve_continuous`` here). Both packages' latency-model memo is
seeded with fits on 40 samples, as ``test_torch_planner.py`` fits them, so
no test pays the ~1 min full fit. A subprocess runs the port's launcher on
its own and shows that neither JAX nor the JAX package is loaded.
"""

import os
import pickle
import re
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from repro.core import hap as jhap  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.core import hap, hardware, latency  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

N_SAMPLES = 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's trace generator at a CPU size: two buckets of 16 tokens
SMALL = ["--requests", "4", "--batch", "2", "--gen", "6", "--prompt-bucket", "16", "--prompt-len", "40"]
FLAG_SETS = {
    "default": [],
    "continuous_prefix": ["--continuous", "--prefix-cache"],
    "continuous_overcommit": ["--continuous", "--kv-overcommit", "0.25"],
    "pinned_plan": ["--plan", "attn=TP4,prefill=EP4,decode=TP4"],
}


@pytest.fixture(scope="module")
def fits():
    """Latency models fitted on the same 40 samples in each package."""
    return (jlat.LatencyModel(jhw.get_chip("a6000"), n_samples=N_SAMPLES),
            latency.LatencyModel(hardware.get_chip("a6000"), n_samples=N_SAMPLES))


@pytest.fixture
def seeded(fits, monkeypatch):
    monkeypatch.setitem(jlat._MODEL_CACHE, ("a6000", 0), fits[0])
    monkeypatch.setitem(latency._MODEL_CACHE, ("a6000", 0), fits[1])
    return fits


def test_cached_latency_model_memo_and_disk(fits, tmp_path, monkeypatch):
    """One model per (chip, seed); the disk cache round-trips it under
    ``latency_torch_*``, never the reference's ``latency_*`` file, which a
    load from the same directory leaves unread."""
    # a fit on 40 samples, as ``fits`` made it: the full fit takes ~1 min
    monkeypatch.setattr(latency.LatencyModel.__init__, "__defaults__", (0, N_SAMPLES))
    (tmp_path / "latency_a6000_0.pkl").write_bytes(b"the JAX package's pickle: not for the port")
    monkeypatch.delitem(latency._MODEL_CACHE, ("a6000", 0), raising=False)
    first = latency.cached_latency_model("a6000", disk_dir=str(tmp_path))
    assert latency.cached_latency_model("a6000", disk_dir=str(tmp_path)) is first
    assert sorted(os.listdir(tmp_path)) == ["latency_a6000_0.pkl", "latency_torch_a6000_0.pkl"]
    # a fresh process's memo: the model comes back from the disk
    assert first.predict_comm([1e6, 1e8]).tolist() == fits[1].predict_comm([1e6, 1e8]).tolist()
    latency._MODEL_CACHE.pop(("a6000", 0))
    monkeypatch.setattr(latency.LatencyModel.__init__, "__defaults__", None)  # a refit would raise
    again = latency.cached_latency_model("a6000", disk_dir=str(tmp_path))
    assert again is not first and type(again).__module__ == "repro_torch.core.latency"
    assert again.predict_comm([1e6, 1e8]).tolist() == fits[1].predict_comm([1e6, 1e8]).tolist()
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    latency._MODEL_CACHE.pop(("a6000", 0))
    assert latency.cached_latency_model("a6000").predict_comm([3e7]).tolist() == fits[1].predict_comm([3e7]).tolist()
    latency._MODEL_CACHE.pop(("a6000", 0))


def test_make_host_mesh_needs_a_group():
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh()


def _masked(text: str):
    """The printed lines, every millisecond figure masked."""
    return [re.sub(r"\d+(\.\d+)? ms", "<t> ms", line) for line in text.strip().splitlines()]


def _reference(flags, capsys):
    """The reference launcher on ``flags``: (its lines, its tokens, its
    weights)."""
    caught = {}
    with pytest.MonkeyPatch.context() as m:
        for name in ("run", "serve_continuous"):
            orig = getattr(jengine.InferenceEngine, name)

            def wrapped(self, *a, _orig=orig, **k):
                out = _orig(self, *a, **k)
                caught.update(tokens=[c.tokens for c in out], params=self.params)
                return out

            m.setattr(jengine.InferenceEngine, name, wrapped)
        m.setattr(sys, "argv", ["serve", *flags])
        jserve.main()
    return capsys.readouterr().out, caught["tokens"], caught["params"]


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_launcher_equals_reference(name, seeded, monkeypatch, capsys):
    flags = SMALL + FLAG_SETS[name]
    # the planners' ILP clock stopped: the predicted speedup counts the
    # solve's wall time, which no two runs share
    for mod in (jhap, hap):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: 0.0))
    want_lines, want_tokens, jparams = _reference(flags, capsys)
    done, eng = serve.main(flags + ["--device", "cpu"], params=params_from_numpy(jparams, "cpu"))
    got_lines = capsys.readouterr().out
    eng.close()
    assert _masked(got_lines) == _masked(want_lines)
    assert [c.tokens for c in done] == want_tokens
    assert len(want_tokens) == 4 and all(len(t) == 6 for t in want_tokens)


def test_launcher_refuses_as_the_reference_does(seeded, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--source", "fixed", "--device", "cpu"])
    assert "--source fixed requires --plan" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(SMALL + ["--prefix-cache", "--device", "cpu"])
    assert "--prefix-cache requires --continuous (paged serving)" in capsys.readouterr().err


def test_launcher_subprocess_loads_no_jax(fits, tmp_path):
    """``python -m repro_torch.launch.serve --device cpu`` on its own, its
    latency model read from the disk cache: it serves, and neither ``jax``
    nor ``repro`` is loaded."""
    with open(tmp_path / "latency_torch_a6000_0.pkl", "wb") as f:
        pickle.dump(fits[1], f)
    code = ("import runpy, sys\n"
            "sys.argv = ['serve'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
            "finally:\n"
            "    loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "    print('LOADED', loaded)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_CACHE_DIR=str(tmp_path),
               OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code, *SMALL, "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert "served 4 requests, 24 tokens in 2 batches" in r.stdout
    assert "repro_torch.session: planned" in r.stderr
