"""The port's robustness layer (DESIGN.md §4f) on two gloo ranks against the
JAX engine on a two-device mesh ``(1, 2)`` of ``('data', 'model')``.

Under TP2/TP2 (``tests/test_faults.py``'s TP2 mesh case) an overcommitted
pool preempts rows and replays them; the port's two ranks must give the JAX
engine's tokens, statuses, preemptions and counters, and each other's. A
rank's clock and a cancel are its own, so the engine takes rank 0's
verdicts at each boundary: with rank 1's clock running at three times rank
0's rate, and a live request cancelled on rank 0 only, both ranks retire
the same requests at the same steps, as the JAX engine does on rank 0's
clock. Reduced DeepSeekMoE-16B in float32 with capacity factor 8.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from torch_sharded import load_tree, run_jax, run_ranks  # noqa: E402

REQS = [[list(range(1, 13)), 8], [list(range(3, 12)), 8], [[5, 4, 3, 2, 1], 8]]
LIFECYCLE = [[[1, 2, 3], 8, 4000.0], [[4, 5, 6, 7], 8, None], [[8, 9], 8, None], [[10, 11, 12], 8, 20000.0]]
CANCEL = (1, 6)  # (uid, after this many steps)
COUNTERS = ("joins", "decode_steps", "prefill_chunks", "fused_steps", "preemptions", "preempted_tokens",
            "cancelled", "deadline_expired", "background_errors")

# name -> engine keywords
SCENARIOS = {
    "overcommit": dict(max_batch=3, kv_block_size=4, kv_blocks=10, kv_overcommit=0.25),
    "lifecycle": dict(max_batch=2, kv_block_size=4),
}

_JAX = """
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core import HAPSession
from repro.core.hap import fixed_plan
from repro.models import init_params
from repro.serving import Request
from torch_sharded import save_tree

out, scen, reqs, life, cancel, counters = sys.argv[1], *map(json.loads, sys.argv[2:7])
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ('data', 'model'))
cfg = dataclasses.replace(get_config('deepseek-moe-16b').reduced(), dtype='float32', capacity_factor=8.0)
params = init_params(cfg, jax.random.PRNGKey(0))
save_tree(f"{out}/params.npz", params)
res = {}
for name, kw in scen.items():
    session = HAPSession(cfg, 'a6000', 2, source=fixed_plan('TP2', 'TP2'), mesh=mesh, prompt_bucket=16,
                         gen_bucket=8)
    eng = session.engine(params, **kw)
    if name == 'overcommit':
        for p, g in reqs:
            eng.submit(Request(prompt=p, max_new_tokens=g))
    else:
        eng.clock = lambda: float(eng.stats.decode_steps)  # rank 0's clock
        for p, g, d in life:
            eng.submit(Request(prompt=p, max_new_tokens=g, deadline_ms=d))
        step, steps = eng.step, [0]
        def counted(*a):
            steps[0] += 1
            if steps[0] == cancel[1]:
                eng.cancel(cancel[0])
            return step(*a)
        eng.step = counted
    comps = eng.serve_continuous()
    res[name] = {"done": [[c.uid, c.tokens, c.status, c.preemptions] for c in comps],
                 "stats": {k: getattr(eng.stats, k) for k in counters}}
json.dump(res, open(f"{out}/faults.json", "w"))
print("OK")
"""


def ranks_faults(mesh, data: str, scenarios: dict):
    """One rank: both scenarios through the port's engine on this rank's
    TP2 shard of the JAX weights. Rank 1's clock runs at three times rank
    0's rate, and only rank 0 cancels."""
    from repro_torch.configs import get_config
    from repro_torch.core import HAPSession, fixed_plan
    from repro_torch.models import params_from_numpy
    from repro_torch.models.params import shard_params
    from repro_torch.serving import Request

    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype="float32", capacity_factor=8.0)
    hap = fixed_plan("TP2", "TP2")
    splan = hap.to_sharding_plan(mesh, cfg, phase="prefill")
    params = params_from_numpy(shard_params(load_tree(f"{data}/params.npz"), cfg, splan, mesh.rank), "cpu")
    res = {}
    for name, kw in scenarios.items():
        session = HAPSession(cfg, "a6000", 2, source=hap, mesh=mesh, prompt_bucket=16, gen_bucket=8)
        eng = session.engine(params, device="cpu", params_plan=splan, **kw)
        if name == "overcommit":
            for p, g in REQS:
                eng.submit(Request(prompt=p, max_new_tokens=g))
        else:
            rate = 1.0 + 2.0 * mesh.rank
            eng.clock = lambda: rate * eng.stats.decode_steps
            for p, g, d in LIFECYCLE:
                eng.submit(Request(prompt=p, max_new_tokens=g, deadline_ms=d))
            step, steps = eng.step, [0]

            def counted(*a):
                steps[0] += 1
                if steps[0] == CANCEL[1] and mesh.rank == 0:
                    eng.cancel(CANCEL[0])
                return step(*a)

            eng.step = counted
        comps = eng.serve_continuous()
        res[name] = {"done": [[c.uid, c.tokens, c.status, c.preemptions] for c in comps],
                     "stats": {k: getattr(eng.stats, k) for k in COUNTERS}}
        eng.close()
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX engine's results, the port's two ranks' results)."""
    work = tmp_path_factory.mktemp("sharded_faults")
    run_jax(_JAX, str(work), *map(json.dumps, (SCENARIOS, REQS, LIFECYCLE, CANCEL, COUNTERS)), timeout=600)
    with open(work / "faults.json") as f:
        jax_res = json.load(f)
    ranks = run_ranks("test_torch_sharded_faults:ranks_faults", work / "ranks", timeout=600, data=str(work),
                      scenarios=SCENARIOS)
    return jax_res, ranks


def test_tp2_preemption_equals_jax_engine(both):
    jax_res, ranks = both
    got = ranks[0]["overcommit"]
    assert ranks[1]["overcommit"] == got
    assert got == jax_res["overcommit"]
    assert got["stats"]["preemptions"] >= 1 and all(d[2] == "ok" for d in got["done"])


def test_skewed_clocks_retire_alike(both):
    """Rank 0's verdicts hold on both ranks. Rank 1's clock alone would
    expire uid 0 two decode steps early, and uid 3, which rank 0 lets run
    to its budget; uid 1, cancelled on rank 0 only, retires live on both
    with its partial output."""
    jax_res, ranks = both
    got = ranks[0]["lifecycle"]
    assert ranks[1]["lifecycle"] == got
    assert got == jax_res["lifecycle"]
    status = {d[0]: (d[2], len(d[1])) for d in got["done"]}
    assert status[0] == ("deadline", 5)
    assert status[1][0] == "cancelled" and 0 < status[1][1] < 8
    assert status[2] == status[3] == ("ok", 8)
    assert (got["stats"]["deadline_expired"], got["stats"]["cancelled"]) == (1, 1)
