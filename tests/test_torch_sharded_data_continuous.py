"""The serving engine's continuous batching on a ``(data, model)`` mesh:
four gloo ranks on ``RankMesh(group, data=2)`` against the JAX engine on
``Mesh(devices.reshape(2, 2), ('data', 'model'))``, through
``tests/torch_sharded_data.py``.

The live slots split over the data axis; the block allocator, the prefix
cache and the scheduler stay one identical instance on every rank, driven
by the gathered tokens. Tokens, statuses, preemptions and the
``EngineStats`` counters must equal the JAX engine's, and the four ranks
must agree: the paged pool with the prefix cache (shared blocks,
copy-on-write), the contiguous fallback (``paged=False``), a ``max_batch``
that does not divide the data axis, the re-plan TP2 -> DP2 -> TP2 with
live requests (the live cache relayout), Hymba's contiguous run,
replication with the doctored router, an overcommitted pool that
preempts rows, deadlines and a cancel under four ranks' skewed clocks
(rank 0's verdicts hold on every rank), and a fault injected at the
allocator. Reduced configs in float32,
capacity factor 8.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_sharded_data import check_scenario, serve_both  # noqa: E402

DS = "deepseek-moe-16b"
TP2_EP2 = ["TP2", "EP2", "", "reshard"]
PREFIX = {"max_batch": 4, "prefix_cache": True, "kv_block_size": 8, "prefill_chunk": 8}

SCENARIOS = {
    "prefix": (DS, {}, TP2_EP2, PREFIX, True, "shared", False),
    "prefix_tp2": (DS, {}, ["TP2", "TP2", "", "reshard"], PREFIX, True, "shared", False),
    "prefix_odd_slots": (DS, {}, TP2_EP2, {**PREFIX, "max_batch": 3}, True, "shared", False),
    # a capacity that drops tokens in a fused step's 64-token chunk: its one row
    # (every data rank's) routes over data x ep, 16 tokens a shard, as the
    # reference's shard_map splits the global tokens
    "fused_drops": (DS, {"capacity_factor": 0.5}, TP2_EP2, {"max_batch": 4, "kv_block_size": 8, "prefill_chunk": 64},
                    True, "long", False),
    "contiguous": (DS, {}, TP2_EP2, {"max_batch": 4, "paged": False}, True, "base", False),
    "replan_paged": (DS, {}, "by_prompt", {"max_batch": 2, "kv_block_size": 8, "prefill_chunk": 8}, True,
                     "switch", False),
    "replan_contiguous": (DS, {}, "by_prompt", {"max_batch": 2, "paged": False}, True, "switch", False),
    "hymba_contiguous": ("hymba-1.5b", {}, ["TP2", "TP2", "", "reshard"], {"max_batch": 4}, True, "base", False),
    "replicated_continuous": (DS, {}, TP2_EP2, {"max_batch": 4, "replicate_experts": 2, "rebalance_interval": 2},
                              True, "base", True),
    "overcommit": (DS, {}, ["TP2", "TP2", "", "reshard"],
                   {"max_batch": 4, "kv_block_size": 4, "kv_blocks": 10, "kv_overcommit": 0.25}, True,
                   "overcommit", False),
    "lifecycle": (DS, {}, ["TP2", "TP2", "", "reshard"], {"max_batch": 2, "kv_block_size": 4}, True, "lifecycle",
                  False),
    # the fault sites fire alike on every rank: an injected allocation failure preempts a row
    "fault_kv_alloc": (DS, {}, TP2_EP2, {"max_batch": 4, "kv_block_size": 4, "faults": [["kv_alloc", "at", 9]]},
                       True, "base", False),
}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return serve_both(tmp_path_factory.mktemp("sharded_data_continuous"), SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_stats_equal_jax_engine(both, name):
    got = check_scenario(*both, name)
    if name == "lifecycle":  # uid 0 expires, uid 1 is cancelled live on rank 0 alone, the rest run out
        status = {d[0]: (d[2], len(d[1])) for d in got["done"]}
        assert status[0][0] == "deadline" and status[1][0] == "cancelled" and 0 < status[1][1] < 8
        assert status[2] == status[3] == ("ok", 8)
        assert (got["stats"]["deadline_expired"], got["stats"]["cancelled"]) == (1, 1)
        return
    assert all(d[2] == "ok" for d in got["done"])
    if name == "fused_drops":
        assert got["stats"]["fused_steps"] > 0
    if name.startswith("prefix"):
        assert got["stats"]["prefix_hit_blocks"] > 0 and got["stats"]["fused_steps"] > 0
    if name.startswith("replan"):
        assert got["stats"]["plan_switches"] == 2 and got["relayouts"] == 2
    if name in ("overcommit", "fault_kv_alloc"):
        assert got["stats"]["preemptions"] >= 1
    if name == "replicated_continuous":
        assert got["stats"]["replication_rebalances"] >= 1
