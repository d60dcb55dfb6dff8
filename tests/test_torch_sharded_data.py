"""The serving engine's static batches (``run()``) on a ``(data, model)``
mesh: four gloo ranks on ``RankMesh(group, data=2)`` against the JAX engine
on ``Mesh(devices.reshape(2, 2), ('data', 'model'))`` (four forced host
devices), through ``tests/torch_sharded_data.py``.

Each data rank prefills and decodes its block of a batch's rows under the
plan's TP/EP layout of its model row; a batch that does not divide the
data axis (three rows, one row) runs with the axis dropped. Tokens and the
``EngineStats`` counters must equal the JAX engine's, and the four ranks
must agree, under TP2/EP2, DP2/EP2, DP2xTP2/EP4, the reshard and INT4
switches, resident INT4, EP2 at a capacity that drops tokens (per
(data, ep) shard, as the reference's), Hymba, replication with the
doctored router, a failed background restore, and a static ``plan=``
under FSDP and under sequence parallelism. Reduced configs in float32, capacity factor 8 unless stated.
At a temperature the tokens do not depend on the layout: they equal one
process's from the same seed.
"""

import pytest

torch = pytest.importorskip("torch")

from torch_sharded_data import check_scenario, serve_both  # noqa: E402

DS = "deepseek-moe-16b"
B4 = {"max_batch": 4}

SCENARIOS = {
    "tp2_ep2": (DS, {}, ["TP2", "EP2", "", "reshard"], B4, False, "base", False),
    "tp2_ep2_b3": (DS, {}, ["TP2", "EP2", "", "reshard"], {"max_batch": 3}, False, "base", False),
    "dp2_ep2": (DS, {}, ["DP2", "EP2", "", "reshard"], B4, False, "base", False),
    "dp2xtp2_ep4": (DS, {}, ["DP2xTP2", "EP4", "", "reshard"], B4, False, "base", False),
    "switch_reshard": (DS, {}, ["TP2", "EP2", "TP2", "reshard"], B4, False, "base", False),
    "switch_int4": (DS, {}, ["TP2", "EP2", "TP2", "int4_upload"], {**B4, "use_int4_transition": True}, False,
                    "base", False),
    "resident_int4": (DS, {}, ["TP2", "EP2", "TP2", "int4_upload"],
                      {**B4, "use_int4_transition": True, "resident_int4": True}, False, "base", False),
    # each (data, ep) shard routes its quarter of the tokens with its own capacity
    "ep2_drops": (DS, {"capacity_factor": 0.5}, ["TP2", "EP2", "", "reshard"], B4, False, "base", False),
    "hymba_tp2": ("hymba-1.5b", {}, ["TP2", "TP2", "", "reshard"], B4, False, "base", False),
    "replicated_ep2": (DS, {}, ["TP2", "EP2", "", "reshard"],
                       {**B4, "replicate_experts": 2, "rebalance_interval": 2}, False, "base", True),
    # a fault at the background restore fires alike on every rank: each fails over to the sync relayout
    "fault_restore": (DS, {}, ["TP2", "EP2", "TP2", "int4_upload"],
                      {**B4, "use_int4_transition": True, "faults": [["restore", "times", 1]]}, False, "base", False),
    "static_fsdp": (DS, {}, "static_fsdp", B4, False, "base", False),
    "static_sp": (DS, {}, "static_sp", B4, False, "base", False),
}


# served by the ranks alone, at a temperature (``torch_sharded_data.SAMPLED``)
SAMPLED = {"sampled_twins": (DS, {}, ["TP2", "EP2", "", "reshard"], B4, False, "twins", False)}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return serve_both(tmp_path_factory.mktemp("sharded_data"), SCENARIOS, SAMPLED)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tokens_and_stats_equal_jax_engine(both, name):
    got = check_scenario(*both, name)
    assert all(len(d[1]) == 6 for d in got["done"])
    if name == "fault_restore":
        assert got["stats"]["restore_errors"] == got["stats"]["background_errors"] >= 1
    if name == "replicated_ep2":
        assert got["stats"]["replication_rebalances"] >= 1 and got["rep"] is not None


def test_static_cache_holds_the_ranks_rows(both):
    """A batch of B rows that divides the data axis: each rank's static
    cache holds its B/2 rows; one that does not (3, 1): every row, the
    data axis dropped. Under FSDP (rows over both axes) B/4."""
    _, ranks = both
    for r in ranks:
        assert r["tp2_ep2"]["rows"] == [(4, 2)]
        assert r["tp2_ep2_b3"]["rows"] == [(1, 1), (3, 3)]
        assert r["static_fsdp"]["rows"] == [(4, 1)]
        assert r["tp2_ep2"]["dp_axes"] == ["data"]
    assert sorted(r["tp2_ep2"]["coords"]["data"] * 2 + r["tp2_ep2"]["coords"]["model"] for r in ranks) == [0, 1, 2, 3]


def test_temperature_draws_do_not_depend_on_the_layout(both):
    """At a temperature every rank draws the whole batch's noise and keeps
    its rows': the same prompt in the two data blocks (rows 0 and 2)
    samples apart, and the four ranks' tokens equal one process's from
    the same seed."""
    _, ranks = both
    got = ranks[0]["sampled_twins"]
    assert all(r["sampled_twins"]["done"] == got["done"] for r in ranks[1:])
    toks = {uid: t for uid, t, *_ in got["done"]}
    assert len(toks[0]) == len(toks[2]) == 8 and toks[0] != toks[2]
    assert got["done"] == got["one"]
