"""Kademlia + DHT on the sparse active-set tick: port against JAX.

test_torch_dht.py's configuration (16 slots under lifetime churn, normal
draws off) on ``tick_impl="sparse"``: after 120 ticks every SimState leaf
equals the JAX sparse tick's — the truth map (``app_glob``), which the
sparse step leaves whole while it gathers and scatters node rows only,
included — at the auto cap (all 16 lanes) and at ``active_cap=2``, where
awake nodes defer.  A node with an active maintenance pump stays awake
(the DHT's ``next_event`` is 0 while it pumps).
"""

import pytest

from test_torch_dht import SEED, TICKS, assert_hooks_fired, at, \
    port_runs
from test_torch_engine import JaxCall, first_difference


@pytest.fixture(scope="module")
def runs():
    call = JaxCall("test_torch_dht", "jax_dht_runs", seed=SEED,
                   runs=["sparse", "cap2"])
    return port_runs(["sparse", "cap2"], call)


@pytest.mark.parametrize("name", ["sparse", "cap2"])
def test_sparse_tick_dht_leaf_exact(runs, name):
    ref, port = runs
    sim, s0, b = port[name]
    if name == "sparse":
        assert first_difference(at(ref, name, 0), s0) is None
    assert first_difference(at(ref, name, TICKS), b) is None
    assert_hooks_fired(sim, b, "dht_mnt_puts")
    eng = sim.summary(b)["_engine"]
    assert eng["awake_nodes"] > 0 and eng["dest_unavailable_lost"] > 0
    assert (eng["active_deferred"] > 0) == (name == "cap2")
