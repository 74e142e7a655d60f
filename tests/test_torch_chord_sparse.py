"""Chord's sparse active-set tick under lifetime churn: port against JAX.

Chord + KBRTest (test interval 1 s) at the JAX package's sparse-test
size (tests/test_torch_sparse.py's configuration: 12 target = 24 slots,
lifetime mean 8 s, 1 s graceful leave, window 0.1 s, 4 inbox slots, pool
factor 4), with ``init_deviation = jitter = 0``: after 64 ticks every
SimState leaf (the sparse counters included) equals the JAX sparse tick's,
at the auto cap (all 24 lanes) and at ``active_cap=2``, where awake
nodes defer.  The Chord logic steps only the lanes it is given
(``node_idx``), so this is the engine's generic sparse plane over a
second overlay's state tree.
"""

import pytest

from test_torch_chord import SEED, SPARSE_TICKS, at, port_run
from test_torch_engine import first_difference, fresh_jax_call


@pytest.fixture(scope="module")
def ref():
    return fresh_jax_call("test_torch_chord", "jax_chord_runs", seed=SEED,
                          runs=["sparse", "cap2"])


@pytest.mark.parametrize("name", ["sparse", "cap2"])
def test_sparse_tick_under_lifetime_churn_leaf_exact(ref, name):
    sim, b = port_run(name)
    if name == "sparse":
        assert first_difference(at(ref, name, 0), sim.init(SEED)) is None
    assert first_difference(at(ref, name, SPARSE_TICKS), b) is None
    eng = sim.summary(b)["_engine"]
    assert eng["awake_nodes"] > 0 and eng["dest_unavailable_lost"] > 0
    assert (eng["active_deferred"] > 0) == (name == "cap2")
