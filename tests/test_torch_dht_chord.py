"""Chord + DHT and the replica-team variant on both packages, leaf-exact.

test_torch_dht.py's configuration (16 slots under lifetime churn, normal
draws off) with:

(a) Chord + DHT for 120 ticks: every SimState leaf equal.  The run
    crosses new-predecessor handovers — the update() deltas that Chord
    marks urgent, which preempt an active maintenance pump — besides
    the successor-list deltas, the maintenance puts and graceful-leave
    handovers; the app's ``dist_fn`` is Chord's clockwise distance,
    bound by the overlay;
(b) Kademlia + DHT with ``variant="repeated", num_replica_teams=2`` for
    120 ticks: every leaf equal, with the second team's continuation
    lookups (``op_cont``) issued.
"""

import pytest

from test_torch_dht import (SEED, TICKS, assert_hooks_fired, at,
                            port_runs, tally)
from test_torch_engine import JaxCall, first_difference


@pytest.fixture(scope="module")
def runs():
    call = JaxCall("test_torch_dht", "jax_dht_runs", seed=SEED,
                   runs=["chord", "repeated"])
    return port_runs(["chord", "repeated"], call)


def test_chord_dht_leaf_exact_across_urgent_handover(runs):
    ref, port = runs
    sim, s0, b = port["chord"]
    assert first_difference(at(ref, "chord", 0), s0) is None
    assert first_difference(at(ref, "chord", TICKS), b) is None
    assert_hooks_fired(sim, b, "dht_mnt_puts", "update_staged",
                       "update_urgent", "handover_sends")
    assert sim.logic.app.dist_fn is not None


def test_repeated_variant_leaf_exact(runs):
    ref, port = runs
    sim, _, b = port["repeated"]
    assert first_difference(at(ref, "repeated", TICKS), b) is None
    assert_hooks_fired(sim, b, "team_lookups")
    assert tally(sim)["team_lookups"] > 0
