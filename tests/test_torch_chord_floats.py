"""Chord with the default float draws: statistics agree.

With ``init_deviation=2/16`` (the join schedule's normal draw) and
``jitter=0.1`` (the underlay's), the two packages' erfinv differ in the
last ulps, so the trajectories may part after the first jittered delay.
After 60 simulated seconds of bench.py's Chord configuration at N=16 the
end-of-run statistics are held to: ``_alive`` and ``kbr_sent`` within
2%, the delivery ratios within 0.05 of each other (and above 0.5),
mean ``lookup_hops`` within 10%.  Chord's delivery is itself well below
1 here (the reference's own figure; ROADMAP Queue C), so the bar is
agreement, not health.
"""

import pytest

from test_torch_chord import N, SEED, port_sim
from test_torch_engine import JaxCall

T_END_NS = 60 * 1_000_000_000


@pytest.mark.parametrize("seed", [SEED])
def test_default_floats_statistics_agree(seed):
    call = JaxCall("test_torch_chord", "jax_chord_summary", seed=seed,
                   t_end_ns=T_END_NS)
    sim = port_sim(deviation=2.0 / N, jitter=0.1)
    b = sim.init(seed)
    while int(b.t_now) < T_END_NS:
        b = sim.step(b)
    tb = sim.summary(b)
    ja = call.result()
    alive, sent = int(ja["alive"]), int(ja["kbr_sent"])
    assert abs(alive - tb["_alive"]) <= 0.02 * alive
    assert abs(sent - tb["kbr_sent"]) <= 0.02 * sent
    dj = int(ja["kbr_delivered"]) / sent
    dt = tb["kbr_delivered"] / tb["kbr_sent"]
    assert dj > 0.5 and abs(dj - dt) <= 0.05
    hj, ht = float(ja["lookup_hops"]), tb["lookup_hops"]["mean"]
    assert abs(hj - ht) <= 0.1 * hj
