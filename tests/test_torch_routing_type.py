"""``**.routingType`` in an ini: each value builds the JAX builder's
LookupConfig for Chord, Kademlia and Pastry (``config/scenario.py
build_lookup_config`` on both packages, every field equal).  A recursive
value no longer raises; as in the JAX builder it gives Chord and
Kademlia an iterative lookup, and Pastry keeps its own semi-recursive
default (ROADMAP Queue C).
"""

import dataclasses

import pytest

from oversim_tpu_torch.config import ini as tini
from oversim_tpu_torch.config import scenario as tsc
from test_torch_pastry_dht import KBR_INI


@pytest.mark.parametrize("rt", ["iterative", "semi-recursive",
                                "full-recursive", "source-routing-recursive",
                                "exhaustive-iterative"])
def test_routing_type_builds_the_jax_builders_lookup(rt):
    from oversim_tpu.config import ini as jini
    from oversim_tpu.config import scenario as jsc
    for proto, merge in (("chord", False), ("kademlia", True),
                         ("pastry", False)):
        text = KBR_INI.format(mod="x").replace("semi-recursive", rt)
        want = jsc.build_lookup_config(jini.IniFile.loads(text), "C", proto,
                                       merge)
        got = tsc.build_lookup_config(tini.IniFile.loads(text), "C", proto,
                                      merge)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
