"""oversim_tpu_torch — the PyTorch/CUDA port of ``oversim_tpu``.

A second package beside ``oversim_tpu/`` (the JAX reference, which it
never imports).  It mirrors the reference's layout and names; state is
dataclasses of tensors with the reference's field names, per-node logic
is written batched over a leading ``[N]`` axis, and random numbers come
from ``rng.py``, a bit-exact copy of ``jax.random``'s threefry.  The TPU
kernels on the main path are hand-written CUDA kernels for Hopper under
``csrc/``, built with ``nvcc`` at first use (``kernels/``).

Entry points (``engine.sim.Simulation``) run on the card unless the
caller passes ``device="cpu"``.  Ported so far: Kademlia + KBRTest and
Chord + KBRTest (Chord's default configuration: replace-mode lookups,
Vivaldi coordinates, the NeighborCache RTT estimator) on the dense tick
and on the sparse active-set tick, under NoChurn or LifetimeChurn, over
SimpleUnderlay (ROADMAP Queue A items 1-9), the DHT + DHTTestApp
stack (``apps.dht``) over either overlay (item 14(a)), campaigns of
seed and parameter-sweep replicas (``campaign``) with telemetry rings
(``telemetry``) and ensemble statistics (item 11), and the service plane
(item 12): checkpoints (``checkpoint``), the double-buffered serving
loop with bit-identical resume (``service``), and request serving
through the gateway (``gateway``, ``apps.realworld``).
"""

from oversim_tpu_torch.apps.dht import DhtApp, DhtParams  # noqa: F401
from oversim_tpu_torch.apps.kbrtest import (  # noqa: F401
    KbrTestApp, KbrTestParams)
