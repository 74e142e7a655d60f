"""The slice on the kernel path: ``inbox_impl="pallas"`` on both packages.

The JAX package runs its Pallas kernels in interpret mode on the CPU;
the port's wrappers run their kernels' plain versions for CPU tensors.
Same configuration and bar as test_torch_kademlia.py (a): every leaf
equal after 128 ticks from a fresh start.
"""

from test_torch_engine import JaxCall, at, first_difference
from test_torch_kademlia import N, SEED, bench_sims


def test_fresh_start_leaf_exact_128_ticks_pallas():
    call = JaxCall("test_torch_kademlia", "jax_bench_states",
                   impl="pallas", seed=SEED, ticks=[0, 128])
    _, ts = bench_sims("pallas")
    b0 = b = ts.init(seed=SEED)
    for _ in range(128):
        b = ts.step(b)
    ref = call.result()
    assert first_difference(at(ref, 0), b0) is None
    assert first_difference(at(ref, 128), b) is None
    out = ts.summary(b)
    assert out["_alive"] == N and out["kbr_delivered"] > 0
