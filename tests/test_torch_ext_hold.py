"""The engine's ``ext_hold_slot``: EXT_OUT answers addressed to the
gateway slot stay in the pool for the service loop's drain.

As tests/test_service.py does for the JAX package: the hold keeps such
answers out of the inbox on the scatter and sort oracles and on the
inbox kernels' plain version, everything else delivers, and without the
hold the answer would be consumed; a Simulation with ``ext_hold_slot=0``
keeps an echo answer in the pool tick after tick on both inbox impls.
Kept apart from test_torch_gateway.py so that each test file stays small
(ROADMAP: xdist's ``loadfile`` queue is ordered by tests per file).
"""

import torch

from oversim_tpu_torch.apps.realworld import RealworldEchoApp
from oversim_tpu_torch.engine import pool as pool_mod
from oversim_tpu_torch.engine import sim as tsim
from oversim_tpu_torch.gateway import EXT_OUT, ExtFrame, inject_ext_batch
from oversim_tpu_torch.kernels import inbox as inbox_k
from test_torch_gateway import _echo_sim, _pool_state

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)


def test_ext_hold_parks_ext_out_on_scatter_and_kernel_plain_path():
    """An EXT_OUT to the held slot stays out of the inbox; everything
    else delivers, on the scatter and sort oracles and the inbox
    kernels' plain version; a Simulation with ``ext_hold_slot=0`` keeps
    it in the pool tick after tick on both inbox impls."""
    st, _ = inject_ext_batch(_pool_state(p=8), [
        ExtFrame(a=1, b=7, c=70, kind=EXT_OUT, dst=0),
        ExtFrame(a=2, b=8, c=80, dst=1)], 0)
    pool, alive = st.pool, torch.ones((2,), dtype=torch.bool)
    t_end = torch.tensor(10_000)
    hold = pool.valid & (pool.kind == tsim.EXT_OUT_KIND) & (pool.dst == 0)
    valid = pool.valid.numpy()
    is_out = valid & (pool.kind.numpy() == EXT_OUT)
    for impl in ("scatter", "sort", "pallas"):
        _, dlv, _ = pool_mod.build_inbox(pool, 2, 2, t_end, alive,
                                         impl=impl, hold=hold)
        assert not dlv.numpy()[is_out].any(), impl
        assert dlv.numpy()[valid & ~is_out].all(), impl
        _, dlv, _ = pool_mod.build_inbox(pool, 2, 2, t_end, alive, impl=impl)
        assert dlv.numpy()[valid].all(), impl
    got = inbox_k.fused_inbox(pool, 2, 2, t_end, alive, hold)
    assert not got[1].numpy()[is_out].any()

    for impl in ("scatter", "pallas"):
        sim = _echo_sim(RealworldEchoApp(), inbox_impl=impl, hold=True)
        s = sim.run_chunk(sim.init(seed=9), 20)
        s, _ = inject_ext_batch(s, [ExtFrame(a=77, b=1, c=5)], 0)
        s = sim.run_chunk(s, 6)
        parked = (s.pool.valid & (s.pool.kind == EXT_OUT)
                  & (s.pool.dst == 0))
        assert int(parked.sum()) == 1, impl
        assert int(s.pool.blk[parked][0, pool_mod._COL["c"]]) == 6, impl
