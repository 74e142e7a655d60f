"""Pastry's findNode and table learning against the JAX package's, at
160-, 100- and 64-bit keys, on random leaf sets and routing tables at
N=48 (empty entries, duplicates, the node itself, equal keys and keys
that share their top 64 bits).

(a) ``PastryLogic._find_node``: for each node and three targets (its own
    key, a key near it, another node's key or a random one) the result
    slots, whether the node is the sibling, and the next-hop candidates.
(b) ``PastryLogic._learn``: candidate nodes merged into both leaf-set
    halves (the ring-closest half on each side, ordered by the
    approximate sort of the distance's top word) and into the routing
    table by proximity neighbour selection (row = shared prefix digits,
    column = the next digit), with and without a measured RTT on the
    first candidate (where the reference's callers give one).  The port
    does all nodes at once and folds the JAX package's
    candidate-by-candidate loop.

Both exercise the multi-lane borrow chains of the clockwise,
counter-clockwise and bidirectional ring distances and the sorts' ties.
The JAX side is the per-node function under ``jax.jit(jax.vmap(...))``
(jitted: eager JAX divides by a constant where the jitted tick
multiplies by its reciprocal).  Tolerance 0: every slot, flag, table
entry and RTT must be equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.overlay import pastry as tpa

torch.set_num_threads(1)

K_CANDS = 6
RTT_INF = 2 ** 30
N = 48


def _tables(rng, half=8, rows=16, cols=16):
    """Random Pastry tables with empty entries, duplicates and self."""
    def slots(shape, fill):
        x = rng.integers(0, N, shape).astype(np.int32)
        return np.where(rng.random(shape) < fill, -1, x).astype(np.int32)
    cw, ccw = slots((N, half), 0.2), slots((N, half), 0.2)
    # valid prefixes: leaf halves are NO_NODE-padded at the end
    n_cw = rng.integers(0, half + 1, N)
    cw = np.where(np.arange(half) < n_cw[:, None], np.abs(cw), -1)
    ccw[:4] = -1                                  # no neighbours at all
    rt = slots((N, rows, cols), 0.85)
    rt[5, 0, :4] = 5                              # itself in its table
    state = np.where(rng.random(N) < 0.9, 2, 1).astype(np.int32)
    return state, cw.astype(np.int32), ccw.astype(np.int32), rt


@pytest.mark.parametrize("bits", [160, 100, 64])
def test_find_node_against_jax(bits):
    from oversim_tpu.core import keys as jkeys
    from oversim_tpu.overlay import pastry as jpa
    ts = tkeys.KeySpec(bits)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**32, (N, ts.lanes), dtype=np.uint64
                        ).astype(np.uint32)
    keys[:, 0] &= np.uint32(ts.top_lane_mask)
    keys[7] = keys[6]
    keys[8, :2] = keys[9, :2]                     # long shared prefixes
    state, cw, ccw, rt = _tables(rng)
    targets = rng.integers(0, 2**32, (N, 3, ts.lanes), dtype=np.uint64
                           ).astype(np.uint32)
    targets[..., 0] &= np.uint32(ts.top_lane_mask)
    targets[:, 0] = keys                          # own key
    targets[:, 1, :3] = keys[:, :3]               # near the own key
    targets[10:20, 2] = keys[rng.integers(0, N, 10)]   # another node's key
    jl = jpa.PastryLogic(jkeys.KeySpec(bits))
    tl = tpa.PastryLogic(ts)
    jctx = types.SimpleNamespace(keys=jnp.asarray(keys))
    tctx = types.SimpleNamespace(keys=torch.as_tensor(keys.astype(np.int64)))
    jst = types.SimpleNamespace(state=jnp.asarray(state),
                                leaf_cw=jnp.asarray(cw),
                                leaf_ccw=jnp.asarray(ccw), rt=jnp.asarray(rt))
    tst = types.SimpleNamespace(state=torch.as_tensor(state),
                                leaf_cw=torch.as_tensor(cw),
                                leaf_ccw=torch.as_tensor(ccw),
                                rt=torch.as_tensor(rt))
    nid = np.arange(N, dtype=np.int32)

    def one(state, cw, ccw, rt, me, key):
        st = types.SimpleNamespace(state=state, leaf_cw=cw, leaf_ccw=ccw,
                                   rt=rt)
        return jl._find_node(jctx, st, jctx.keys[me], me, key, 16)

    want = jax.jit(jax.vmap(jax.vmap(one, (None,) * 5 + (0,)),
                            (0,) * 6))(jst.state, jst.leaf_cw, jst.leaf_ccw,
                                       jst.rt, jnp.asarray(nid),
                                       jnp.asarray(targets))
    got = tl._find_node(tctx, tst, tctx.keys, torch.as_tensor(nid),
                        torch.as_tensor(targets.astype(np.int64)), 16)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()




@dataclasses.dataclass
class _Tab:
    leaf_cw: object
    leaf_ccw: object
    rt: object
    rt_rtt: object


def _inputs(bits):
    ts = tkeys.KeySpec(bits)
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 2**32, (N, ts.lanes), dtype=np.uint64
                        ).astype(np.uint32)
    keys[:, 0] &= np.uint32(ts.top_lane_mask)
    keys[7] = keys[6]
    keys[8, :2] = keys[9, :2]                     # long shared prefixes
    keys[20:24, :2] = keys[3, :2]
    _, cw, ccw, rt = _tables(rng)
    rt_rtt = np.where(rt >= 0, rng.integers(1, 400, rt.shape),
                      RTT_INF).astype(np.int32)
    cands = rng.integers(0, N, (N, K_CANDS)).astype(np.int32)
    cands[rng.random(cands.shape) < 0.2] = -1
    cands[::5, 1] = np.arange(N)[::5]             # the node itself
    cands[::3, 2] = cands[::3, 3]                 # duplicates
    cands[3, :] = [20, 21, 22, 23, 3, -1]         # shared top 64 bits
    en = rng.random(cands.shape) < 0.85
    rtt = np.full(cands.shape, RTT_INF, np.int32)
    rtt[:, 0] = np.where(rng.random(N) < 0.7,
                         rng.integers(1, 400, N), RTT_INF)
    return keys, (cw, ccw, rt, rt_rtt), cands, en, rtt


@pytest.mark.parametrize("bits", [160, 100, 64])
def test_learn_against_jax(bits):
    from oversim_tpu.core import keys as jkeys
    from oversim_tpu.overlay import pastry as jpa
    keys, tab, cands, en, rtt = _inputs(bits)
    jl = jpa.PastryLogic(jkeys.KeySpec(bits))
    tl = tpa.PastryLogic(tkeys.KeySpec(bits))
    jkeys_a = jnp.asarray(keys)
    tctx = types.SimpleNamespace(keys=torch.as_tensor(keys.astype(np.int64)))
    nid = np.arange(N, dtype=np.int32)

    def one(cw, ccw, rt, rt_rtt, me, c, e, r, measured):
        st = jl._learn(types.SimpleNamespace(keys=jkeys_a),
                       _Tab(cw, ccw, rt, rt_rtt), jkeys_a[me], me, c, e,
                       r if measured else None)
        return st.leaf_cw, st.leaf_ccw, st.rt, st.rt_rtt

    for measured in (True, False):
        want = jax.jit(jax.vmap(lambda *a: one(*a, measured)))(
            *(jnp.asarray(x) for x in tab), jnp.asarray(nid),
            jnp.asarray(cands), jnp.asarray(en), jnp.asarray(rtt))
        got = tl._learn(tctx, tuple(torch.as_tensor(x) for x in tab),
                        tctx.keys, torch.as_tensor(nid),
                        torch.as_tensor(cands), torch.as_tensor(en),
                        torch.as_tensor(rtt) if measured else None)
        for name, w, g, before in zip(("leaf_cw", "leaf_ccw", "rt", "rt_rtt"),
                                      want, got, tab):
            assert np.array_equal(np.asarray(w), g.numpy()), (measured, name)
            # unmeasured candidates fill empty cells, whose RTT stays
            # RTT_INF; everything else must have moved
            if measured or name != "rt_rtt":
                assert not np.array_equal(np.asarray(w), before), name
