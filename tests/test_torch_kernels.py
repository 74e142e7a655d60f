"""The port's kernel plane on the CPU against the JAX package's kernels.

The port's kernels (``inbox_select_gather`` and its gather step
``inbox_gather``, ``alloc_dest``) are CUDA; on CPU tensors their
wrappers run the plain PyTorch versions, which are held here — together with the port's ``build_inbox_scatter`` /
``build_inbox_sort`` oracles and the whole ``alloc`` pool write — to be
EXACTLY equal to the JAX package's ``fused_inbox(..., interpret=True)``,
``alloc_dest(..., interpret=True)`` and ``engine/pool.py``.  The pools
are rebuilt from the same numpy seeds as tests/test_kernels.py:29-172:
random pools at occupancies 0, 0.15, 0.5, 0.85 and 1.0 with tie
pressure, empty and full pools, R-overflow, the hold mask and twenty
random valid/want draws.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu import kernels as jkernels
from oversim_tpu.engine import pool as jpool
from oversim_tpu_torch.engine import pool as tpool
from oversim_tpu_torch.kernels import inbox as tinbox
from oversim_tpu_torch.kernels import outbox as toutbox

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)


def _random_pool(rng, p, n, occupancy, rmax=4):
    """(jax pool, port pool) built from one numpy draw, as
    tests/test_kernels.py:_random_pool draws it."""
    base = jpool.empty(p, key_lanes=5, rmax=rmax)
    valid = rng.random(p) < occupancy
    t = rng.integers(0, 6, size=p).astype(np.int64)
    dst = rng.integers(0, n, size=p).astype(np.int32)
    blk = base.blk.at[:, jpool._COL["dst"]].set(jnp.asarray(dst))
    blk = blk.at[:, jpool._COL["nonce"]].set(jnp.arange(p, dtype=jnp.int32))
    jp = dataclasses.replace(
        base, valid=jnp.asarray(valid),
        t_deliver=jnp.where(jnp.asarray(valid), jnp.asarray(t), jpool.T_INF),
        blk=blk)
    return jp, _to_port(jp)


def _to_port(jp):
    return tpool.MsgPool(
        valid=torch.as_tensor(np.array(jp.valid)),
        t_deliver=torch.as_tensor(np.array(jp.t_deliver)),
        stamp=torch.as_tensor(np.array(jp.stamp)),
        blk=torch.as_tensor(np.array(jp.blk)), kl=jp.kl, rmax=jp.rmax)


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def _assert_all_paths(jp, tp, n, r, t_end, alive, hold=None):
    j_alive = jnp.asarray(alive)
    j_hold = None if hold is None else jnp.asarray(hold)
    t_alive = torch.as_tensor(alive)
    t_hold = None if hold is None else torch.as_tensor(hold)
    ref = jkernels.inbox.fused_inbox(jp, n, r, jnp.int64(t_end), j_alive,
                                     hold=j_hold, interpret=True)
    t_end_t = torch.tensor(t_end)
    got = tinbox.fused_inbox(tp, n, r, t_end_t, t_alive, t_hold)
    for a, b, name in zip(ref, got, ("inbox", "delivered", "to_dead",
                                     "gblk")):
        assert _eq(a, b), ("plain inbox_select_gather", name)
    for impl in ("scatter", "sort"):
        out = tpool.build_inbox(tp, n, r, t_end_t, t_alive, impl=impl,
                                hold=t_hold)
        for a, b, name in zip(ref[:3], out, ("inbox", "delivered",
                                             "to_dead")):
            assert _eq(a, b), (impl, name)


@pytest.mark.parametrize("trial", range(30))
def test_inbox_randomized_pools(trial):
    """Occupancies 0 .. 1.0 in turn, ties, dead destinations, overflow."""
    rng = np.random.default_rng(7)
    n, p, r = 7, 40, 3
    occupancies = [0.0, 0.15, 0.5, 0.85, 1.0]
    for t in range(trial + 1):        # advance the stream like the JAX test
        occ = occupancies[t % len(occupancies)]
        jp, tp = _random_pool(rng, p, n, occ)
        alive = rng.random(n) < 0.8
        t_end = int(rng.integers(1, 8))
    _assert_all_paths(jp, tp, n, r, t_end, alive)


def test_inbox_empty_and_full_pool():
    rng = np.random.default_rng(11)
    n, p, r = 4, 24, 3
    alive = np.ones(n, bool)
    jp, tp = _random_pool(rng, p, n, 0.0)
    _assert_all_paths(jp, tp, n, r, 10, alive)
    inbox, delivered, _, _ = tinbox.fused_inbox(
        tp, n, r, torch.tensor(10), torch.as_tensor(alive))
    assert bool((inbox == -1).all()) and not bool(delivered.any())
    jp, tp = _random_pool(rng, p, n, 1.1)
    _assert_all_paths(jp, tp, n, r, 10, alive)
    _, delivered, _, _ = tinbox.fused_inbox(
        tp, n, r, torch.tensor(10), torch.as_tensor(alive))
    assert int(delivered.sum()) == n * r


def test_inbox_overflow_keeps_earliest_r():
    """R-overflow retention, built through both packages' alloc."""
    q = 6
    out = {"t_deliver": [5, 3, 3, 7, 4, 6], "src": list(range(q)),
           "dst": [0] * q, "kind": [7] * q, "key": np.zeros((q, 5)),
           "nonce": list(range(q)), "hops": [0] * q, "a": [0] * q,
           "b": [0] * q, "c": [0] * q, "d": [0] * q,
           "nodes": np.full((q, 4), -1), "size_b": [0] * q,
           "stamp": [0] * q}
    i64 = ("t_deliver", "stamp")
    j_out = {k: jnp.asarray(np.asarray(v), jnp.int64 if k in i64 else
                            (jnp.uint32 if k == "key" else jnp.int32))
             for k, v in out.items()}
    t_out = {k: torch.as_tensor(np.asarray(v).astype(
        np.int64 if k in i64 + ("key",) else np.int32)) for k, v in out.items()}
    jp, _ = jpool.alloc(jpool.empty(16, key_lanes=5, rmax=4), j_out,
                        jnp.ones((q,), bool))
    tp, _ = tpool.alloc(tpool.empty(16, 5, 4), t_out,
                        torch.ones((q,), dtype=torch.bool), impl="pallas")
    for name in ("valid", "t_deliver", "stamp", "blk"):
        assert _eq(getattr(jp, name), getattr(tp, name)), name
    alive = np.ones(2, bool)
    _assert_all_paths(jp, tp, 2, 2, 10, alive)
    inbox, delivered, _ = tpool.build_inbox(
        tp, 2, 2, torch.tensor(10), torch.as_tensor(alive), impl="pallas")
    assert inbox[0].tolist() == [1, 2]
    tp2 = tpool.free(tp, delivered)
    inbox2, _, _ = tpool.build_inbox(
        tp2, 2, 2, torch.tensor(10), torch.as_tensor(alive), impl="pallas")
    assert inbox2[0].tolist() == [4, 0]


def test_inbox_hold_mask():
    rng = np.random.default_rng(13)
    n, p, r = 5, 32, 3
    jp, tp = _random_pool(rng, p, n, 0.7)
    alive = rng.random(n) < 0.8
    hold = rng.random(p) < 0.3
    _assert_all_paths(jp, tp, n, r, 6, alive, hold=hold)


@pytest.mark.parametrize("w", [1, 5])
def test_inbox_gather_plain_equals_pallas_gather(w):
    """The gather step alone against the Pallas kernel's gather mode at
    payload widths no pool has (1 and 5 words a row)."""
    rng = np.random.default_rng(19 + w)
    n, p, r = 6, 30, 3
    due = rng.random(p) < 0.6
    dst = rng.integers(0, n, size=p).astype(np.int32)
    t = np.where(due, rng.integers(0, 6, size=p), 0).astype(np.int64)
    blk = rng.integers(-2**31, 2**31 - 1, size=(p, w),
                       dtype=np.int64).astype(np.int32)
    j_inbox, _, j_gblk = jkernels.inbox._fused_call(
        jnp.asarray(due.astype(np.int32)), jnp.asarray(dst),
        jnp.asarray((t >> 31).astype(np.int32)),
        jnp.asarray((t & 0x7FFFFFFF).astype(np.int32)), jnp.asarray(blk),
        n=n, r=r, interpret=True, gather=True)
    inbox, _ = tinbox.inbox_select_plain(torch.as_tensor(due),
                                         torch.as_tensor(dst),
                                         torch.as_tensor(t), n, r)
    assert _eq(j_inbox, inbox)
    assert bool((inbox < 0).any()) and bool((inbox >= 0).any())
    for fn in (tinbox.inbox_gather, tinbox.inbox_gather_plain):
        assert _eq(j_gblk, fn(inbox, torch.as_tensor(blk))), fn.__name__


@pytest.mark.parametrize("trial", range(20))
def test_alloc_dest_randomized(trial):
    """k-th wanted → k-th free slot; overflow; sentinel p."""
    rng = np.random.default_rng(17)
    p = 24
    for _ in range(trial + 1):
        valid = rng.random(p) < rng.random()
        q = int(rng.integers(1, 2 * p))
        want = rng.random(q) < 0.6
    jd, jo = jkernels.outbox.alloc_dest(jnp.asarray(valid), jnp.asarray(want),
                                        interpret=True)
    tv, tw = torch.as_tensor(valid), torch.as_tensor(want)
    for fn in (toutbox.alloc_dest, toutbox.alloc_dest_plain,
               tpool.alloc_dest_cumsum):
        d, o = fn(tv, tw)
        assert _eq(jd, d) and int(jo) == int(o), fn.__name__


@pytest.mark.parametrize("impl", ["scatter", "pallas"])
def test_alloc_pool_write(impl):
    """The whole ``alloc`` (destination map + packed payload write)."""
    rng = np.random.default_rng(23)
    p, q, kl, rmax = 32, 40, 5, 4
    jp, tp = _random_pool(rng, p, 6, 0.5, rmax=rmax)
    out = {"t_deliver": rng.integers(0, 10**9, size=q),
           "stamp": rng.integers(0, 10**9, size=q),
           "key": rng.integers(0, 2**32, size=(q, kl), dtype=np.uint64),
           "nodes": rng.integers(-1, 50, size=(q, rmax))}
    for name in tpool.SCAL_COLS:
        out[name] = rng.integers(-5, 100, size=q)
    want = rng.random(q) < 0.7
    j_out = {k: jnp.asarray(v, jnp.uint32 if k == "key" else
                            (jnp.int64 if k in ("t_deliver", "stamp")
                             else jnp.int32)) for k, v in out.items()}
    t_out = {k: torch.as_tensor(np.asarray(v).astype(
        np.int64 if k in ("t_deliver", "stamp", "key") else np.int32))
        for k, v in out.items()}
    jn, jo = jpool.alloc(jp, j_out, jnp.asarray(want),
                         impl="pallas" if impl == "pallas" else "scatter")
    tn, to = tpool.alloc(tp, t_out, torch.as_tensor(want), impl=impl)
    assert int(jo) == int(to)
    for name in ("valid", "t_deliver", "stamp", "blk"):
        assert _eq(getattr(jn, name), getattr(tn, name)), name
