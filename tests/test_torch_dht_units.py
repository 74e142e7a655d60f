"""The DHT's helpers one by one against the JAX package, on seeded inputs.

Each JAX function is vmapped over the node axis (its per-node form) in
one fresh interpreter (``jax_dht_units``; test_torch_engine.py
``fresh_jax_call`` says why); the port's batched function gets the same
numpy inputs.  Every comparison is exact:

* ``_dist64``: keys with the top lane on both sides of 2^31, ties and the
  uint64 sentinel — the port's sign-flipped int64 is the JAX uint64 with
  its top bit flipped, so both sort alike;
* ``_vote_winner`` on tied votes and every fill level;
* ``_store``: same-key overwrite, free slot, eviction on tied expiries,
  stale and evicting replication copies;
* ``post_step``: mods and appends, two commits to one slot, a recycled
  slot and the ring wrapping past its end;
* ``_team_key``, symmetric and repeated, at 2 and 4 teams.

test_torch_dht_hooks.py holds the hooks (``on_update``, ``on_timer``, the
completion fold) on the same inputs, test_torch_dht.py the interop round
trip of the DHT's u32 leaves.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oversim_tpu_torch import tree
from oversim_tpu_torch.apps import dht as tdht
from oversim_tpu_torch.engine import logic as tlogic
from test_torch_engine import JaxCall

torch.set_num_threads(1)

SEED = 11
N = 64
KL = 5
D = 6
Q = 4
G = 16
L = 8
R = 8
T0 = 1_000_000_000_000
T1 = T0 + 100_000_000


def unit_inputs(seed=SEED):
    """Every case's numpy inputs, the same on both sides."""
    rng = np.random.default_rng(seed)
    u32 = np.uint32
    out = {}
    # _dist64: top lanes around 2^31, repeats and the all-ones sentinel
    hi = rng.choice(np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                              2 ** 32 - 1], dtype=np.int64), (N,))
    lo = rng.choice(np.array([0, 5, 2 ** 31, 2 ** 32 - 1], dtype=np.int64),
                    (N,))
    out["dist"] = np.stack([hi, lo, rng.integers(0, 2 ** 32, (N,))],
                           -1).astype(u32)
    # _vote_winner
    out["votes"] = rng.integers(-2, 3, (N, Q)).astype(np.int32)
    out["n_acks"] = rng.integers(0, Q + 2, (N,)).astype(np.int32)
    # storage: keys from a pool of 4 so that the same key recurs
    pool = rng.integers(0, 2 ** 32, (4, KL)).astype(u32)
    out["s_key"] = pool[rng.integers(0, 4, (N, D))]
    s_val = rng.integers(0, 100, (N, D)).astype(np.int32)
    s_val[rng.random((N, D)) < 0.2] = -1
    s_val[: N // 4] = np.maximum(s_val[: N // 4], 0)    # full stores
    out["s_val"] = s_val
    out["s_expire"] = rng.integers(0, 4, (N, D)).astype(np.int64)  # ties
    out["in_key"] = pool[rng.integers(0, 4, (N,))]
    out["in_val"] = rng.integers(0, 100, (N,)).astype(np.int32)
    out["in_expire"] = rng.integers(0, 5, (N,)).astype(np.int64)
    out["en"] = rng.random((N,)) < 0.8
    out["maint"] = rng.random((N,)) < 0.5
    out["mnt_resp"] = rng.random((N, D)) < 0.5
    # post_step: a ring of G keys, the cursor near its end
    gkeys = rng.integers(0, 2 ** 32, (G, KL)).astype(u32)
    out["g_keys"] = gkeys
    out["g_val"] = rng.integers(-1, 50, (G,)).astype(np.int32)
    out["g_expire"] = rng.integers(T0 - 50_000_000, T1 + 50_000_000,
                                   (G,)).astype(np.int64)
    out["g_expire"][:3] = [T0, T1 - 1, T1]
    out["g_cursor"] = np.int32(G - 3)
    cg = rng.choice(np.array([-1, -2, 2, 5, 5, 9], dtype=np.int32), (N,))
    ck = rng.integers(0, 2 ** 32, (N, KL)).astype(u32)
    slot_w = cg >= 0
    ck[slot_w] = gkeys[cg[slot_w]]                 # still the op's key ...
    ck[slot_w & (rng.random((N,)) < 0.2)] ^= u32(1)   # ... or recycled
    out["commit_g"] = cg
    out["commit_key"] = ck
    out["commit_val"] = rng.integers(0, 1000, (N,)).astype(np.int32)
    out["commit_expire"] = rng.integers(0, 10 ** 12, (N,)).astype(np.int64)
    # _team_key
    out["team_t2"] = rng.integers(0, 2, (N,)).astype(np.int32)
    out["team_t4"] = rng.integers(0, 4, (N,)).astype(np.int32)
    # on_update: node keys with duplicates (tied distances)
    nk = rng.integers(0, 2 ** 32, (N, KL)).astype(u32)
    nk[N // 2:] = nk[: N // 2]
    out["node_keys"] = nk
    out["added"] = rng.integers(-1, N, (N, 9)).astype(np.int32)
    out["added"][: N // 8] = -1
    out["added"][N // 8: N // 4, 0] = np.arange(N // 8, N // 4)   # self
    out["sib"] = rng.integers(0, N, (N, 8)).astype(np.int32)
    out["sib_valid"] = rng.random((N, 8)) < 0.6
    out["sib_valid"][: N // 4, 2:] = False                      # short
    out["mnt_dst"] = np.where(rng.random((N,)) < 0.5, -1,
                              rng.integers(0, N, (N,))).astype(np.int32)
    out["urgent"] = rng.random((N,)) < 0.5
    # on_timer
    out["now"] = rng.integers(T0, T1, (N,)).astype(np.int64)
    out["now"][:3] = [T0, T1 - 1, T0 + 7]
    out["t_test"] = np.where(rng.random((N,)) < 0.8, out["now"],
                             T1 + 5).astype(np.int64)
    out["seq"] = rng.integers(0, 9, (N,)).astype(np.int32)
    out["op"] = rng.choice(np.array([0, 0, 0, 1, 2], dtype=np.int32), (N,))
    out["op_to"] = rng.choice(np.array([T0 - 1, T1 + 10], dtype=np.int64),
                              (N,))
    out["rng"] = rng.integers(0, 2 ** 32, (N, 2)).astype(u32)
    # the completion fold
    out["op_seq"] = rng.integers(0, 4, (N,)).astype(np.int32)
    out["done_en"] = rng.random((N, L)) < 0.5
    out["done_suc"] = rng.random((N, L)) < 0.7
    out["done_tag"] = rng.integers(0, 4, (N, L)).astype(np.int32)
    out["done_target"] = rng.integers(0, 2 ** 32, (N, L, KL)).astype(u32)
    res = rng.integers(0, N, (N, L, R)).astype(np.int32)
    res[rng.random((N, L, R)) < 0.3] = -1
    out["done_results"] = res
    out["done_hops"] = rng.integers(0, 5, (N, L)).astype(np.int32)
    out["done_t0"] = rng.integers(T0, T1, (N, L)).astype(np.int64)
    return out


def _dht_params(**kw):
    return dict(num_replica=4, num_get_requests=Q, storage_slots=D,
                num_test_keys=G, test_interval=2.0, **kw)


# -- the JAX side -------------------------------------------------------

def _jax_state(app, x):
    import jax.numpy as jnp
    st = app.init(N)
    return dataclasses.replace(
        st, s_key=jnp.asarray(x["s_key"]), s_val=jnp.asarray(x["s_val"]),
        s_expire=jnp.asarray(x["s_expire"]),
        mnt_resp=jnp.asarray(x["mnt_resp"]),
        mnt_dst=jnp.asarray(x["mnt_dst"]), t_test=jnp.asarray(x["t_test"]),
        seq=jnp.asarray(x["seq"]), op=jnp.asarray(x["op"]),
        op_to=jnp.asarray(x["op_to"]), op_seq=jnp.asarray(x["op_seq"]),
        op_votes=jnp.asarray(x["votes"]), op_acks=jnp.asarray(x["n_acks"]),
        commit_g=jnp.asarray(x["commit_g"]),
        commit_key=jnp.asarray(x["commit_key"]),
        commit_val=jnp.asarray(x["commit_val"]),
        commit_expire=jnp.asarray(x["commit_expire"]))


def _jax_glob(x):
    import jax.numpy as jnp
    from oversim_tpu.apps import dht as jdht
    return jdht.DhtGlobal(keys=jnp.asarray(x["g_keys"]),
                          val=jnp.asarray(x["g_val"]),
                          expire=jnp.asarray(x["g_expire"]),
                          cursor=jnp.asarray(x["g_cursor"]))


def _leaves(prefix, obj, out):
    import jax
    for p, v in jax.tree_util.tree_flatten_with_path(obj)[0]:
        out[prefix + jax.tree_util.keystr(p)] = np.array(v)


def jax_dht_units(seed, part):
    """The JAX references of ``part``: ``"helpers"`` (this file's tests)
    or ``"hooks"`` (test_torch_dht_hooks.py's)."""
    import jax
    import jax.numpy as jnp
    from oversim_tpu.apps import dht as jdht
    x = unit_inputs(seed)
    out = {}
    app = jdht.DhtApp(jdht.DhtParams(**_dht_params()))
    st = _jax_state(app, x)
    if part == "hooks":
        return _jax_hooks(app, st, x)
    out["dist64"] = np.array(jdht._dist64(jnp.asarray(x["dist"])))
    counts, winner = jax.vmap(app._vote_winner)(jnp.asarray(x["votes"]),
                                                jnp.asarray(x["n_acks"]))
    out["vote_counts"], out["vote_winner"] = np.array(counts), \
        np.array(winner)

    st2, did = jax.vmap(app._store)(
        st, jnp.asarray(x["en"]), jnp.asarray(x["in_key"]),
        jnp.asarray(x["in_val"]), jnp.asarray(x["in_expire"]),
        jnp.asarray(x["maint"]))
    _leaves("store", st2, out)
    out["store_did"] = np.array(did)

    st2, glob2 = app.post_step(None, st, _jax_glob(x), None)
    _leaves("post_app", st2, out)
    _leaves("post_glob", glob2, out)

    for variant in ("symmetric", "repeated"):
        for teams in (2, 4):
            va = jdht.DhtApp(jdht.DhtParams(**_dht_params(
                variant=variant, num_replica_teams=teams)))
            out[f"team_{variant}_{teams}"] = np.array(jax.vmap(va._team_key)(
                jnp.asarray(x["in_key"]), jnp.asarray(x[f"team_t{teams}"])))
    return out


def _jax_hooks(app, st, x):
    import jax
    import jax.numpy as jnp
    from oversim_tpu.apps import base as jbase
    from oversim_tpu.apps import dht as jdht
    from oversim_tpu.core import keys as jkeys
    from oversim_tpu.engine import logic as jlogic
    out = {}
    keys = jnp.asarray(x["node_keys"])
    ctx = jlogic.Ctx(t_start=jnp.int64(T0), t_end=jnp.int64(T1), keys=keys,
                     alive=jnp.ones((N,), bool), ready=jnp.ones((N,), bool),
                     ready_cumsum=jnp.arange(1, N + 1, dtype=jnp.int32),
                     n_ready=jnp.int32(N), measuring=jnp.bool_(True),
                     glob=_jax_glob(x))
    sib = jnp.asarray(x["sib"])
    for dist in ("xor", "ring"):
        ua = jdht.DhtApp(jdht.DhtParams(**_dht_params()))
        if dist == "ring":
            ua.dist_fn = lambda nk, rk: jkeys.ring_distance(rk, nk)
        for urgent in (None, jnp.asarray(x["urgent"])):
            def upd(a, en, ni, added, sk, sv, ur):
                return ua.on_update(a, en, ctx, None, None, jnp.int64(T0), ni,
                                    added, sk, sv, ur)
            st2 = jax.vmap(upd, in_axes=(0, 0, 0, 0, 0, 0,
                                         None if urgent is None else 0))(
                st, jnp.asarray(x["en"]), jnp.arange(N, dtype=jnp.int32),
                jnp.asarray(x["added"]), keys[sib],
                jnp.asarray(x["sib_valid"]),
                urgent)
            _leaves(f"update_{dist}_{urgent is not None}", st2, out)

    def timer(a, en, now, rng, ni):
        ev = jbase.AppEvents()
        a2, req = app.on_timer(a, en, ctx, now, rng, ev, ni)
        return a2, (req.want, req.key, req.tag), ev.finish({})
    st2, req, ev = jax.vmap(timer)(st, jnp.asarray(x["en"]),
                                   jnp.asarray(x["now"]),
                                   jnp.asarray(x["rng"]),
                                   jnp.arange(N, dtype=jnp.int32))
    _leaves("timer_app", st2, out)
    _leaves("timer_req", req, out)
    _leaves("timer_ev", ev, out)

    # the JAX overlays' per-slot fold (kademlia.py:1021-1030)
    st_f = dataclasses.replace(
        st, op_key=jnp.asarray(x["in_key"]),
        op_val=jnp.asarray(x["in_val"]))

    def fold(a, en, suc, tag, tgt, res, hops, t0, ni):
        ob = jlogic.Outbox(12, KL, R)
        ev = jbase.AppEvents()
        for li in range(L):
            a = app.on_lookup_done(a, jbase.LookupDone(
                en=en[li], success=suc[li], tag=tag[li], target=tgt[li],
                results=res[li], hops=hops[li], t0=t0[li]),
                ctx, ob, ev, jnp.int64(T0), ni)
        return a, ob.finish(), ev.finish({})
    st2, obf, ev = jax.vmap(fold)(
        st_f, *(jnp.asarray(x[k]) for k in (
            "done_en", "done_suc", "done_tag", "done_target",
            "done_results", "done_hops", "done_t0")),
        jnp.arange(N, dtype=jnp.int32))
    _leaves("fold_app", st2, out)
    _leaves("fold_ob", obf, out)
    _leaves("fold_ev", ev, out)
    return out


# -- the port side ------------------------------------------------------

def t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy())


def port_state(app, x):
    st = app.init(N)
    return dataclasses.replace(
        st, s_key=t(x["s_key"]), s_val=t(x["s_val"]),
        s_expire=t(x["s_expire"]), mnt_resp=t(x["mnt_resp"]),
        mnt_dst=t(x["mnt_dst"]), t_test=t(x["t_test"]), seq=t(x["seq"]),
        op=t(x["op"]), op_to=t(x["op_to"]), op_seq=t(x["op_seq"]),
        op_votes=t(x["votes"]), op_acks=t(x["n_acks"]),
        commit_g=t(x["commit_g"]), commit_key=t(x["commit_key"]),
        commit_val=t(x["commit_val"]), commit_expire=t(x["commit_expire"]))


def port_glob(x):
    return tdht.DhtGlobal(keys=t(x["g_keys"]), val=t(x["g_val"]),
                          expire=t(x["g_expire"]),
                          cursor=t(np.int32(x["g_cursor"])))


def port_ctx(x):
    return tlogic.Ctx(
        t_start=torch.tensor(T0), t_end=torch.tensor(T1),
        keys=t(x["node_keys"]), alive=torch.ones(N, dtype=torch.bool),
        ready=torch.ones(N, dtype=torch.bool),
        ready_cumsum=torch.arange(1, N + 1, dtype=torch.int32),
        n_ready=torch.tensor(N, dtype=torch.int32),
        measuring=torch.tensor(True), glob=port_glob(x))


def assert_same(ref, prefix, obj):
    """Every leaf of the port object ``obj`` equals the JAX leaf of the
    same path under ``prefix`` (u32 lanes compared as values)."""
    got = {prefix + p: v.numpy() for p, v in tree.leaves_with_path(obj)}
    want = {k: v for k, v in ref.items() if k.startswith(prefix)
            and (k[len(prefix):len(prefix) + 1] in ".[")}
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert np.array_equal(got[k], v.astype(got[k].dtype)), k


@pytest.fixture(scope="module")
def ref():
    return JaxCall("test_torch_dht_units", "jax_dht_units", seed=SEED,
                   part="helpers").result()


@pytest.fixture(scope="module")
def x():
    return unit_inputs()


def test_dist64_orders_as_the_uint64(ref, x):
    got = tdht._dist64(t(x["dist"])).numpy()
    flipped = got.view(np.uint64) ^ np.uint64(1 << 63)
    assert np.array_equal(flipped, ref["dist64"])
    assert np.array_equal(np.argsort(got, kind="stable"),
                          np.argsort(ref["dist64"], kind="stable"))
    # the JAX sentinel 2^64 - 1 is the port's I64_MAX
    assert tdht._dist64(torch.tensor([[2 ** 32 - 1] * 2])).item() \
        == tdht.I64_MAX


def test_vote_winner(ref, x):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    counts, winner = app._vote_winner(t(x["votes"]), t(x["n_acks"]))
    assert np.array_equal(counts.numpy(), ref["vote_counts"])
    assert np.array_equal(winner.numpy(), ref["vote_winner"])


def test_store(ref, x):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    st, did = app._store(port_state(app, x), t(x["en"]), t(x["in_key"]),
                         t(x["in_val"]), t(x["in_expire"]), t(x["maint"]))
    assert_same(ref, "store", st)
    assert np.array_equal(did.numpy(), ref["store_did"])
    assert 0 < int(did.sum()) < N


def test_post_step_ring_wrap_and_repeated_slots(ref, x):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    st, glob = app.post_step(None, port_state(app, x), port_glob(x), None)
    assert_same(ref, "post_app", st)
    assert_same(ref, "post_glob", glob)
    # the appends wrapped past the ring's end
    assert int(glob.cursor) < x["g_cursor"]


@pytest.mark.parametrize("variant", ["symmetric", "repeated"])
@pytest.mark.parametrize("teams", [2, 4])
def test_team_key(ref, x, variant, teams):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params(
        variant=variant, num_replica_teams=teams)))
    got = app._team_key(t(x["in_key"]), t(x[f"team_t{teams}"]))
    assert np.array_equal(got.numpy(), ref[f"team_{variant}_{teams}"])
