"""The DHT's hooks one by one against the JAX package, on the seeded
inputs of test_torch_dht_units.py.

The JAX hooks are vmapped over the node axis in one fresh interpreter
(``jax_dht_units(part="hooks")``; test_torch_engine.py ``fresh_jax_call``
says why); the port's batched hooks get the same numpy inputs.  Every
comparison is exact:

* ``on_update``'s responsibility filter under XOR and Chord's ring
  distance, with short views, tied distances and urgent preemption;
* ``on_timer``'s known-key draw, with truth entries that expire inside
  the window so that the live set differs between nodes;
* the per-slot completion fold (``apps/base.lookup_done_fold``) of
  ``on_lookup_done`` over 8 completion slots, outbox included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from oversim_tpu_torch.apps import base as tbase
from oversim_tpu_torch.apps import dht as tdht
from oversim_tpu_torch.core import keys as tkeys
from oversim_tpu_torch.engine import logic as tlogic
from test_torch_dht_units import (KL, N, R, SEED, T0, _dht_params,
                                  assert_same, port_ctx, port_state, t,
                                  unit_inputs)
from test_torch_engine import JaxCall

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    return JaxCall("test_torch_dht_units", "jax_dht_units", seed=SEED,
                   part="hooks").result()


@pytest.fixture(scope="module")
def x():
    return unit_inputs()


@pytest.mark.parametrize("dist", ["xor", "ring"])
@pytest.mark.parametrize("urgent", [False, True])
def test_on_update_responsibility(ref, x, dist, urgent):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    if dist == "ring":
        app.dist_fn = lambda nk, rk: tkeys.ring_distance(rk, nk)
    keys = t(x["node_keys"])
    st = app.on_update(
        port_state(app, x), t(x["en"]), port_ctx(x), None, None,
        torch.tensor(T0), torch.arange(N, dtype=torch.int32),
        t(x["added"]), keys[t(x["sib"]).long()], t(x["sib_valid"]),
        t(x["urgent"]) if urgent else None)
    assert_same(ref, f"update_{dist}_{urgent}", st)
    old_dst = t(x["mnt_dst"])
    assert bool((st.mnt_dst != old_dst).any())
    # an urgent delta restages a node whose pump was active
    assert bool(((old_dst >= 0) & (st.mnt_dst != old_dst)).any()) == urgent


def test_on_timer_known_key_draw(ref, x):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    ctx = port_ctx(x)
    ev = tbase.AppEvents(N, "cpu")
    st, req = app.on_timer(port_state(app, x), t(x["en"]), ctx, t(x["now"]),
                           t(x["rng"]), ev, torch.arange(N, dtype=torch.int32))
    assert_same(ref, "timer_app", st)
    assert_same(ref, "timer_req", (req.want, req.key, req.tag))
    assert_same(ref, "timer_ev", ev.finish({}))
    # entries expiring inside the window make the live count differ
    # between nodes, and known-key ops were drawn
    g, n_live = tdht._known_key_draw(ctx.glob, t(x["now"]),
                                     torch.as_tensor(
                                         x["rng"].astype(np.int64)))
    assert len(set(n_live.tolist())) > 1
    assert bool(((st.op_g >= 0) & req.want).any())


def test_lookup_done_fold_per_slot(ref, x):
    app = tdht.DhtApp(tdht.DhtParams(**_dht_params()))
    st = dataclasses.replace(port_state(app, x), op_key=t(x["in_key"]),
                             op_val=t(x["in_val"]))
    ob = tlogic.Outbox(N, 12, KL, R, "cpu")
    ev = tbase.AppEvents(N, "cpu")
    done = tbase.LookupDone(
        en=t(x["done_en"]), success=t(x["done_suc"]), tag=t(x["done_tag"]),
        target=t(x["done_target"]), results=t(x["done_results"]),
        hops=t(x["done_hops"]), t0=t(x["done_t0"]))
    st = tbase.lookup_done_fold(app, st, done, port_ctx(x), ob, ev,
                                torch.tensor(T0),
                                torch.arange(N, dtype=torch.int32))
    assert_same(ref, "fold_app", st)
    assert_same(ref, "fold_ob", ob.finish())
    assert_same(ref, "fold_ev", ev.finish({}))

    class Batched:
        def on_lookup_done_batch(self, *args):
            return "batch"
    assert tbase.lookup_done_fold(Batched(), None, done, None, None, None,
                                  None, None) == "batch"
