"""SimpleUnderlay and NoChurn: the port against the JAX package.

``send_batch`` on identical inputs: with ``jitter=0`` every output is
exactly equal.  With ``jitter=0.1`` the drop decisions and counters are
exact and ``t_deliver`` agrees to within the erfinv gap: the jitter term
is ``|N(0,1)| * 0.1 * delay``, and PyTorch's erfinv differs from XLA's by
up to 64 float32 ulp (measured), so the bound is 128 ulp of the jitter
term plus 1 ns of float→int truncation.  Measured on ten seeds: at most
128 ns on 0.06-0.13 s delays (16 ns would be 2 float32 ulps of such a
delay; the erfinv gap, not the port's arithmetic, sets the difference).  ``churn.init``/``step`` (model "none")
with ``init_deviation=0`` are exact (the JAX side in a fresh interpreter,
see test_torch_engine.py ``fresh_jax_call``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu import churn as jchurn
from oversim_tpu.underlay import simple as jul
from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import rng as R
from oversim_tpu_torch.underlay import simple as tul
from test_torch_engine import fresh_jax_call

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)


def _batch(seed, n=12, m=6):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=(n, m)).astype(np.int32)
    dst[:, 0] = np.arange(n)                       # self-sends
    return dict(
        src=np.broadcast_to(np.arange(n, dtype=np.int32)[:, None],
                            (n, m)).copy(),
        dst=dst,
        size=rng.integers(16, 400, size=(n, m)).astype(np.int32),
        t_send=rng.integers(0, 5 * 10**9, size=(n, m)).astype(np.int64),
        want=rng.random((n, m)) < 0.8,
        alive=rng.random(n) < 0.85,
        tx=np.where(rng.random(n) < 0.5,
                    rng.integers(0, 6 * 10**9, size=n), 0).astype(np.int64))


def _run_both(seed, jitter, queue_bytes=1_000_000):
    b = _batch(seed)
    n = b["alive"].shape[0]
    jp = jul.UnderlayParams(jitter=jitter, send_queue_bytes=queue_bytes)
    tp = tul.UnderlayParams(jitter=jitter, send_queue_bytes=queue_bytes)
    key_j, key_t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    js = jul.init(key_j, n, jp)
    ts = tul.init(key_t, n, tp)
    assert np.array_equal(np.asarray(js.coords), ts.coords.numpy())
    assert np.array_equal(np.asarray(js.channel), ts.channel.numpy())
    js = js.__class__(coords=js.coords, channel=js.channel,
                      tx_finished=jnp.asarray(b["tx"]),
                      node_type=js.node_type, tcp_conn=js.tcp_conn)
    ts = tul.UnderlayState(coords=ts.coords, channel=ts.channel,
                           tx_finished=torch.as_tensor(b["tx"]),
                           node_type=ts.node_type, tcp_conn=ts.tcp_conn)
    r_j, r_t = jax.random.fold_in(key_j, 9), R.fold_in(key_t, 9)
    jt, jok, js2, jd = jul.send_batch(
        js, jp, r_j, jnp.asarray(b["src"]), jnp.asarray(b["dst"]),
        jnp.asarray(b["size"]), jnp.asarray(b["t_send"]),
        jnp.asarray(b["want"]), jnp.asarray(b["alive"]))
    tt, tok, ts2, td = tul.send_batch(
        ts, tp, r_t, torch.as_tensor(b["src"]), torch.as_tensor(b["dst"]),
        torch.as_tensor(b["size"]), torch.as_tensor(b["t_send"]),
        torch.as_tensor(b["want"]), torch.as_tensor(b["alive"]))
    return (jt, jok, js2, jd), (tt, tok, ts2, td), b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("queue_bytes", [1_000_000, 300])
def test_send_batch_exact_without_jitter(seed, queue_bytes):
    (jt, jok, js2, jd), (tt, tok, ts2, td), _ = _run_both(seed, 0.0,
                                                          queue_bytes)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jok), tok.numpy())
    assert np.array_equal(np.asarray(js2.tx_finished),
                          ts2.tx_finished.numpy())
    for k in jd:
        assert int(jd[k]) == int(td[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_send_batch_jitter_within_erfinv_gap(seed):
    (jt, jok, js2, jd), (tt, tok, ts2, td), b = _run_both(seed, 0.1)
    assert np.array_equal(np.asarray(jok), tok.numpy())
    assert np.array_equal(np.asarray(js2.tx_finished),
                          ts2.tx_finished.numpy())
    for k in jd:
        assert int(jd[k]) == int(td[k]), k
    jt, tt = np.asarray(jt), tt.numpy()
    m = b["want"]
    jitter_term = np.abs(jt - b["t_send"]).astype(np.float64) * 0.1
    bound = 128 * 2.0**-23 * jitter_term + 1.0
    assert (np.abs(jt - tt)[m] <= bound[m]).all()


NAMES = ("t_create", "t_kill", "t_dead", "graceful", "l_mean", "d_mean",
         "t_tick")


def _churn_params(mod):
    return mod.ChurnParams(model="none", target_num=16, init_interval=1.25,
                           init_deviation=0.0, graceful_leave_delay=2.0)


def _kill_times(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4 * 10**9, size=16) + 7 * 10**9


def jax_churn_windows(seed):
    """The JAX churn state after init and after each of 12 windows
    (pre-kills injected before window 5), with each window's
    created/killed/leaving masks and next event."""
    p = _churn_params(jchurn)
    key = jax.random.PRNGKey(seed)
    st = jchurn.init(key, p)
    out = {f"init|{k}": np.asarray(getattr(st, k)) for k in NAMES}
    alive = np.zeros(16, bool)
    for w in range(12):
        if w == 5:
            st = st.__class__(**{**{k: getattr(st, k) for k in NAMES},
                                 "t_kill": jnp.asarray(_kill_times(seed))})
        st, c, k_, l_ = jchurn.step(
            st, p, jnp.asarray(alive), jnp.int64(w * 2 * 10**9),
            jnp.int64((w + 1) * 2 * 10**9), jax.random.fold_in(key, w))
        for k in NAMES:
            out[f"{w}|{k}"] = np.asarray(getattr(st, k))
        for k, v in (("created", c), ("killed", k_), ("leaving", l_)):
            out[f"{w}|{k}"] = np.asarray(v)
        out[f"{w}|next_event"] = np.asarray(jchurn.next_event(st))
        alive = (alive | np.asarray(c)) & ~np.asarray(k_)
    return out


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_churn_none_exact_without_deviation(seed):
    ref = fresh_jax_call("test_torch_underlay", "jax_churn_windows",
                         seed=seed)
    p = _churn_params(tchurn)
    key = R.PRNGKey(seed)
    ts = tchurn.init(key, p)
    for k in NAMES:
        assert np.array_equal(ref[f"init|{k}"], getattr(ts, k).numpy()), k
    alive = np.zeros(16, bool)
    # windows across the ramp, with pre-kills injected mid-way so the
    # graceful-leave coin and the kill path both run
    for w in range(12):
        if w == 5:
            ts = tchurn.ChurnState(**{**{k: getattr(ts, k) for k in NAMES},
                                      "t_kill": torch.as_tensor(
                                          _kill_times(seed))})
        ts, tc, tk, tl = tchurn.step(
            ts, p, torch.as_tensor(alive), torch.tensor(w * 2 * 10**9),
            torch.tensor((w + 1) * 2 * 10**9), R.fold_in(key, w))
        for k, v in (("created", tc), ("killed", tk), ("leaving", tl)):
            assert np.array_equal(ref[f"{w}|{k}"], v.numpy()), (w, k)
        for k in NAMES:
            assert np.array_equal(ref[f"{w}|{k}"], getattr(ts, k).numpy()), \
                (w, k)
        assert int(ref[f"{w}|next_event"]) == int(tchurn.next_event(ts))
        alive = (alive | tc.numpy()) & ~tk.numpy()
