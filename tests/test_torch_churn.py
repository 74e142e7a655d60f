"""Lifetime churn and its Weibull draws: the port against the JAX package.

The JAX package draws session and dead times with
``jax.random.weibull_min``, i.e. ``-log1p(-u)`` in float64, and XLA-CPU
lowers ``log1p`` to its own expression over the C library's ``log``.
The port reproduces that expression with IEEE operations only
(``oversim_tpu_torch/xlamath.py``), so everything here is EXACT:

(a) ``xlamath.log1p`` against ``jnp.log1p`` on 1.7 million inputs
    (the weibull inputs ``-u``, a wide range, tiny arguments, edges);
(b) ``rng.weibull_min`` against ``jax.random.weibull_min``, bit for bit;
(c) ``churn.init`` and 300 ``churn.step`` windows of the lifetime model
    (creations, pre-kills with their grace windows, final kills and the
    rebirth schedules): every state leaf and event mask equal;
(d) the lifetime schedule at the chip's sparse-path size (65,536 slots,
    lifetime mean 1000 s): nanosecond schedules equal.

``init_deviation = 0`` keeps the creation ramp off the normal draw, whose
erfinv the port matches only to a few ulp (ROADMAP Queue C).  The JAX
side runs in a fresh interpreter (test_torch_engine.py says why).
"""

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import rng as R
from oversim_tpu_torch import xlamath
from test_torch_engine import fresh_jax_call

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

WINDOW_NS = 100_000_000
STEPS = 300
CP = dict(model="lifetime", target_num=12, init_interval=0.2,
          init_deviation=0.0, lifetime_mean=8.0, graceful_leave_delay=1.0)
BIG = dict(model="lifetime", target_num=32_768, init_interval=20 / 32_768,
           init_deviation=0.0, lifetime_mean=1000.0)
LEAVES = ("t_create", "t_kill", "t_dead", "graceful", "l_mean", "d_mean",
          "t_tick")


def log1p_inputs(seed=5):
    rs = np.random.RandomState(seed)
    # (no subnormals: XLA-CPU flushes them to zero)
    edges = np.array([0.0, -0.0, 1e-300, -1e-300, 0.41421356237309503,
                      -0.41421356237309503, 0.414213562373095, -0.4142135623731,
                      -1 + 2 ** -53, -0.5, 1.0, 1e300, 0.0625, -0.0625])
    return np.concatenate([-rs.random_sample(1_000_000),
                           rs.uniform(-1, 3, 500_000),
                           -rs.random_sample(200_000) * 1e-6, edges])


# -- the JAX side (run in a fresh interpreter) -------------------------------

def jax_log1p():
    import jax
    import jax.numpy as jnp
    return {"y": np.asarray(jax.jit(jnp.log1p)(log1p_inputs()))}


def jax_weibull(seeds, scale, n):
    import jax
    return {str(sd): np.asarray(jax.random.weibull_min(
        jax.random.PRNGKey(sd), scale, 1.0, (n,))) for sd in seeds}


def jax_churn_run(seed, steps):
    import jax
    import jax.numpy as jnp
    from oversim_tpu import churn as jchurn
    p = jchurn.ChurnParams(**CP)
    st = jchurn.init(jax.random.PRNGKey(seed), p)
    step = jax.jit(jchurn.step, static_argnums=(1,))
    alive = jnp.zeros((p.num_slots,), bool)
    key = jax.random.PRNGKey(seed + 1)
    out = {f"init.{k}": np.asarray(getattr(st, k)) for k in LEAVES}
    rec = {k: [] for k in LEAVES + ("created", "killed", "leaving")}
    for i in range(steps):
        key, sub = jax.random.split(key)
        st, created, killed, leaving = step(
            st, p, alive, jnp.int64(i * WINDOW_NS),
            jnp.int64((i + 1) * WINDOW_NS), sub)
        alive = (alive | created) & ~killed
        for k in LEAVES:
            rec[k].append(np.asarray(getattr(st, k)))
        for k, v in (("created", created), ("killed", killed),
                     ("leaving", leaving)):
            rec[k].append(np.asarray(v))
    out.update({k: np.stack(v) for k, v in rec.items()})
    return out


def jax_big_init(seed):
    import jax
    from oversim_tpu import churn as jchurn
    st = jchurn.init(jax.random.PRNGKey(seed), jchurn.ChurnParams(**BIG))
    return {"t_create": np.asarray(st.t_create),
            "t_kill": np.asarray(st.t_kill)}


# -- the port's side ---------------------------------------------------------

def port_churn_run(seed, steps):
    p = tchurn.ChurnParams(**CP)
    st = tchurn.init(R.PRNGKey(seed), p)
    alive = torch.zeros((p.num_slots,), dtype=torch.bool)
    key = R.PRNGKey(seed + 1)
    out = {f"init.{k}": getattr(st, k).numpy() for k in LEAVES}
    rec = {k: [] for k in LEAVES + ("created", "killed", "leaving")}
    for i in range(steps):
        key, sub = R.split(key)
        st, created, killed, leaving = tchurn.step(
            st, p, alive, torch.tensor(i * WINDOW_NS),
            torch.tensor((i + 1) * WINDOW_NS), sub)
        alive = (alive | created) & ~killed
        for k in LEAVES:
            rec[k].append(getattr(st, k).numpy())
        for k, v in (("created", created), ("killed", killed),
                     ("leaving", leaving)):
            rec[k].append(v.numpy())
    out.update({k: np.stack(v) for k, v in rec.items()})
    return out


def test_log1p_bit_exact_with_xla():
    want = fresh_jax_call("test_torch_churn", "jax_log1p")["y"]
    got = xlamath.log1p(torch.from_numpy(log1p_inputs())).numpy()
    bad = np.flatnonzero(got.view(np.int64) != want.view(np.int64))
    assert bad.size == 0, (bad.size, log1p_inputs()[bad[:5]])


def test_fma_is_correctly_rounded():
    """The emulated fused multiply-add against exact rational
    arithmetic, cancellation and rounding-boundary cases included."""
    from fractions import Fraction
    rs = np.random.RandomState(3)
    n = 3000
    a = rs.standard_normal(n) * np.exp2(rs.randint(-30, 30, n))
    b = rs.standard_normal(n) * np.exp2(rs.randint(-30, 30, n))
    c = np.where(rs.rand(n) < 0.5, -(a * b) * (1 + rs.randint(-4, 4, n)
                                                * 2.0 ** -52),
                 rs.standard_normal(n) * np.exp2(rs.randint(-60, 60, n)))
    got = xlamath.fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


def test_weibull_draws_bit_exact():
    seeds = [0, 1, 7, 123]
    ref = fresh_jax_call("test_torch_churn", "jax_weibull", seeds=seeds,
                         scale=8.0, n=50_000)
    for sd in seeds:
        got = R.weibull_min(R.PRNGKey(sd), 8.0, 1.0, (50_000,)).numpy()
        assert np.array_equal(got.view(np.int64),
                              ref[str(sd)].view(np.int64)), sd


def test_lifetime_churn_init_and_step_exact():
    ref = fresh_jax_call("test_torch_churn", "jax_churn_run", seed=11,
                         steps=STEPS)
    got = port_churn_run(11, STEPS)
    assert sorted(ref) == sorted(got)
    for k in sorted(ref):
        assert ref[k].dtype == got[k].dtype and np.array_equal(
            ref[k], got[k]), k
    # the run saw every kind of event, rebirths included
    n = 2 * CP["target_num"]
    assert got["killed"].sum() >= 5 and got["leaving"].sum() >= 5
    assert got["created"].sum() > n // 2 + got["killed"][:-100].sum() // 2
    assert got["graceful"].any()


def test_lifetime_schedule_exact_at_sparse_path_size():
    ref = fresh_jax_call("test_torch_churn", "jax_big_init", seed=1)
    st = tchurn.init(R.PRNGKey(1), tchurn.ChurnParams(**BIG))
    assert np.array_equal(st.t_create.numpy(), ref["t_create"])
    assert np.array_equal(st.t_kill.numpy(), ref["t_kill"])


@pytest.mark.parametrize("kw", [dict(model="pareto"), dict(model="random"),
                                dict(model="lifetime",
                                     lifetime_dist="pareto_shifted"),
                                dict(model="lifetime",
                                     lifetime_dist="truncnormal")])
def test_unported_churn_raises(kw):
    """The models and distributions that raised before their port now
    init and step (their parity is tests/test_torch_churn_models.py); an
    unknown model or distribution raises."""
    p = tchurn.ChurnParams(target_num=4, **kw)
    st = tchurn.init(R.PRNGKey(0), p)
    assert st.t_create.shape == (p.num_slots,)
    alive = torch.zeros((p.num_slots,), dtype=torch.bool)
    st, created, _, _ = tchurn.step(st, p, alive, torch.tensor(0),
                                    torch.tensor(10 ** 12), R.PRNGKey(1))
    assert created.shape == (p.num_slots,) and bool(created.any())
    bad = dict(kw, **({"lifetime_dist": "bogus"} if "lifetime_dist" in kw
                      else {"model": "bogus"}))
    with pytest.raises(ValueError):
        tchurn.init(R.PRNGKey(0), tchurn.ChurnParams(target_num=4, **bad))
