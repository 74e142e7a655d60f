"""ParetoChurn, RandomChurn and the pareto_shifted / truncnormal lifetimes:
the port against the JAX package.

The draws behind them are held bit for bit where the JAX package's are
deterministic functions of its uniform bits:

(a) ``xlamath.pow`` against ``jnp.power`` (XLA-CPU calls the C library's
    ``pow``) on 1.2 million inputs, the exponents of the Pareto draws:
    0 mismatches; ``torch.pow``'s own mismatch count is printed beside;
(b) ``xlamath.xla_sum`` against ``jnp.sum`` of float64 vectors of 1 to
    60,000 elements (1.2 million in all): 0 mismatches;
(c) ``rng.categorical`` against ``jax.random.categorical`` over RandomChurn's
    0/1 weights, 600 draws of 2,000 slots: every index equal (the Gumbel
    values' last bits, where PyTorch's ``log`` and XLA's differ, are
    counted: they cannot move the pick, since no two candidates tie);
(d) ParetoChurn at 36 slots (its float64 sums over the 3x target slots
    take XLA's tree, n > 32) for init and 64 windows, and at the chip's
    30,000 slots for init: every leaf and event mask equal;
(e) RandomChurn for 64 windows and LifetimeChurn with pareto_shifted
    lifetimes for 64 windows: every leaf equal;
(f) ``rng.weibull_min`` at shapes 0.7, 1.5 and 3 (LifetimeChurn's
    ``lifetimeDistPar1``), 300,000 draws each: bit-exact (XLA-CPU's
    ``log1p``, then the C library's ``pow``);
(g) truncnormal lifetimes (a normal draw, whose erfinv the port matches
    only to a few ulp, ROADMAP Queue C) by their statistics: mean within
    0.5% and standard deviation within 1% of the JAX package's over
    200,000 draws.

``init_deviation = 0`` keeps the creation ramps off the normal draw.  The
JAX side runs in one fresh interpreter (test_torch_engine.py says why),
started before the port's runs.
"""

import numpy as np
import pytest
import torch

from oversim_tpu_torch import churn as tchurn
from oversim_tpu_torch import rng as R
from oversim_tpu_torch import xlamath
from test_torch_engine import JaxCall

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

WINDOW_NS = 100_000_000
STEPS = 64
LEAVES = ("t_create", "t_kill", "t_dead", "graceful", "l_mean", "d_mean",
          "t_tick")
RUNS = {
    "pareto": dict(model="pareto", target_num=12, init_interval=0.2,
                   init_deviation=0.0, lifetime_mean=8.0, deadtime_mean=5.0,
                   graceful_leave_delay=1.0),
    "random": dict(model="random", target_num=12, init_interval=0.2,
                   init_deviation=0.0, churn_change_interval=0.3,
                   graceful_leave_delay=1.0),
    "pshift": dict(model="lifetime", target_num=12, init_interval=0.2,
                   init_deviation=0.0, lifetime_mean=6.0,
                   lifetime_dist="pareto_shifted", lifetime_par1=3.0,
                   graceful_leave_delay=1.0),
}
BIG = dict(model="pareto", target_num=10_000, init_interval=0.002,
           init_deviation=0.0, lifetime_mean=1000.0, deadtime_mean=1000.0)
POW_EXPONENTS = (-1 / 3, -1 / 2, -1 / 1.5, -1 / 5)
SUM_SIZES = (1, 7, 24, 32, 33, 36, 64, 100, 999, 1025, 30_000, 60_000)
CAT = (600, 2000)       # draws, slots
TN = dict(model="lifetime", lifetime_dist="truncnormal", lifetime_mean=50.0)
TN_DRAWS = 200_000
WEIBULL_K = (0.7, 1.5, 3.0)


def pow_inputs(seed=11):
    rs = np.random.RandomState(seed)
    return np.concatenate([np.maximum(rs.random_sample(280_000), 1e-12),
                           rs.random_sample(20_000),
                           np.array([1e-12, 0.5, 1 - 2 ** -52, 2 ** -40])])


def sum_inputs(seed=12):
    rs = np.random.RandomState(seed)
    out = []
    for n in SUM_SIZES:
        for _ in range(max(1, 1_200_000 // len(SUM_SIZES) // n)):
            x = rs.random_sample(n) * 1000.0
            out.append(np.where(rs.random_sample(n) < 0.7, 1.0 / (x + 1), 0))
    return out


def cat_weights(seed=13):
    rs = np.random.RandomState(seed)
    w = (rs.random_sample(CAT) < rs.random_sample((CAT[0], 1))).astype(float)
    w[0] = 0.0          # no eligible slot: the pick is unused, still equal
    return w


def churn_trace(mod, p, st, steps, key, step):
    """(init leaves + per-window leaves and event masks) of ``steps``
    windows from ``st``; ``mod`` is either package's churn module."""
    out = {f"init.{k}": np.asarray(getattr(st, k)) for k in LEAVES}
    rec = {k: [] for k in LEAVES + ("created", "killed", "leaving")}
    alive = None
    for i in range(steps):
        key, sub, alive, st, ev = step(key, alive, st, i)
        for k in LEAVES:
            rec[k].append(np.asarray(getattr(st, k)))
        for k, v in zip(("created", "killed", "leaving"), ev):
            rec[k].append(np.asarray(v))
    out.update({k: np.stack(v) for k, v in rec.items()})
    return out


# -- the JAX side (one fresh interpreter) -------------------------------------

def jax_side():
    import jax
    import jax.numpy as jnp
    from oversim_tpu import churn as jchurn
    out = {}
    x = pow_inputs()
    for i, y in enumerate(POW_EXPONENTS):
        out[f"pow{i}"] = np.asarray(jax.jit(lambda u, y=y: jnp.power(u, y))(x))
    fsum = jax.jit(jnp.sum)
    out["sums"] = np.asarray([float(fsum(v)) for v in sum_inputs()])
    w = cat_weights()
    logits = np.log(np.maximum(w, 1e-30))
    keys = jax.random.split(jax.random.PRNGKey(5), CAT[0])
    cat = jax.jit(jax.random.categorical)
    gum = jax.jit(lambda k: jax.random.gumbel(k, (CAT[1],), jnp.float64))
    out["cat"] = np.asarray([int(cat(keys[i], logits[i]))
                             for i in range(CAT[0])])
    out["gumbel"] = np.stack([np.asarray(gum(keys[i]))
                              for i in range(CAT[0])])
    step = jax.jit(jchurn.step, static_argnums=(1,))
    for name, kw in RUNS.items():
        p = jchurn.ChurnParams(**kw)

        def one(key, alive, st, i, p=p):
            alive = jnp.zeros((p.num_slots,), bool) if alive is None \
                else alive
            key, sub = jax.random.split(key)
            st, c, k, lv = step(st, p, alive, jnp.int64(i * WINDOW_NS),
                                jnp.int64((i + 1) * WINDOW_NS), sub)
            return key, sub, (alive | c) & ~k, st, (c, k, lv)

        st = jchurn.init(jax.random.PRNGKey(3), p)
        for k, v in churn_trace(jchurn, p, st, STEPS,
                                jax.random.PRNGKey(4), one).items():
            out[f"{name}/{k}"] = v
    st = jchurn.init(jax.random.PRNGKey(1), jchurn.ChurnParams(**BIG))
    for k in LEAVES:
        out[f"big/{k}"] = np.asarray(getattr(st, k))
    p = jchurn.ChurnParams(target_num=1, **TN)
    out["tn"] = np.asarray(jchurn._draw_lifetime(
        jax.random.PRNGKey(8), p, (TN_DRAWS,)))
    for k in WEIBULL_K:
        out[f"weibull{k}"] = np.asarray(jax.random.weibull_min(
            jax.random.PRNGKey(9), 123.4, k, (300_000,)))
    return out


@pytest.fixture(scope="module")
def ref():
    call = JaxCall("test_torch_churn_models", "jax_side")
    return call.result()


def port_run(name):
    p = tchurn.ChurnParams(**RUNS[name])

    def one(key, alive, st, i):
        alive = torch.zeros((p.num_slots,), dtype=torch.bool) \
            if alive is None else alive
        key, sub = R.split(key)
        st, c, k, lv = tchurn.step(st, p, alive, torch.tensor(i * WINDOW_NS),
                                   torch.tensor((i + 1) * WINDOW_NS), sub)
        return key, sub, (alive | c) & ~k, st, (c, k, lv)

    st = tchurn.init(R.PRNGKey(3), p)
    return churn_trace(tchurn, p, st, STEPS, R.PRNGKey(4), one)


def assert_same(ref, name, got):
    for k, v in got.items():
        want = ref[f"{name}/{k}"]
        assert v.dtype == want.dtype and v.shape == want.shape, k
        assert np.array_equal(v, want), (name, k)


def test_pow_bit_exact_with_xla(ref):
    x = torch.from_numpy(pow_inputs())
    assert x.numel() >= 300_000 and 4 * x.numel() >= 1_200_000
    for i, y in enumerate(POW_EXPONENTS):
        got = xlamath.pow(x, y).numpy()
        assert int(np.sum(got != ref[f"pow{i}"])) == 0, y
    # torch.pow is not the C library's: the reason for xlamath.pow
    torch_bad = int(np.sum(torch.pow(x, -0.5).numpy() != ref["pow1"]))
    print("torch.pow mismatches at y=-1/2:", torch_bad, "of", x.numel())
    assert torch_bad > 0


def test_xla_sum_order(ref):
    vecs = sum_inputs()
    assert sum(v.size for v in vecs) >= 1_000_000
    got = np.asarray([float(xlamath.xla_sum(torch.from_numpy(v)))
                      for v in vecs])
    assert int(np.sum(got != ref["sums"])) == 0


def test_categorical_matches_jax(ref):
    w = cat_weights()
    logits = torch.log(torch.clamp(torch.from_numpy(w), min=1e-30))
    keys = R.split(R.PRNGKey(5), CAT[0])
    picks = np.asarray([int(R.categorical(keys[i], logits[i]))
                        for i in range(CAT[0])])
    assert np.array_equal(picks, ref["cat"])
    gum = torch.stack([R.gumbel(keys[i], (CAT[1],)) for i in range(CAT[0])])
    differ = int(np.sum(gum.numpy() != ref["gumbel"]))
    print("gumbel values differing in the last bits:", differ, "of",
          gum.numel())
    assert differ < gum.numel() // 100


@pytest.mark.parametrize("name", list(RUNS))
def test_churn_model_leaf_exact(ref, name):
    got = port_run(name)
    assert_same(ref, name, got)
    events = sum(int(got[k].sum()) for k in ("created", "killed"))
    assert events >= 12, events
    if name == "random":
        assert int(got["killed"].sum()) > 0


def test_pareto_init_leaf_exact_at_chip_size(ref):
    st = tchurn.init(R.PRNGKey(1), tchurn.ChurnParams(**BIG))
    assert_same(ref, "big", {k: getattr(st, k).numpy() for k in LEAVES})
    n_part = int((st.t_create < tchurn.T_INF).sum())
    assert 10_000 <= n_part < 30_000


def test_weibull_any_shape_bit_exact(ref):
    for k in WEIBULL_K:
        got = R.weibull_min(R.PRNGKey(9), 123.4, k, (300_000,)).numpy()
        assert int(np.sum(got != ref[f"weibull{k}"])) == 0, k


def test_truncnormal_lifetime_statistics(ref):
    p = tchurn.ChurnParams(target_num=1, **TN)
    got = tchurn._draw_lifetime(R.PRNGKey(8), p, (TN_DRAWS,)).numpy()
    want = ref["tn"]
    assert abs(got.mean() / want.mean() - 1) < 0.005
    assert abs(got.std() / want.std() - 1) < 0.01
    assert abs(got.mean() / TN["lifetime_mean"] - 1) < 0.01
