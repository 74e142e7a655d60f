"""The port's threefry RNG (oversim_tpu_torch/rng.py) against jax.random.

Bit-equal: PRNGKey, split, fold_in (scalar and batched), bits, uniform
(float32 and float64, with and without minval/maxval) and randint
(int32 spans across the u32 multiplier wrap, int64, batched keys).
``normal`` shares the exact uniform draw but uses PyTorch's erfinv,
which differs from XLA's in the last ulps: held within 128 ulp (the
largest gap measured on these seeds is 66 ulp in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu_torch import rng as R

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

SEEDS = [0, 1, 3, 12345, 2**40 + 7]


def _u(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    assert np.array_equal(_u(k), t.numpy())
    for num in (2, 6, 7, 8):
        assert np.array_equal(_u(jax.random.split(k, num)),
                              R.split(t, num).numpy())
    for d in (0, 1, 5, 2**31 + 3):
        assert np.array_equal(_u(jax.random.fold_in(k, d)),
                              R.fold_in(t, d).numpy())
    idx = jnp.arange(37)
    fv = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k, idx)
    assert np.array_equal(_u(fv), R.fold_in(t, torch.arange(37)).numpy())
    # batched keys split independently
    kb = jax.random.split(k, 5)
    assert np.array_equal(_u(jax.vmap(lambda x: jax.random.split(x, 8))(kb)),
                          R.split(R.split(t, 5), 8).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for shape in [(), (1,), (5,), (3, 5), (4, 2, 3)]:
        b = jax.random.bits(k, shape, dtype=jnp.uint32)
        assert np.array_equal(_u(b), R.bits(t, shape).numpy())
    b64 = np.asarray(jax.random.bits(k, (9,), dtype=jnp.uint64))
    assert np.array_equal(b64.view(np.int64), R.bits(t, (9,), 64).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    cases = [((100,), jnp.float32, torch.float32, 0.0, 1.0),
             ((10, 2), jnp.float32, torch.float32, 0.0, 150.0),
             ((64,), jnp.float64, torch.float64, 0.0, 1.0),
             ((), jnp.float64, torch.float64, 0.0, 0.2),
             ((33,), jnp.float32, torch.float32, -1.5, 2.25)]
    for shape, jd, td, lo, hi in cases:
        u = jax.random.uniform(k, shape, dtype=jd, minval=lo, maxval=hi)
        assert np.array_equal(np.asarray(u), R.uniform(t, shape, td, lo,
                                                       hi).numpy())
    kb = jax.random.split(k, 6)
    u = jax.vmap(lambda x: jax.random.uniform(x, (), minval=0.0,
                                              maxval=0.2))(kb)
    assert np.array_equal(np.asarray(u), R.uniform(
        R.split(t, 6), (), torch.float64, 0.0, 0.2).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    # spans below and above 2^16 (the u32 multiplier wraps above it),
    # and the bounds the engine uses (n_ready at logic.py:129)
    for hi in [1, 2, 7, 16, 10000, 65537, 70000, 2**31 - 1]:
        r = jax.random.randint(k, (50,), 0, hi, dtype=jnp.int32)
        assert np.array_equal(np.asarray(r), R.randint(t, (50,), 0, hi,
                                                       torch.int32).numpy())
    r = jax.random.randint(k, (50,), -5, 9, dtype=jnp.int32)
    assert np.array_equal(np.asarray(r), R.randint(t, (50,), -5, 9,
                                                   torch.int32).numpy())
    r = jax.random.randint(k, (50,), 0, 10**9, dtype=jnp.int64)
    assert np.array_equal(np.asarray(r), R.randint(t, (50,), 0, 10**9,
                                                   torch.int64).numpy())
    # batched per-node keys, traced maxval (sample_ready's draw)
    kb = jax.random.split(k, 9)
    r = jax.vmap(lambda x: jax.random.randint(
        x, (), 0, jnp.maximum(jnp.int32(13), 1), dtype=jnp.int32))(kb)
    tr = R.randint(R.split(t, 9), (), 0, torch.tensor(13), torch.int32)
    assert np.array_equal(np.asarray(r), tr.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_erfinv_gap(seed):
    k, t = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    n = np.asarray(jax.random.normal(k, (2000,), dtype=jnp.float32))
    tn = R.normal(t, (2000,), torch.float32).numpy()
    gap = np.abs(n.view(np.int32).astype(np.int64)
                 - tn.view(np.int32).astype(np.int64))
    assert gap.max() <= 128
    n = np.asarray(jax.random.normal(k, (2000,), dtype=jnp.float64))
    tn = R.normal(t, (2000,), torch.float64).numpy()
    gap = np.abs(n.view(np.int64) - tn.view(np.int64))
    assert gap.max() <= 128
