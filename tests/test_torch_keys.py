"""The port's key arithmetic (oversim_tpu_torch/core/keys.py) against
oversim_tpu/core/keys.py on random keys: exactly equal.

Keys travel as u32 lanes in the JAX package and as zero-extended int64
in the port; inputs are made with numpy from a seed and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu.core import keys as JK
from oversim_tpu_torch.core import keys as TK

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)


def _keys(rng, shape, spec, structured=False):
    k = rng.integers(0, 2**32, size=tuple(shape) + (spec.lanes,),
                     dtype=np.uint64).astype(np.uint32)
    if structured:
        # long shared prefixes: only the low lane varies much
        k[..., :-1] = k[(0,) * len(shape)][:-1]
        k[..., -1] &= 0xF
    k[..., 0] &= spec.top_lane_mask
    return k


def _j(k):
    return jnp.asarray(k, jnp.uint32)


def _t(k):
    return torch.as_tensor(k.astype(np.int64))


@pytest.mark.parametrize("bits", [160, 64, 100])
def test_arithmetic_and_compares(bits):
    spec_j, spec_t = JK.KeySpec(bits), TK.KeySpec(bits)
    rng = np.random.default_rng(bits)
    a, b = _keys(rng, (200,), spec_j), _keys(rng, (200,), spec_j)
    b[:20] = a[:20]                       # equal pairs
    b[20:40, :-1] = a[20:40, :-1]         # long shared prefixes
    ja, jb, ta, tb = _j(a), _j(b), _t(a), _t(b)
    assert np.array_equal(np.asarray(JK.lt(ja, jb)), TK.lt(ta, tb).numpy())
    assert np.array_equal(np.asarray(JK.gt(ja, jb)), TK.gt(ta, tb).numpy())
    for jf, tf in [(JK.add, TK.add), (JK.sub, TK.sub)]:
        assert np.array_equal(np.asarray(jf(ja, jb, spec_j)).astype(np.int64),
                              tf(ta, tb, spec_t).numpy())
    assert np.array_equal(
        np.asarray(JK.shared_prefix_length(ja, jb, spec_j)),
        TK.shared_prefix_length(ta, tb, spec_t).numpy())
    assert np.array_equal(np.asarray(JK.pow2_table(spec_j)).astype(np.int64),
                          TK.pow2_table(spec_t).numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_random_keys_and_dup_mask(seed):
    k = jax.random.PRNGKey(seed)
    from oversim_tpu_torch import rng as R
    t = R.PRNGKey(seed)
    jk = JK.random_keys(k, (17,), JK.DEFAULT_SPEC)
    assert np.array_equal(np.asarray(jk).astype(np.int64),
                          TK.random_keys(t, (17,), TK.DEFAULT_SPEC).numpy())
    rng = np.random.default_rng(seed)
    v = rng.integers(-1, 6, size=(4, 24)).astype(np.int32)
    jd = jax.vmap(JK.dup_mask)(jnp.asarray(v))
    assert np.array_equal(np.asarray(jd), TK.dup_mask(torch.as_tensor(v))
                          .numpy())


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("structured", [False, True])
def test_sort_by_distance(approx, structured):
    spec = JK.DEFAULT_SPEC
    rng = np.random.default_rng(11 + approx + 2 * structured)
    d = _keys(rng, (6, 40), spec, structured=structured)
    d[:, 5:9] = 0xFFFFFFFF                   # NO_NODE rows tie at UMAX
    d[:, 20] = d[:, 3]                       # exact ties keep input order
    pay = rng.integers(-1, 1000, size=(6, 40)).astype(np.int32)
    flags = rng.integers(0, 4, size=(6, 40)).astype(np.int32)
    js, (jp, jf) = JK.sort_by_distance(_j(d), (jnp.asarray(pay),
                                               jnp.asarray(flags)),
                                       approx=approx)
    ts, (tp, tf) = TK.sort_by_distance(_t(d), (torch.as_tensor(pay),
                                               torch.as_tensor(flags)),
                                       approx=approx)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())


def _triples(rng, spec, m=300):
    """(key, a, b) batches with the ring's edge cases: a == b, key == a,
    key == b, all three equal, wrap-around intervals (a > b), keys at 0
    and at the top of the ring, and shared prefixes."""
    k, a, b = (_keys(rng, (m,), spec) for _ in range(3))
    b[:30] = a[:30]                               # a == b: the whole ring
    k[30:60] = a[30:60]                           # key == a
    k[60:90] = b[60:90]                           # key == b
    k[90:110] = a[90:110]
    b[90:110] = a[90:110]                         # all equal
    top = np.full(spec.lanes, 0xFFFFFFFF, np.uint32)
    top[0] = spec.top_lane_mask
    k[110:130] = 0                                # key at 0
    a[130:150] = top                              # a at the top: wraps
    k[150:170, :-1] = a[150:170, :-1]             # shared prefixes
    return k, a, b


@pytest.mark.parametrize("name", ["eq", "is_between", "is_between_r",
                                  "is_between_l", "is_between_lr",
                                  "ring_distance"])
@pytest.mark.parametrize("bits", [160, 64, 100])
def test_ring_predicates(name, bits):
    spec_j, spec_t = JK.KeySpec(bits), TK.KeySpec(bits)
    k, a, b = _triples(np.random.default_rng(7 + bits), spec_j)
    if name == "eq":
        want, got = JK.eq(_j(k), _j(a)), TK.eq(_t(k), _t(a))
    elif name == "ring_distance":
        want = np.asarray(JK.ring_distance(_j(a), _j(k), spec_j)).astype(
            np.int64)
        got = TK.ring_distance(_t(a), _t(k), spec_t)
    else:
        want = getattr(JK, name)(_j(k), _j(a), _j(b), spec_j)
        got = getattr(TK, name)(_t(k), _t(a), _t(b), spec_t)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_folded_words_order_like_the_lanes():
    """``fold_lanes`` + ``lex_lt_eq`` (the port's int64 compare of
    multi-lane keys, used by Chord's findNode) equal ``lt`` / ``eq``."""
    for bits in (160, 64, 100, 32):
        spec = JK.KeySpec(bits)
        k, a, _ = _triples(np.random.default_rng(bits), spec)
        lt, eq = TK.lex_lt_eq(TK.fold_lanes(_t(k)), TK.fold_lanes(_t(a)))
        assert np.array_equal(np.asarray(JK.lt(_j(k), _j(a))), lt.numpy())
        assert np.array_equal(np.asarray(JK.eq(_j(k), _j(a))), eq.numpy())
