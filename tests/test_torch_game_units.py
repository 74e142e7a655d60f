"""Units of the GIA, Vast and Quon slice against the jitted JAX functions
(in process; a jitted JAX tick multiplies where eager JAX divides by a
constant, so every JAX side here is jitted):

(a) the six movement generators, 12 steps each in the all-[N] form, and
    the four classic ones in the per-node form the game overlays' vmapped
    steps use (a key per node);
(b) GIA's table of XLA-CPU's float32 ``log(cap + 1e-3)`` (``LOG_CAP``)
    and glibc's ``sinf``/``cosf`` (``xlamath``, the hotspot generator's)
    on every eighth angle the generator can draw;
(c) ``rng.categorical`` with ``shape=`` (GIA's capacity classes);
(d) Vast's and Quon's ``_nbr_put`` on grid positions, where distances
    tie, with duplicates, the node itself and free slots among the
    candidates;
(e) GIA's ``_nbr_add`` (first free slot, first weakest neighbor) and
    ``_forward_target`` (capacity-biased Gumbel picks over equal
    capacities).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oversim_tpu_torch import rng as trng
from oversim_tpu_torch import xlamath
from oversim_tpu_torch.apps import movement as tmove
from oversim_tpu_torch.overlay import gia as tgia
from oversim_tpu_torch.overlay import quon as tquon
from oversim_tpu_torch.overlay import vast as tvast

torch.set_num_threads(1)

N = 64
STEPS = 12


def _np(x):
    return np.asarray(x)


def test_movement_generators_match_jax():
    from oversim_tpu.apps import movement as jmove
    for gen in jmove.GENERATORS:
        for field, speed in ((300.0, 5.0), (1000.0, 7.0)):
            jp = jmove.MoveParams(generator=gen, field=field, speed=speed)
            tp = tmove.MoveParams(generator=gen, field=field, speed=speed)

            def walk(seed, t_s):
                k = jax.random.PRNGKey(seed)
                pos, wp = jmove.init_positions(k, N, jp)
                out = [pos, wp]
                for i in range(STEPS):
                    k, s = jax.random.split(k)
                    pos, wp = jmove.step(pos, wp, jnp.float32(5.0), s, jp,
                                         t_s=t_s + 5.0 * i)
                    out += [pos, wp]
                return out

            ref = jax.jit(walk)(5, jnp.float32(130.0))
            k = trng.PRNGKey(5)
            pos, wp = tmove.init_positions(k, N, tp)
            got = [pos, wp]
            for i in range(STEPS):
                k, s = trng.split(k).unbind(-2)
                pos, wp = tmove.step(
                    pos, wp, torch.tensor(5.0), s, tp,
                    t_s=torch.tensor(130.0, dtype=torch.float32) + 5.0 * i)
                got += [pos, wp]
            bad = [i for i, (x, y) in enumerate(zip(ref, got))
                   if not np.array_equal(_np(x), y.numpy())]
            assert not bad, (gen, field, bad[:5])
            if gen in ("groupRoaming", "realWorldRoaming"):
                ks = trng.split(trng.PRNGKey(9), N)
                with pytest.raises(ValueError, match="all-"):
                    tmove.step(pos, wp, 5.0, ks, tp)
                continue

            def per_node(seed):
                pos, wp = jmove.init_positions(jax.random.PRNGKey(seed), N,
                                               jp)
                ks = jax.random.split(jax.random.PRNGKey(9), N)
                return jax.vmap(lambda p_, w_, k_: jmove.step(
                    p_, w_, jnp.float32(5.0), k_, jp))(pos, wp, ks)

            ref = jax.jit(per_node)(5)
            pos, wp = tmove.init_positions(trng.PRNGKey(5), N, tp)
            got = tmove.step(pos, wp, torch.tensor(5.0),
                             trng.split(trng.PRNGKey(9), N), tp)
            for x, y in zip(ref, got):
                assert np.array_equal(_np(x), y.numpy()), gen


def test_log_table_and_sincos_match_xla():
    caps = np.array(sorted(tgia.LOG_CAP), np.float32)
    want = _np(jax.jit(lambda c: jnp.log(c + 1e-3))(caps))
    assert [int(b) for b in want.view(np.uint32)] == [
        tgia.LOG_CAP[float(c)] for c in caps]
    got = tgia.log_cap(torch.tensor(np.tile(caps, 3)))
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.tile(want, 3).view(np.uint32))
    # the hotspot's angles: uniform(0, 2 pi) in float32, every eighth
    k = np.arange(0, 2 ** 23, 8, dtype=np.uint32)
    u = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
    ang = np.maximum(np.float32(0.0), u * np.float32(2 * np.pi))
    extra = np.random.default_rng(1).uniform(-7, 7, 100_000)
    for x in (ang, extra.astype(np.float32)):
        for jf, tf in ((jnp.sin, xlamath.sinf), (jnp.cos, xlamath.cosf)):
            a = _np(jax.jit(jf)(x)).view(np.uint32)
            b = tf(torch.tensor(x)).numpy().view(np.uint32)
            assert np.array_equal(a, b), (jf.__name__, int((a != b).sum()))


def test_categorical_shape_matches_jax():
    logits = np.log(np.array(tgia.CAP_PROBS))
    f = jax.jit(lambda s: jax.random.categorical(
        jax.random.PRNGKey(s), jnp.asarray(logits), shape=(20_000,)))
    for seed in (0, 1, 7):
        got = trng.categorical(trng.PRNGKey(seed), torch.tensor(logits),
                               shape=(20_000,))
        assert np.array_equal(_np(f(seed)), got.numpy()), seed
    from oversim_tpu.overlay import gia as jgia
    a = jax.jit(lambda k: jgia.GiaLogic().init(k, 5_000).capacity)(
        jax.random.PRNGKey(11))
    b = tgia.GiaLogic().init(trng.PRNGKey(11), 5_000).capacity
    assert np.array_equal(_np(a), b.numpy())


def _vast_inputs(d, seed):
    """A batch of per-node neighbor sets and one candidate each on a
    coarse grid (equal distances everywhere), with free slots, repeated
    and self candidates."""
    rng = np.random.default_rng(seed)
    n = 256
    me_pos = rng.integers(0, 4, (n, 2)).astype(np.float32) * 10
    nbr = rng.integers(-1, 12, (n, d)).astype(np.int32)
    nbr_pos = rng.integers(0, 4, (n, d, 2)).astype(np.float32) * 10
    seen = rng.integers(0, 5, (n, d)).astype(np.int64)
    node_idx = rng.integers(0, 12, n).astype(np.int32)
    cands = rng.integers(-1, 12, (n, 1)).astype(np.int32)
    cands[::7, 0] = node_idx[::7]
    cand_pos = rng.integers(0, 4, (n, 1, 2)).astype(np.float32) * 10
    now = rng.integers(10, 20, n).astype(np.int64)
    return nbr, nbr_pos, seen, cands, cand_pos, now, me_pos, node_idx


@pytest.mark.parametrize("ov", ["vast", "quon"])
def test_nbr_put_with_ties_matches_jax(ov):
    from oversim_tpu.overlay import quon as jquon
    from oversim_tpu.overlay import vast as jvast
    jcls, tcls = ((jvast.VastLogic, tvast.VastLogic) if ov == "vast"
                  else (jquon.QuonLogic, tquon.QuonLogic))
    d = 8
    jl, tl = jcls(), tcls()
    for seed in range(3):
        nbr, nbr_pos, seen, cands, cand_pos, now, me_pos, node_idx = \
            _vast_inputs(d, seed)
        n = nbr.shape[0]
        z2 = np.zeros((n, 2), np.float32)
        z = np.zeros((n,), np.int64)
        jst = jvast.VastState(
            state=np.zeros((n,), np.int32), pos=me_pos, wp=z2, nbr=nbr,
            nbr_pos=nbr_pos, nbr_seen=seen, t_join=z, t_move=z, t_prune=z,
            seq=np.zeros((n,), np.int32))
        ref = jax.jit(jax.vmap(jl._nbr_put))(jst, cands, cand_pos, now,
                                             me_pos, node_idx)
        tst = tvast.VastState(**{
            f.name: torch.as_tensor(getattr(jst, f.name))
            for f in dataclasses.fields(tvast.VastState)})
        got = tl._nbr_put(tst, torch.as_tensor(cands),
                          torch.as_tensor(cand_pos), torch.as_tensor(now),
                          torch.as_tensor(me_pos), torch.as_tensor(node_idx))
        for name in ("nbr", "nbr_pos", "nbr_seen"):
            assert np.array_equal(_np(getattr(ref, name)),
                                  getattr(got, name).numpy()), (ov, name)


def test_gia_nbr_add_and_forward_target_match_jax():
    from oversim_tpu.overlay import gia as jgia
    rng = np.random.default_rng(3)
    n, d = 512, 4
    classes = np.array(tgia.CAP_CLASSES, np.float32)
    nbr = rng.integers(-1, 9, (n, d)).astype(np.int32)
    nbr_cap = np.where(nbr >= 0, classes[rng.integers(0, 2, (n, d))],
                       0).astype(np.float32)
    tokens = rng.integers(0, 2, (n, d)).astype(np.int32)
    peer = rng.integers(0, 9, n).astype(np.int32)
    cap = classes[rng.integers(0, 3, n)]
    en = rng.random(n) < 0.8
    exclude = np.where(rng.random(n) < 0.5, -1, rng.integers(0, 9, n)) \
        .astype(np.int32)
    z = np.zeros((n,), np.int64)
    jst = jgia.GiaState(
        state=np.zeros((n,), np.int32), capacity=cap, nbr=nbr,
        nbr_cap=nbr_cap, tokens=tokens, t_join=z, t_adapt=z, t_token=z,
        t_search=z, s_active=np.zeros((n,), bool),
        s_seq=np.zeros((n,), np.int32), s_t0=z, s_to=z)
    jl, tl = jgia.GiaLogic(params=jgia.GiaParams(max_neighbors=d)), \
        tgia.GiaLogic(params=tgia.GiaParams(max_neighbors=d))
    tst = tgia.GiaState(**{f.name: torch.as_tensor(getattr(jst, f.name))
                           for f in dataclasses.fields(tgia.GiaState)})
    ref = jax.jit(jax.vmap(jl._nbr_add))(jst, peer, cap, en)
    got = tl._nbr_add(tst, torch.as_tensor(peer), torch.as_tensor(cap),
                      torch.as_tensor(en))
    for name in ("nbr", "nbr_cap", "tokens"):
        assert np.array_equal(_np(getattr(ref[0], name)),
                              getattr(got[0], name).numpy()), name
    assert np.array_equal(_np(ref[1]), got[1].numpy())
    assert np.array_equal(_np(ref[2]), got[2].numpy())
    # at least one replacement of a weakest neighbor and one rejection
    assert bool((got[2] >= 0).any()) and bool((~got[1] & torch.as_tensor(
        en)).any())
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    ref = jax.jit(jax.vmap(jl._forward_target))(jst, keys, exclude)
    tkeys = trng.split(trng.PRNGKey(4), n)
    got = tl._forward_target(
        tst, tgia.log_cap(tst.nbr_cap),
        trng.gumbel(tkeys, (d,), torch.float64), torch.as_tensor(exclude))
    for x, y in zip(ref, got):
        assert np.array_equal(_np(x), y.numpy())
