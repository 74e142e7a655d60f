"""Counter-based random numbers: a PyTorch copy of ``jax.random``.

The engine's RNG is part of its state: every draw comes from an explicit
key that is split and folded exactly like the JAX package's
(threefry2x32 in partitionable mode, jax 0.9.0), so the two packages
produce the same bits from the same seed.

Representation: a key is an int64 tensor ``[..., 2]`` holding two
zero-extended u32 words; leading dimensions batch independent keys
(the port writes per-node code over a leading ``[N]`` axis instead of
vmapping it).  Every u32 value is carried in int64 and masked after
each add/shift, because PyTorch lacks shifts and adds for ``uint32``.

Bit recipes (``jax/_src/prng.py``, ``jax/_src/random.py``):

* ``split(k, n)[i] == fold_in(k, i) == threefry(k, (0, i))``;
* ``bits`` (32): ``y0 ^ y1`` of ``threefry(k, (0, iota))``; (64):
  ``y0 << 32 | y1``;
* ``uniform``: mantissa bits under the exponent of 1.0, minus 1.0, then
  ``x * (hi - lo) + lo`` clamped below at ``lo``;
* ``randint``: two draws (higher/lower bits from ``split(k)``) folded
  through a power-of-two multiplier modulo the span;
* ``normal``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform in
  ``(nextafter(-1, 0), 1)``.  ``u`` is bit-exact; ``erfinv`` is
  PyTorch's, which differs from XLA's in the last ulps;
* ``weibull_min``: ``(-log1p(-u))^(1/k) * scale`` for ``u`` uniform in
  ``[0, 1)``, with XLA-CPU's own float64 ``log1p`` and the C library's
  ``pow`` (``xlamath``), so the draws are bit-exact;
* ``categorical``: ``argmax(gumbel + logits)``, the Gumbel draw in JAX's
  default "low" mode, ``-log(-log(u))`` for ``u`` uniform in
  ``[tiny, 1)``.  ``u`` is bit-exact; the logs are PyTorch's, which can
  change the pick only where two candidates' Gumbel values round equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from oversim_tpu_torch import xlamath

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on broadcastable int64 u32 tensors.

    ``x0`` is carried unmasked (its 26 sums of u32 values fit in int64)
    and masked only at the end: it reaches ``y0`` through an xor, whose
    low 32 bits the mask of ``y0`` keeps.  ``y0`` is masked after every
    step, as the rotation's right shift needs."""
    k1, k2, x1, x2 = torch.broadcast_tensors(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = x1 + ks[0]
    y0 = (x2 + ks[1]).bitwise_and_(M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(y0)
            y0 = ((y0 << r).bitwise_or_(y0 >> (32 - r))
                  .bitwise_xor_(x0).bitwise_and_(M32))
        x0.add_(ks[(i + 1) % 3])
        y0.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0.bitwise_and_(M32), y0


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """Legacy key from an integer seed (hi and lo 32-bit halves), made by
    fills on ``device`` (a host list's copy to the card would
    synchronise: tick code makes keys, e.g. NTree's positions)."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.stack([device_scalar(seed >> 32, torch.int64, device),
                        device_scalar(seed & M32, torch.int64, device)])


def device_scalar(v, dtype, device):
    """``v`` (a python number or a tensor) as a ``dtype`` tensor on
    ``device``, made by a fill rather than a host-to-device copy: a copy
    from pageable memory synchronises the host with the card."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _counts(key, shape):
    """Flat iota of ``shape`` shaped to broadcast after the key batch."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    return lo


def _hash(key, shape):
    """(y0, y1) of threefry over the iota of ``shape`` for every key in
    the batch: output shape ``key.shape[:-1] + shape``."""
    b = key.shape[:-1]
    k1 = key[..., 0].reshape(b + (1,) * len(shape))
    k2 = key[..., 1].reshape(b + (1,) * len(shape))
    lo = _counts(key, shape)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``[..., 2]`` → ``[..., num, 2]``."""
    y0, y1 = _hash(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold ``data`` (int or int tensor, taken mod 2^32) into ``key``;
    a tensor ``data`` of shape D with a ``[2]`` key gives ``D + [2]``."""
    data = device_scalar(data, torch.int64, key.device) & M32
    k1, k2 = key[..., 0], key[..., 1]
    if data.dim():
        k1 = k1.reshape(k1.shape + (1,) * data.dim())
        k2 = k2.reshape(k2.shape + (1,) * data.dim())
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape=(), width: int = 32) -> torch.Tensor:
    """Uniform random bits as int64 (u32 for width 32; for width 64 the
    u64 pattern reinterpreted as int64)."""
    y0, y1 = _hash(key, tuple(shape))
    if width == 32:
        return y0 ^ y1
    if width == 64:
        return (y0 << 32) | y1
    raise ValueError("bits: width must be 32 or 64")


def _float_consts(dtype):
    if dtype == torch.float32:
        return 32, 23, 0x3F800000, torch.int32
    if dtype == torch.float64:
        return 64, 52, 0x3FF0000000000000, torch.int64
    raise ValueError(f"uniform: unsupported dtype {dtype}")


def uniform(key, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform``.  Under the JAX package's x64 mode the
    default float is float64: call sites that rely on it pass
    ``dtype=torch.float64``."""
    shape = tuple(shape)
    nbits, nmant, one_bits, int_t = _float_consts(dtype)
    b = bits(key, shape, nbits)
    if nbits == 32:
        fb = (b >> (32 - nmant)) | one_bits
    else:
        # logical shift of the u64 pattern: the sign bit must not smear
        fb = ((b >> (64 - nmant)) & ((1 << nmant) - 1)) | one_bits
    floats = fb.to(int_t).view(dtype) - torch.ones((), dtype=dtype,
                                                    device=key.device)
    lo = device_scalar(minval, dtype, key.device)
    hi = device_scalar(maxval, dtype, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key, shape, minval, maxval, dtype=torch.int32):
    """``jax.random.randint`` for int32/int64 with a span below 2^31."""
    shape = tuple(shape)
    dev = key.device
    nbits = {torch.int32: 32, torch.int64: 64}[dtype]
    info = torch.iinfo(dtype)
    lo = device_scalar(minval, torch.int64, dev).clamp(info.min, info.max)
    hi = device_scalar(maxval, torch.int64, dev).clamp(info.min, info.max)
    ks = split(key)
    hb = bits(ks[..., 0, :], shape, nbits)
    lb = bits(ks[..., 1, :], shape, nbits)
    span = torch.where(hi <= lo, torch.ones_like(hi), hi - lo)
    if nbits == 32:
        span = span & M32
        mult = (65536 % span)
        mult = ((mult * mult) & M32) % span
        off = ((hb % span) * mult) & M32
        off = ((off + lb % span) & M32) % span
    else:
        if isinstance(maxval, int) and isinstance(minval, int) \
                and maxval - minval >= 2 ** 31:
            raise NotImplementedError("randint: int64 span >= 2^31")
        mult = (2 ** 32) % span
        mult = (mult * mult) % span

        def umod(u):
            # u64 pattern in int64 → (u mod span), span < 2^31
            h = (u >> 32) & M32
            l64 = u & M32
            return ((h % span) * ((2 ** 32) % span) + l64 % span) % span

        off = (umod(hb) * mult + umod(lb)) % span
    return (lo + off).to(dtype)


def normal(key, shape=(), dtype=torch.float32):
    """``jax.random.normal``: exact uniform draw, PyTorch's erfinv."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_t(-1.0), np_t(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.erfinv(u) * torch.full((), math.sqrt(2), dtype=dtype,
                                        device=key.device)


def weibull_min(key, scale, concentration, shape=(), dtype=torch.float64):
    """``jax.random.weibull_min``: the inverse CDF of a uniform draw,
    bit-exact: XLA-CPU's ``log1p`` and, for ``concentration != 1``, the
    C library's ``pow`` (``xlamath``)."""
    u = uniform(key, shape, dtype, 0.0, 1.0)
    x = -xlamath.log1p(-u)
    if concentration != 1.0:
        x = xlamath.pow(x, 1.0 / concentration)
    return x * scale


def gumbel(key, shape=(), dtype=torch.float64):
    """``jax.random.gumbel`` in its default "low" mode."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, dtype, tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits, shape=None):
    """``jax.random.categorical`` over the last axis of a 1-D ``logits``
    (with replacement): ``argmax(gumbel + logits)``, the first index on
    ties, as int64.  ``shape`` (JAX's ``shape=``) draws that many
    independent picks: one Gumbel draw of ``shape + logits.shape``."""
    shape = () if shape is None else tuple(shape)
    g = gumbel(key, shape + tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, -1)
