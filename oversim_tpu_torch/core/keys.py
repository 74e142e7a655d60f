"""Fixed-width overlay keys on packed u32 lanes (PyTorch).

Counterpart of ``oversim_tpu/core/keys.py``: a key is ``KL`` u32 lanes,
most-significant lane first, so a batch of keys is ``[..., KL]``.  PyTorch
has no shifts, adds or ordered compares for ``uint32``, so every lane is
carried as int64 holding the zero-extended u32 value; xor, compares and
sorts on those int64 values give the u32 results.  The conversion to
``np.uint32`` happens only at the parity boundary (``interop.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from oversim_tpu_torch import rng as rng_mod

LANE_BITS = 32
MAX_KEY_BITS = 512
M32 = 0xFFFFFFFF
UMAX = M32


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """Static key-space description (keyLength)."""

    bits: int = 160

    def __post_init__(self):
        if not (0 < self.bits <= MAX_KEY_BITS):
            raise ValueError(f"keyLength must be in (0, {MAX_KEY_BITS}]")

    @property
    def lanes(self) -> int:
        return (self.bits + LANE_BITS - 1) // LANE_BITS

    @property
    def top_lane_bits(self) -> int:
        r = self.bits % LANE_BITS
        return LANE_BITS if r == 0 else r

    @property
    def top_lane_mask(self) -> int:
        return (1 << self.top_lane_bits) - 1


DEFAULT_SPEC = KeySpec(160)


def from_int(value: int, spec: KeySpec = DEFAULT_SPEC, device="cpu"):
    """Single [KL] key from a python int."""
    value &= (1 << spec.bits) - 1
    lanes = [(value >> (LANE_BITS * i)) & M32 for i in range(spec.lanes)]
    # one fill per lane: no host-to-device copy (which would synchronise)
    return torch.stack([torch.full((), v, dtype=torch.int64, device=device)
                        for v in lanes[::-1]])


def max_key(spec: KeySpec = DEFAULT_SPEC, device="cpu"):
    """The [KL] key 2**bits - 1 (OverlayKey::getMax)."""
    return from_int((1 << spec.bits) - 1, spec, device)


def sha1_key(data: bytes, spec: KeySpec = DEFAULT_SPEC) -> np.ndarray:
    """Host-side sha1 -> a [KL] ``np.uint32`` key (OverlayKey::sha1): the
    digest's top ``spec.bits`` bits.  Used at workload-build time (trace
    keys), never in a tick."""
    value = int.from_bytes(hashlib.sha1(data).digest(), "big")
    if spec.bits < 160:
        value >>= 160 - spec.bits
    value &= (1 << spec.bits) - 1
    return np.asarray([(value >> (LANE_BITS * i)) & M32
                       for i in range(spec.lanes)][::-1], np.uint32)


def mask_to_width(key, spec: KeySpec = DEFAULT_SPEC):
    """Clear the unused high bits of lane 0."""
    top = key[..., :1] & spec.top_lane_mask
    return torch.cat([top, key[..., 1:]], dim=-1) if spec.lanes > 1 else top


def random_keys(rng, batch_shape, spec: KeySpec = DEFAULT_SPEC):
    """Uniform random keys ``rng.shape[:-1] + batch_shape + (KL,)``."""
    b = rng_mod.bits(rng, tuple(batch_shape) + (spec.lanes,))
    return mask_to_width(b, spec)


def _lex(a, b):
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    gt = torch.zeros_like(lt)
    done = torch.zeros_like(lt)
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        lt = lt | (~done & (ai < bi))
        gt = gt | (~done & (ai > bi))
        done = done | (ai != bi)
    return lt, gt


def eq(a, b):
    return torch.all(a == b, dim=-1)


def lt(a, b):
    return _lex(a, b)[0]


def gt(a, b):
    return _lex(a, b)[1]


def le(a, b):
    """a <= b, compared on order-preserving folded words."""
    return ~lex_lt_eq(fold_lanes(b), fold_lanes(a))[0]


def add(a, b, spec: KeySpec = DEFAULT_SPEC):
    """(a + b) mod 2**bits with carry propagation."""
    out = []
    carry = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                        dtype=torch.int64, device=a.device)
    for i in range(spec.lanes - 1, -1, -1):
        s = a[..., i] + b[..., i] + carry
        out.append(s & M32)
        carry = s >> 32
    return mask_to_width(torch.stack(out[::-1], dim=-1), spec)


def lanes(key):
    """[..., KL] → the list of its KL lanes, most significant first.  The
    ``*_lanes`` and ``*_words`` functions below work on such lists, which
    lets a caller keep each lane of a large batch contiguous."""
    return list(key.unbind(-1))


def sub_lanes(a, b, spec: KeySpec = DEFAULT_SPEC):
    """(a - b) mod 2**bits on lists of lanes (any broadcastable shapes; a
    lane of ``a`` given as None reads 0) by one borrow chain.  The borrow
    is the lane difference's sign, ``s >> 63`` (0 or -1)."""
    out, borrow = [None] * spec.lanes, None
    for i in range(spec.lanes - 1, -1, -1):
        s = a[i] - b[i] if a[i] is not None else -b[i]
        if borrow is not None:
            s = s + borrow
        if i:
            borrow = s >> 63
        out[i] = s & M32
    out[0] = out[0] & spec.top_lane_mask
    return out


def neg(a, spec: KeySpec = DEFAULT_SPEC):
    """(-a) mod 2**bits."""
    return torch.stack(sub_lanes([None] * spec.lanes, lanes(a), spec), -1)


def sub(a, b, spec: KeySpec = DEFAULT_SPEC):
    """(a - b) mod 2**bits."""
    return torch.stack(sub_lanes(lanes(a), lanes(b), spec), -1)


def xor_metric(a, b):
    """XOR distance (Kademlia's metric; the DHT's default ``dist_fn``)."""
    return a ^ b


def ring_distance(a, b, spec: KeySpec = DEFAULT_SPEC):
    """Clockwise ring distance a→b: (b - a) mod 2**bits (Chord's metric)."""
    return sub(b, a, spec)


def bidir_lanes(a, b, spec: KeySpec = DEFAULT_SPEC):
    """``bidir_ring_distance`` on lists of lanes: d = b - a when
    d < 2**(bits-1), else a - b, its two's complement (which is where
    ``lt(d, -d)`` picks -d; at d = 2**(bits-1) both are equal)."""
    d = sub_lanes(b, a, spec)
    top = ((d[0] >> (spec.top_lane_bits - 1)) & 1) != 0
    nd = sub_lanes([None] * spec.lanes, d, spec)
    return [torch.where(top, x, y) for x, y in zip(nd, d)]


def bidir_ring_distance(a, b, spec: KeySpec = DEFAULT_SPEC):
    """min(b - a, a - b) on the ring (Pastry's keyDist)."""
    return torch.stack(bidir_lanes(lanes(a), lanes(b), spec), -1)


def bit(key, index, spec: KeySpec = DEFAULT_SPEC):
    """Bit ``index`` of the key (0 = the LSB); ``index`` an int tensor
    broadcastable to ``key.shape[:-1]``."""
    index = rng_mod.device_scalar(index, torch.int64, key.device)
    lane = spec.lanes - 1 - torch.div(index, LANE_BITS, rounding_mode="floor")
    shape = torch.broadcast_shapes(index.shape, key.shape[:-1])
    word = torch.gather(key.expand(shape + key.shape[-1:]), -1,
                        lane.expand(shape)[..., None])[..., 0]
    return (word >> (index % LANE_BITS)) & 1


def digit(key, index, b: int, spec: KeySpec = DEFAULT_SPEC):
    """The ``b``-bit digit ``index`` counted from the MSB (Pastry's prefix
    digits) as int32; bits past the key's width read 0.  Where no digit
    straddles a lane (``b`` divides 32 and the top lane's width) it is
    one shift of one lane; otherwise it is gathered bit by bit."""
    index = rng_mod.device_scalar(index, torch.int64, key.device)
    tlb = spec.top_lane_bits
    if not (LANE_BITS % b or tlb % b):
        o = index * b                            # offset from the MSB
        in_top = o < tlb
        rest = torch.clamp(o - tlb, min=0)
        lane = torch.where(in_top, 0, 1 + torch.div(
            rest, LANE_BITS, rounding_mode="floor"))
        shift = torch.where(in_top, tlb - o - b,
                            LANE_BITS - rest % LANE_BITS - b)
        shape = torch.broadcast_shapes(index.shape, key.shape[:-1])
        word = torch.gather(key.expand(shape + key.shape[-1:]), -1,
                            torch.clamp(lane, max=spec.lanes - 1)
                            .expand(shape)[..., None])[..., 0]
        d = (word >> torch.clamp(shift, min=0)) & ((1 << b) - 1)
        return torch.where(o < spec.bits, d, 0).to(torch.int32)
    out = None
    for j in range(b):
        pos = spec.bits - 1 - (index * b + j)
        bj = torch.where(pos >= 0, bit(key, torch.clamp(pos, min=0), spec), 0)
        out = bj if out is None else (out << 1) | bj
    return out.to(torch.int32)


def is_between(key, a, b, spec: KeySpec = DEFAULT_SPEC):
    """key ∈ (a, b) on the ring; (a, a) is the whole ring but a."""
    k_nonzero = ~eq(key, a)
    return torch.where(eq(a, b), k_nonzero,
                       lt(sub(key, a, spec), sub(b, a, spec)) & k_nonzero)


def is_between_r(key, a, b, spec: KeySpec = DEFAULT_SPEC):
    """key ∈ (a, b]."""
    return is_between(key, a, b, spec) | eq(key, b)


def is_between_l(key, a, b, spec: KeySpec = DEFAULT_SPEC):
    """key ∈ [a, b)."""
    return is_between(key, a, b, spec) | eq(key, a)


def is_between_lr(key, a, b, spec: KeySpec = DEFAULT_SPEC):
    """key ∈ [a, b]."""
    return is_between(key, a, b, spec) | eq(key, a) | eq(key, b)


def fold_lanes(key):
    """[..., KL] → [..., ceil(KL/2)] int64 words whose lexicographic
    (signed) order is the keys' unsigned order: each pair of u32 lanes
    becomes ``(hi - 2^31) << 32 | lo``; an odd last lane stays as it is."""
    return torch.stack(fold_words(lanes(key)), dim=-1)


def fold_words(key_lanes):
    """``fold_lanes`` on a list of lanes: the list of its words."""
    words = [((key_lanes[i] - (1 << 31)) << 32) | key_lanes[i + 1]
             for i in range(0, len(key_lanes) - 1, 2)]
    if len(key_lanes) % 2:
        words.append(key_lanes[-1])
    return words


def lex_lt_eq(a, b):
    """(a < b, a == b) over broadcastable folded words (``fold_lanes``)."""
    lt_ = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      dtype=torch.bool, device=a.device)
    eq_ = torch.ones_like(lt_)
    for i in range(a.shape[-1]):
        ai, bi = a[..., i], b[..., i]
        lt_ = lt_ | (eq_ & (ai < bi))
        eq_ = eq_ & (ai == bi)
    return lt_, eq_


def lt_words(a, b):
    """``lex_lt_eq``'s a < b alone, on lists of folded words."""
    lt_ = a[-1] < b[-1]
    for x, y in zip(a[-2::-1], b[-2::-1]):
        lt_ = (x < y) | ((x == y) & lt_)
    return lt_


def shl_const(key, c: int, spec: KeySpec = DEFAULT_SPEC):
    """Logical left shift by a static bit count (OverlayKey operator<<),
    cut to the key's width."""
    if c == 0:
        return mask_to_width(key, spec)
    kl = spec.lanes
    lane_sh, bit_sh = divmod(c, LANE_BITS)
    zero = torch.zeros_like(key[..., 0])
    out = []
    for i in range(kl):
        src = i + lane_sh
        lo = key[..., src] if src < kl else zero
        if bit_sh:
            nxt = key[..., src + 1] if src + 1 < kl else zero
            lo = ((lo << bit_sh) & M32) | (nxt >> (LANE_BITS - bit_sh))
        out.append(lo)
    return mask_to_width(torch.stack(out, -1), spec)


def shr_const(key, c: int, spec: KeySpec = DEFAULT_SPEC):
    """Logical right shift by a static bit count, counted from the key's
    width (the unused high bits of lane 0 stay zero)."""
    key = mask_to_width(key, spec)
    if c == 0:
        return key
    kl = spec.lanes
    lane_sh, bit_sh = divmod(c, LANE_BITS)
    zero = torch.zeros_like(key[..., 0])
    out = []
    for i in range(kl):
        src = i - lane_sh
        lo = key[..., src] if src >= 0 else zero
        if bit_sh:
            prv = key[..., src - 1] if src - 1 >= 0 else zero
            lo = (lo >> bit_sh) | ((prv << (LANE_BITS - bit_sh)) & M32)
        out.append(lo)
    return torch.stack(out, -1)


def _barrel(key, n, spec: KeySpec, left: bool):
    """Shift by a per-key count ``n`` (int tensor broadcastable to
    ``key.shape[:-1]``) as the JAX package's barrel of static shifts does
    it: stage p (a shift by 2**p, for 2**p < bits) applies when bit p of
    ``n`` is set, so a negative count shifts by its low bits, and a count
    of ``bits`` or more clears the key.  The stages compose into one
    shift by ``e = n & (2**P - 1)``, taken here at once: a gather of the
    source lanes from the zero-padded key and one funnel shift per
    lane."""
    n = rng_mod.device_scalar(n, torch.int64, key.device)
    stages = (spec.bits - 1).bit_length()
    e = n & ((1 << stages) - 1)
    kl = spec.lanes
    if not left:
        key = mask_to_width(key, spec)
    shape = torch.broadcast_shapes(key.shape[:-1], e.shape)
    key = key.expand(shape + (kl,))
    e = e.expand(shape)
    pad = ((1 << stages) - 1) // LANE_BITS + 2
    zeros = torch.zeros(shape + (pad,), dtype=key.dtype, device=key.device)
    lane_sh = torch.div(e, LANE_BITS, rounding_mode="floor")[..., None]
    bit_sh = (e % LANE_BITS)[..., None]
    col = torch.arange(kl, device=key.device)
    if left:
        padded = torch.cat([key, zeros], -1)
        hi = torch.gather(padded, -1, col + lane_sh)
        lo = torch.gather(padded, -1, col + lane_sh + 1)
        out = ((hi << bit_sh) & M32) | (lo >> (LANE_BITS - bit_sh))
        out = mask_to_width(out, spec)
    else:
        padded = torch.cat([zeros, key], -1)
        cur = torch.gather(padded, -1, col + pad - lane_sh)
        prv = torch.gather(padded, -1, col + pad - lane_sh - 1)
        out = (cur >> bit_sh) | ((prv << (LANE_BITS - bit_sh)) & M32)
    return torch.where((n >= spec.bits)[..., None] | (e >= spec.bits)[
        ..., None], 0, out)


def shl_dyn(key, n, spec: KeySpec = DEFAULT_SPEC):
    """Left shift by a per-key count (Koorde's findStartKey)."""
    return _barrel(key, n, spec, True)


def shr_dyn(key, n, spec: KeySpec = DEFAULT_SPEC):
    """Right shift by a per-key count (Koorde's findStartKey)."""
    return _barrel(key, n, spec, False)


def pow2_table(spec: KeySpec = DEFAULT_SPEC, device="cpu"):
    """[bits, KL] table of 2**i."""
    return torch.stack([from_int(1 << i, spec, device)
                        for i in range(spec.bits)])


def shared_prefix_length(a, b, spec: KeySpec = DEFAULT_SPEC):
    """Common MSB prefix length over the significant width (int32): the
    first differing lane and the bit length of its xor, which
    ``torch.frexp`` gives exactly for a u32 value held in float64."""
    x = a ^ b
    nz = x != 0
    first = torch.argmax(nz.to(torch.int32), -1, keepdim=True)
    bitlen = torch.gather(torch.frexp(x.to(torch.float64)).exponent, -1,
                          first)[..., 0].to(torch.int64)
    first = first[..., 0]
    tlb = spec.top_lane_bits
    total = torch.where(first == 0, tlb - bitlen,
                        tlb + LANE_BITS * first - bitlen)
    return torch.where(torch.any(nz, -1), total, spec.bits).to(torch.int32)


def log2_floor(key, spec: KeySpec = DEFAULT_SPEC):
    """floor(log2(key)) as int32; -1 for the zero key."""
    return (spec.bits - 1 - shared_prefix_length(
        key, torch.zeros_like(key), spec)).to(torch.int32)


def shared_prefix_digits(a, b, bpd: int, spec: KeySpec = DEFAULT_SPEC):
    """Common leading ``bpd``-bit digits (int32)."""
    return torch.div(shared_prefix_length(a, b, spec), bpd,
                     rounding_mode="floor")


def dup_mask(vec):
    """[..., C] → [..., C] bool marking later duplicates (keep first)."""
    c = vec.shape[-1]
    eq = vec.unsqueeze(-2) == vec.unsqueeze(-1)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=vec.device), diagonal=-1)
    return torch.any(eq & tril, dim=-1)


def sort_by_distance(dist, payload, num_keys: int | None = None, *,
                     approx: bool = False):
    """Stable lexicographic sort of ``payload`` ([..., C] tensors) by the
    multi-lane distance ``dist`` [..., C, KL] along the C axis
    (``lax.sort`` with ``num_keys`` lanes, stable).

    Two u32 lanes fold into one order-preserving int64 key
    (``(hi - 2^31) << 32 | lo``), so the exact comparator takes
    ``ceil(nk / 2)`` stable passes, least-significant pair first, and
    ``approx=True`` (top two lanes only) takes one."""
    kl = dist.shape[-1]
    if num_keys is None and approx:
        nk = min(2, kl)
        lanes = [dist[..., i] for i in range(nk)]
    else:
        nk = kl if num_keys is None else num_keys
        lanes = [dist[..., i] for i in range(kl)]
    keys = []
    for i in range(0, nk, 2):
        if i + 1 < nk:
            keys.append(((lanes[i] - (1 << 31)) << 32) | lanes[i + 1])
        else:
            keys.append(lanes[i])
    order = None
    for k in reversed(keys):
        kk = k if order is None else torch.gather(k, -1, order)
        o = torch.sort(kk, dim=-1, stable=True).indices
        order = o if order is None else torch.gather(order, -1, o)
    sorted_lanes = [torch.gather(x, -1, order) for x in lanes]
    sorted_dist = torch.stack(sorted_lanes, dim=-1)
    return sorted_dist, tuple(torch.gather(p, -1, order) for p in payload)
