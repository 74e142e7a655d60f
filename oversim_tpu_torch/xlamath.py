"""XLA-CPU's float64 ``log1p``, ``pow`` and sums, and its float32 ``sin``
and ``cos``, bit for bit, in plain PyTorch ops.

The JAX package draws its churn lifetimes with ``jax.random.weibull_min``,
whose inverse CDF is ``-log1p(-u)`` in float64.  XLA's CPU backend
lowers ``log1p`` to its own expression (``xla.log1p.f64``):

* ``|x| < sqrt(2) - 1``: Cephes's rational ``x - x^2/2 + x^3 P(x)/Q(x)``,
  Horner from the leading coefficient, every product and sum rounded
  on its own;
* otherwise ``log(1 + x)`` through the C library's ``log``, which on an
  x86-64 host with FMA is glibc's ``__log_fma`` (the ARM
  optimized-routines algorithm: a 128-entry ``(1/c, log c)`` table and
  a degree-5 polynomial, compiled with fused multiply-adds).

``torch.log1p`` and ``torch.log`` round differently on a few inputs in a
thousand, which moves a churn schedule by a nanosecond now and then.
This module evaluates the same expression with IEEE additions and
multiplications only — each fused multiply-add emulated exactly — so it
gives XLA-CPU's bits on any device PyTorch runs on, the card included.

The same holds for two more operations the churn models need:

* ``pow``: XLA-CPU calls the C library's ``pow`` for float64, glibc's
  ``__pow_fma`` (a 128-entry log table with a tail word, a degree-7
  log polynomial, ``exp`` through a 128-entry ``2^(k/128)`` table and a
  degree-5 polynomial, compiled with fused multiply-adds).  PyTorch's
  ``torch.pow`` differs from it on 1-23% of the Pareto draws' inputs;
  ``pow`` here replays the C routine's operation order.  Its tables are
  computed once from their defining formulas (``decimal``, 60 digits).
* ``xla_sum``: XLA-CPU sums a float64 vector of more than 32 elements
  as a tree: the vector is zero-padded (half the padding in front) to a
  multiple of 32, each window of 32 summed left to right, and the
  window sums reduced the same way; 32 or fewer are summed left to right.
* ``sinf``/``cosf``: XLA-CPU calls the C library's float32 routines,
  glibc's ``__sinf_fma``/``__cosf_fma`` (the movement generators' hotspot
  angles); PyTorch's differ on about 5% of them.
"""

from __future__ import annotations

from decimal import Decimal, localcontext

import torch

F64 = torch.float64
I64 = torch.int64

# -- the small-|x| branch: XLA's Cephes coefficients ------------------------

_SMALL = 0.41421356237309504880  # sqrt(2) - 1
_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
        6.5787325942061044846969e0, 2.9911919328553073277375e1,
        6.0949667980987787057556e1, 5.7112963590585538103336e1,
        2.0039553499201281259648e1)
_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
        2.2176239823732856465394e2, 3.0909872225312059774938e2,
        2.1642788614495947685003e2, 6.0118660497603843919306e1)

# -- glibc's log (e_log_data.c, LOG_TABLE_BITS = 7) --------------------------

_LN2HI = float.fromhex("0x1.62e42fefa3800p-1")
_LN2LO = float.fromhex("0x1.ef35793c76730p-45")
_A = tuple(float.fromhex(h) for h in (
    "-0x1.0000000000001p-1", "0x1.555555551305bp-2", "-0x1.fffffffeb459p-3",
    "0x1.999b324f10111p-3", "-0x1.55575e506c89fp-3"))
_OFF = 0x3FE6000000000000
# (invc, logc) for each of the 128 subintervals, as IEEE bit patterns
_TAB = """
    3ff734f0c3e0de9f bfd7cc7f79e69000 3ff713786a2ce91f bfd76feec20d0000
    3ff6f26008fab5a0 bfd713e31351e000 3ff6d1a61f138c7d bfd6b85b38287800
    3ff6b1490bc5b4d1 bfd65d5590807800 3ff69147332f0cba bfd602d076180000
    3ff6719f18224223 bfd5a8ca86909000 3ff6524f99a51ed9 bfd54f4356035000
    3ff63356aa8f24c4 bfd4f637c36b4000 3ff614b36b9ddc14 bfd49da7fda85000
    3ff5f66452c65c4c bfd445923989a800 3ff5d867b5912c4f bfd3edf439b0b800
    3ff5babccb5b90de bfd396ce448f7000 3ff59d61f2d91a78 bfd3401e17bda000
    3ff5805612465687 bfd2e9e2ef468000 3ff56397cee76bd3 bfd2941b3830e000
    3ff54725e2a77f93 bfd23ec58cda8800 3ff52aff42064583 bfd1e9e129279000
    3ff50f22dbb2bddf bfd1956d2b48f800 3ff4f38f4734ded7 bfd141679ab9f800
    3ff4d843cfde2840 bfd0edd094ef9800 3ff4bd3ec078a3c8 bfd09aa518db1000
    3ff4a27fc3e0258a bfd047e65263b800 3ff4880524d48434 bfcfeb224586f000
    3ff46dce1b192d0b bfcf474a7517b000 3ff453d9d3391854 bfcea4443d103000
    3ff43a2744b4845a bfce020d44e9b000 3ff420b54115f8fb bfcd60a22977f000
    3ff40782da3ef4b1 bfccc00104959000 3ff3ee8f5d57fe8f bfcc202956891000
    3ff3d5d9a00b4ce9 bfcb81178d811000 3ff3bd60c010c12b bfcae2c9ccd3d000
    3ff3a5242b75dab8 bfca45402e129000 3ff38d22cd9fd002 bfc9a877681df000
    3ff3755bc5847a1c bfc90c6d69483000 3ff35dce49ad36e2 bfc87120a645c000
    3ff34679984dd440 bfc7d68fb4143000 3ff32f5cceffcb24 bfc73cb83c627000
    3ff3187775a10d49 bfc6a39a9b376000 3ff301c8373e3990 bfc60b3154b7a000
    3ff2eb4ebb95f841 bfc5737d76243000 3ff2d50a0219a9d1 bfc4dc7b8fc23000
    3ff2bef9a8b7fd2a bfc4462c51d20000 3ff2a91c7a0c1bab bfc3b08abc830000
    3ff293726014b530 bfc31b996b490000 3ff27dfa5757a1f5 bfc2875490a44000
    3ff268b39b1d3bbf bfc1f3b9f879a000 3ff2539d838ff5bd bfc160c8252ca000
    3ff23eb7aac9083b bfc0ce7f57f72000 3ff22a012ba940b6 bfc03cdc49fea000
    3ff2157996cc4132 bfbf57bdbc4b8000 3ff201201dd2fc9b bfbe370896404000
    3ff1ecf4494d480b bfbd17983ef94000 3ff1d8f5528f6569 bfbbf9674ed8a000
    3ff1c52311577e7c bfbadc79202f6000 3ff1b17c74cb26e9 bfb9c0c3e7288000
    3ff19e010c2c1ab6 bfb8a646b372c000 3ff18ab07bb670bd bfb78d01b3ac0000
    3ff1778a25efbcb6 bfb674f145380000 3ff1648d354c31da bfb55e0e6d878000
    3ff151b990275fdd bfb4485cdea1e000 3ff13f0ea432d24c bfb333d94d6aa000
    3ff12c8b7210f9da bfb22079f8c56000 3ff11a3028ecb531 bfb10e4698622000
    3ff107fbda8434af bfaffa6c6ad20000 3ff0f5ee0f4e6bb3 bfadda8d4a774000
    3ff0e4065d2a9fce bfabbcece4850000 3ff0d244632ca521 bfa9a1894012c000
    3ff0c0a77ce2981a bfa788583302c000 3ff0af2f83c636d1 bfa5715e67d68000
    3ff09ddb98a01339 bfa35c8a49658000 3ff08cabaf52e7df bfa149e364154000
    3ff07b9f2f4e28fb bf9e72c082eb8000 3ff06ab58c358f19 bf9a55f152528000
    3ff059eea5ecf92c bf963d62cf818000 3ff04949cdd12c90 bf9228fb8caa0000
    3ff038c6c6f0ada9 bf8c317b20f90000 3ff02865137932a9 bf8419355daa0000
    3ff0182427ea7348 bf781203c2ec0000 3ff008040614b195 bf60040979240000
    3fefe01ff726fa1a 3f6feff384900000 3fefa11cc261ea74 3f87dc41353d0000
    3fef6310b081992e 3f93cea3c4c28000 3fef25f63ceeadcd 3f9b9fc114890000
    3feee9c8039113e7 3fa1b0d8ce110000 3feeae8078cbb1ab 3fa58a5bd001c000
    3fee741aa29d0c9b 3fa95c8340d88000 3fee3a91830a99b5 3fad276aef578000
    3fee01e009609a56 3fb07598e598c000 3fedca01e577bb98 3fb253f5e30d2000
    3fed92f20b7c9103 3fb42edd8b380000 3fed5cac66fb5cce 3fb606598757c000
    3fed272caa5ede9d 3fb7da76356a0000 3fecf26e3e6b2ccd 3fb9ab434e1c6000
    3fecbe6da2a77902 3fbb78c7bb0d6000 3fec8b266d37086d 3fbd431332e72000
    3fec5894bd5d5804 3fbf0a3171de6000 3fec26b533bb9f8c 3fc067152b914000
    3febf583eeece73f 3fc147858292b000 3febc4fd75db96c1 3fc2266ecdca3000
    3feb951e0c864a28 3fc303d7a6c55000 3feb65e2c5ef3e2c 3fc3dfc33c331000
    3feb374867c9888b 3fc4ba366b7a8000 3feb094b211d304a 3fc5933928d1f000
    3feadbe885f2ef7e 3fc66acd2418f000 3feaaf1d31603da2 3fc740f8ec669000
    3fea82e63fd358a7 3fc815c0f51af000 3fea5740ef09738b 3fc8e92954f68000
    3fea2c2a90ab4b27 3fc9bb3602f84000 3fea01a01393f2d1 3fca8bed1c2c0000
    3fe9d79f24db3c1b 3fcb5b515c01d000 3fe9ae2505c7b190 3fcc2967ccbcc000
    3fe9852ef297ce2f 3fccf635d5486000 3fe95cbaeea44b75 3fcdc1bd3446c000
    3fe934c69de74838 3fce8c01b8cfe000 3fe90d4f2f6752e6 3fcf5509c0179000
    3fe8e6528effd79d 3fd00e6c121fb800 3fe8bfce9fcc007c 3fd071b80e93d000
    3fe899c0dabec30e 3fd0d46b9e867000 3fe87427aa2317fb 3fd13687334bd000
    3fe84f00acb39a08 3fd1980d67234800 3fe82a49e8653e55 3fd1f8ffe0cc8000
    3fe8060195f40260 3fd2595fd7636800 3fe7e22563e0a329 3fd2b9300914a800
    3fe7beb377dcb5ad 3fd3187210436000 3fe79baa679725c2 3fd377266dec1800
    3fe77907f2170657 3fd3d54ffbaf3000 3fe756cadbd6130c 3fd432eee32fe000
"""
_TAB_BITS = [int(h, 16) for h in _TAB.split()]
_TAB_CACHE = {}


def _table(device):
    """[128] invc and logc tensors on ``device`` (made once per device)."""
    if device not in _TAB_CACHE:
        bits = torch.tensor([b - (1 << 64) if b >> 63 else b
                             for b in _TAB_BITS], dtype=I64, device=device)
        tab = bits.view(F64).reshape(128, 2)
        _TAB_CACHE[device] = (tab[:, 0].contiguous(), tab[:, 1].contiguous())
    return _TAB_CACHE[device]


def _split(a):
    """Veltkamp split: ``a == hi + lo`` with 26-bit halves."""
    t = a * 134217729.0
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """``a * b == p + e`` exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _two_sum(a, b):
    """``a + b == s + e`` exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a, b, c):
    """``a * b + c`` rounded once, from rounded operations only (Boldo
    and Melquiond's emulation through rounding to odd); exact whenever
    no partial product underflows.  One of ``a``, ``b`` is a float64
    tensor; the others may be python floats."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(I64) & 1) == 0
    toward = torch.copysign(torch.full_like(v, float("inf")), err)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def _glibc_log(x):
    """glibc's ``__log_fma`` for positive normal ``x`` outside the
    near-one window [0x1.ep-1, 0x1.09p+0), which ``log1p`` never takes
    from this branch."""
    invc_t, logc_t = _table(x.device)
    ix = x.view(I64)
    tmp = ix - _OFF
    i = (tmp >> 45) & 127
    k = tmp >> 52
    z = (ix - (tmp & -(1 << 52))).view(F64)
    invc, logc = invc_t[i], logc_t[i]
    kd = k.to(F64)
    # r = fma(z, invc, -1): the product lies in [0.5, 2], so ``p - 1``
    # is exact and one rounded add of the product's tail finishes it
    p, e = _two_prod(z, invc)
    r = (p - 1.0) + e
    w = kd * _LN2HI + logc        # fma: kd * ln2hi is exact
    hi = w + r
    lo = fma(kd, _LN2LO, (w - hi) + r)
    r2 = r * r
    p1 = fma(r, _A[2], _A[1])
    p2 = fma(r, _A[4], _A[3])
    lo = fma(r2, _A[0], lo)
    y = fma(r * r2, fma(p2, r2, p1), lo)
    return y + hi


def log1p(x):
    """XLA-CPU's float64 ``log1p`` for finite ``x > -1`` (XLA-CPU flushes
    a subnormal ``x`` to zero first; this keeps it)."""
    x = x.to(F64)
    x2 = x * x
    num = torch.zeros_like(x)
    for c in _NUM:
        num = num * x + c
    den = torch.zeros_like(x)
    for c in _DEN:
        den = den * x + c
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    large = _glibc_log(x + 1.0)
    return torch.where(torch.abs(x) < _SMALL, small, large)


def xla_sum(x):
    """XLA-CPU's float64 sum of a vector (the module docstring's tree)."""
    x = x.to(F64)
    n = x.shape[0]
    if n <= 32:
        acc = torch.zeros((), dtype=F64, device=x.device)
        for k in range(n):
            acc = acc + x[k]
        return acc
    k = -(-n // 32)
    pad = 32 * k - n
    xp = torch.cat([x.new_zeros(pad // 2), x, x.new_zeros(pad - pad // 2)])
    xp = xp.reshape(k, 32)
    acc = xp[:, 0] * 0.0
    for j in range(32):
        acc = acc + xp[:, j]
    return xla_sum(acc)


# -- glibc's pow (e_pow.c, e_exp_data.c, e_pow_log_data.c) --------------------

_POW_OFF = 0x3FE6955500000000
# 256 / c for each of the 128 log subintervals (1/c has few bits, so
# z/c - 1 is exact)
_POW_J = (
    362, 360, 358, 356, 354, 352, 350, 348, 346, 344, 342, 342, 340, 338,
    336, 334, 332, 330, 330, 328, 326, 324, 322, 320, 320, 318, 316, 314,
    314, 312, 310, 308, 308, 306, 304, 304, 302, 300, 300, 298, 296, 294,
    294, 292, 292, 290, 288, 288, 286, 284, 284, 282, 282, 280, 278, 278,
    276, 276, 274, 272, 272, 270, 270, 268, 268, 266, 266, 264, 264, 262,
    260, 260, 258, 258, 256, 256, 254, 252, 250, 248, 246, 244, 242, 241,
    239, 237, 235, 234, 232, 230, 229, 227, 226, 224, 223, 221, 220, 218,
    217, 215, 214, 213, 211, 210, 208, 207, 206, 205, 203, 202, 201, 200,
    198, 197, 196, 195, 194, 193, 191, 190, 189, 188, 187, 186, 185, 184,
    183, 182)
_PLN2HI = float.fromhex("0x1.62e42fefa3800p-1")
_PLN2LO = float.fromhex("0x1.ef35793c76730p-45")
_PA = tuple(float.fromhex(h) for h in (
    "-0x1.0000000000000p-1", "-0x1.5555555555560p-1",
    "0x1.0000000000006p-1", "0x1.999999959554ep-1",
    "-0x1.555555529a47ap-1", "-0x1.2495b9b4845e9p+0",
    "0x1.0002b8b263fc3p+0"))
_INVLN2N = float.fromhex("0x1.71547652b82fep+7")
_NEGLN2HIN = float.fromhex("-0x1.62e42fefa0000p-8")
_NEGLN2LON = float.fromhex("-0x1.cf79abc9e3b3ap-47")
_EC = tuple(float.fromhex(h) for h in (
    "0x1.ffffffffffdbdp-2", "0x1.555555555543cp-3",
    "0x1.55555cf172b91p-5", "0x1.1111167a4d017p-7"))
_SHIFT = float.fromhex("0x1.8p52")
_POW_CACHE = {}


def _pow_tables():
    """Host lists: (invc, logc, logctail) of the log table, where
    logc = round(2^43 log c) / 2^43 and logctail = log c - logc; and
    (H bits, T) of the exp table, H = 2^(k/128) rounded and
    T = (2^(k/128) - H) / H rounded."""
    import struct
    with localcontext() as ctx:
        ctx.prec = 60
        invc, logc, tail = [], [], []
        for j in _POW_J:
            lc = -(Decimal(j) / 256).ln()
            lh = Decimal(round(lc * 2 ** 43)) / 2 ** 43
            invc.append(j / 256)
            logc.append(float(lh))
            tail.append(float(lc - lh))
        hbits, t = [], []
        for k in range(128):
            h = Decimal(2) ** (Decimal(k) / 128)
            hf = float(h)
            hbits.append(struct.unpack("<q", struct.pack("<d", hf))[0])
            t.append(float((h - Decimal(hf)) / Decimal(hf)))
    return invc, logc, tail, hbits, t


def _pow_device_tables(device):
    if device not in _POW_CACHE:
        if "host" not in _POW_CACHE:
            _POW_CACHE["host"] = _pow_tables()
        invc, logc, tail, hbits, t = _POW_CACHE["host"]
        _POW_CACHE[device] = (
            torch.tensor(invc, dtype=F64, device=device),
            torch.tensor(logc, dtype=F64, device=device),
            torch.tensor(tail, dtype=F64, device=device),
            torch.tensor(hbits, dtype=I64, device=device),
            torch.tensor(t, dtype=F64, device=device))
    return _POW_CACHE[device]


def pow(x, y: float):
    """glibc's ``pow(x, y)`` for a float64 tensor ``x`` of non-negative
    values (0 gives +inf for ``y < 0`` and 0 for ``y > 0``; subnormals
    are not taken) and a nonzero python float ``y`` with
    ``|y log x| < 512``: the operation order of ``__pow_fma``, each fused
    multiply-add emulated exactly."""
    x = x.to(F64)
    invc_t, logc_t, tail_t, hbits_t, t_t = _pow_device_tables(x.device)
    # log_inline: x = 2^k z, log x = k ln2 + log c + log1p(z/c - 1)
    ix = x.view(I64)
    tmp = ix - _POW_OFF
    i = (tmp >> 45) & 127
    kd = (tmp >> 52).to(F64)
    z = (ix - (tmp & -(1 << 52))).view(F64)
    invc, logc, logctail = invc_t[i], logc_t[i], tail_t[i]
    p, e = _two_prod(z, invc)
    r = (p - 1.0) + e                       # fma(z, invc, -1), exact
    t1 = kd * _PLN2HI + logc                # kd * ln2hi is exact
    lo1 = fma(kd, _PLN2LO, logctail)
    ar = r * _PA[0]
    fa21 = fma(r, _PA[2], _PA[1])
    fa43 = fma(r, _PA[4], _PA[3])
    t2 = r + t1
    ar2 = r * ar
    ar3 = r * ar2
    lo3 = fma(ar, r, -ar2)
    lo2 = (t1 - t2) + r
    fa65 = fma(r, _PA[6], _PA[5])
    hi = t2 + ar2
    lo4 = (t2 - hi) + ar2
    s = fma(ar2, fma(fa65, ar2, fa43), fa21)
    lo = fma(ar3, s, ((lo1 + lo2) + lo3) + lo4)
    lg = hi + lo
    lg_tail = (hi - lg) + lo
    # y * log x as ehi + elo
    ehi = lg * y
    elo = fma(lg_tail, y, _two_prod(lg, y)[1])
    # exp_inline(ehi, elo)
    kd2 = fma(ehi, _INVLN2N, _SHIFT)
    kd2 = kd2 - _SHIFT
    kk = kd2.to(I64)
    rr = fma(kd2, _NEGLN2HIN, ehi)
    rr = fma(kd2, _NEGLN2LON, rr)
    rr = elo + rr
    idx = kk & 127
    sbits = hbits_t[idx] + ((kk >> 7) << 52)
    tr = rr + t_t[idx]
    r2 = rr * rr
    tmp2 = fma(fma(rr, _EC[1], _EC[0]), r2, tr)
    tmp2 = fma(fma(rr, _EC[3], _EC[2]), r2 * r2, tmp2)
    scale = sbits.view(F64)
    res = fma(tmp2, scale, scale)
    abstop = (ehi.view(I64) >> 52) & 0x7FF
    res = torch.where(abstop < 0x3C9, 1.0 + ehi, res)
    return torch.where(x == 0, float("inf") if y < 0 else 0.0, res)


# -- glibc's sinf / cosf (s_sinf.c, s_cosf.c, sincosf.h) ---------------------
#
# XLA-CPU calls the C library for float32 ``sin`` and ``cos``: glibc's
# ``__sinf_fma`` / ``__cosf_fma`` (the ARM optimized-routines algorithm:
# the argument in float64, one multiply-subtract reduction by pi/2 below
# 120, and a short even or odd polynomial compiled with fused
# multiply-adds).  The coefficients are ``__sincosf_table``'s; the second
# row (quadrants 2 and 3) negates the cosine's.

_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")    # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_SC_S = (float.fromhex("-0x1.555545995a603p-3"),
         float.fromhex("0x1.1107605230bc4p-7"),
         float.fromhex("-0x1.994eb3774cf24p-13"))
_SC_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
         float.fromhex("0x1.55553e1068f19p-5"),
         float.fromhex("-0x1.6c087e89a359dp-10"),
         float.fromhex("0x1.99343027bf8c3p-16"))


def _sincosf_poly(x, x2, odd, neg):
    """``sinf_poly``: the sine polynomial where ``odd`` is false, else
    the cosine's, its coefficients negated where ``neg``."""
    s1, s2, s3 = _SC_S
    x3 = x * x2
    sp = fma(x3 * x2, fma(x2, s3, s2), fma(x3, s1, x))
    sg = torch.where(neg, -1.0, 1.0).to(F64)
    c0, c1, c2, c3, c4 = (sg * c for c in _SC_C)
    x4 = x2 * x2
    cp = fma(x4 * x2, fma(x2, c4, c3), fma(x4, c2, fma(x2, c1, c0)))
    return torch.where(odd, cp, sp)


def _sincosf(y, cos: bool):
    """Both routines below 120 (the movement generators' angles lie in
    [0, 2 pi)); larger arguments take glibc's 192-bit reduction, which
    is not ported."""
    x = y.to(F64)
    ay = y.abs().view(torch.int32) >> 20      # abstop12
    small = ay < 0x3F4                          # |y| below pi/4's top bits
    tiny = ay < 0x395                           # |y| < 2^-12
    r = x * _HPI_INV
    n = torch.bitwise_right_shift(r.to(torch.int32) + 0x800000, 24)
    xr = fma(-n.to(F64), _HPI, x)
    sign = torch.where((n & 3 == 1) | (n & 3 == 2), -1.0, 1.0).to(F64)
    quad = (n & 1) == 1
    big = _sincosf_poly(xr * sign, xr * xr, quad ^ cos, (n & 2) == 2)
    x2 = x * x
    near = _sincosf_poly(x, x2, torch.full_like(small, cos),
                         torch.zeros_like(small))
    out = torch.where(small, near, big).to(torch.float32)
    tiny_v = torch.ones_like(y) if cos else y
    return torch.where(tiny, tiny_v, out)


def sinf(y):
    """glibc's float32 ``sinf`` (XLA-CPU's ``sin``) for ``|y| < 120``."""
    return _sincosf(y, False)


def cosf(y):
    """glibc's float32 ``cosf`` (XLA-CPU's ``cos``) for ``|y| < 120``."""
    return _sincosf(y, True)
