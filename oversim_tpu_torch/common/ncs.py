"""Network coordinates: Vivaldi / SVivaldi (PyTorch).

Counterpart of ``oversim_tpu/common/ncs.py`` (reference Vivaldi.cc:56-100
and SVivaldi.cc): every node holds a point in a ``dims``-dimensional
delay space, a height, a local error estimate and (SVivaldi) a loss
factor; each RTT sample pulls the node towards or away from the peer
whose coordinates rode on the response (``pack_wire`` / ``unpack_wire``:
the float32 words bitcast into the u32 key lanes, which the port holds
zero-extended in int64).  ``update`` runs over the whole node axis.

Float work stays float32 in the JAX package's order: each operation
rounds once, as XLA's does on the CPU with FMA contraction off; the
distance's root is taken in float64 and rounded once, which is the
correctly rounded float32 root (PyTorch's CPU float32 ``sqrt`` is not).
The GNP / NPS landmark coordinates (``is_landmark_type``) are still to
be ported (ROADMAP Queue A) and raise.
"""

from __future__ import annotations

import dataclasses

import torch

from oversim_tpu_torch import rng as rng_mod

F32 = torch.float32
I32 = torch.int32
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NcsParams:
    """Vivaldi.ned / SVivaldi.ned / Nps.ned defaults (JAX field names)."""

    ncs_type: str = "vivaldi"
    dims: int = 2
    coord_c: float = 0.25
    error_c: float = 0.5
    enable_height: bool = False
    loss_c: float = 0.5
    num_landmarks: int = 8
    ref_points: int = 4
    gd_iters: int = 12
    probe_interval: float = 10.0

    @property
    def is_landmark_type(self) -> bool:
        return self.ncs_type in ("gnp", "nps")


@dataclasses.dataclass
class NcsState:
    coords: torch.Tensor     # [N, D] f32
    height: torch.Tensor     # [N] f32
    error: torch.Tensor      # [N] f32
    loss: torch.Tensor       # [N] f32
    layer: torch.Tensor      # [N] i32
    ref_rtt: torch.Tensor    # [N, K] f32 (K = 0 for non-landmark types)
    ref_xy: torch.Tensor     # [N, K, D] f32
    ref_layer: torch.Tensor  # [N, K] i32
    ref_n: torch.Tensor      # [N] i32


def init(rng, n: int, p: NcsParams) -> NcsState:
    """Coords uniform in [-0.2, 0.2] (Vivaldi.cc:46-49)."""
    if p.is_landmark_type:
        raise NotImplementedError(
            "GNP/NPS landmark coordinates are not ported yet (ROADMAP "
            "Queue A)")
    dev = rng.device
    return NcsState(
        coords=rng_mod.uniform(rng, (n, p.dims), F32, -0.2, 0.2),
        height=torch.zeros((n,), dtype=F32, device=dev),
        error=torch.ones((n,), dtype=F32, device=dev),
        loss=torch.zeros((n,), dtype=F32, device=dev),
        layer=torch.full((n,), -1, dtype=I32, device=dev),
        ref_rtt=torch.full((n, 0), -1.0, dtype=F32, device=dev),
        ref_xy=torch.zeros((n, 0, p.dims), dtype=F32, device=dev),
        ref_layer=torch.full((n, 0), -1, dtype=I32, device=dev),
        ref_n=torch.zeros((n,), dtype=I32, device=dev))


def distance(xi, hi, xj, hj):
    """Predicted RTT between two points plus their heights: the squares
    summed left to right in float32, the root correctly rounded."""
    d = xi - xj
    sq = d * d
    acc = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        acc = acc + sq[..., k]
    return torch.sqrt(acc.to(torch.float64)).to(F32) + hi + hj


def update(me: dict, rtt_s, xj, ej, hj, p: NcsParams) -> dict:
    """One Vivaldi sample per node: ``me`` is dict(coords [N, D], height,
    error, loss [N]); ``rtt_s`` [N] (no-op where <= 0), the peer's
    ``xj`` [N, D], ``ej`` [N] and height ``hj``.  Returns the new dict."""
    ok = rtt_s > 0.0
    rtt = torch.clamp(rtt_s, min=1e-9)
    xi, hi, ei = me["coords"], me["height"], me["error"]
    wsum = ei + ej
    w = torch.where(wsum > 0, ei / torch.clamp(wsum, min=1e-12), 0.0)
    dist = distance(xi, hi, xj, hj)
    rel_err = torch.abs(dist - rtt) / rtt
    new_err = rel_err * p.error_c * w + ei * (1.0 - p.error_c * w)
    delta = p.coord_c * w
    if p.ncs_type == "svivaldi":
        new_loss = me["loss"] * (1 - p.loss_c) + \
            (1.0 - torch.clamp(rel_err, max=1.0)) * p.loss_c
        delta = delta * (1.0 - new_loss)
    else:
        new_loss = me["loss"]
    dd = dist[..., None]
    unit = torch.where(dd > 0, (xi - xj) / torch.clamp(dd, min=1e-12), 0.0)
    new_coords = xi + (delta * (rtt - dist))[..., None] * unit
    new_height = hi + (delta * (rtt - dist) if p.enable_height else 0.0)
    moved = ok & (dist > 0)
    return dict(
        coords=torch.where(moved[..., None], new_coords, xi),
        height=torch.where(moved, new_height, hi),
        error=torch.clamp(torch.where(ok, new_err, ei), 0.0, 10.0),
        loss=torch.where(ok, new_loss, me["loss"]))


def pack_wire(coords, error, lanes: int):
    """(coords [..., D], error [...]) → [..., lanes] key field: the
    float32 bit patterns as u32 values in int64, zero lanes after."""
    d = coords.shape[-1]
    if lanes < d + 1:
        raise ValueError("key lanes too narrow for NCS piggyback")
    payload = torch.cat([coords.to(F32), error.to(F32)[..., None]], -1)
    words = payload.contiguous().view(I32).to(torch.int64) & M32
    pad = torch.zeros(words.shape[:-1] + (lanes - d - 1,),
                      dtype=torch.int64, device=words.device)
    return torch.cat([words, pad], -1)


def unpack_wire(key, dims: int):
    """Inverse of ``pack_wire``: (coords [..., D], error [...])."""
    payload = (key[..., :dims + 1] & M32).to(I32).contiguous().view(F32)
    return payload[..., :dims], payload[..., dims]
