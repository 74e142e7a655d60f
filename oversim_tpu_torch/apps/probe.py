"""ConnectivityProbe: global connectivity metrics for the game overlays.

Counterpart of ``oversim_tpu/apps/probe.py`` (reference
src/applications/simplegameclient/ConnectivityProbeApp.{h,cc}): a global
function that reads the game overlay's topology and records, against the
AOI neighborhoods the true positions imply, the node count, the nodes
with no missing AOI neighbor, the mean and largest count of missing
neighbors, and the mean drift between where neighbors believe a node is
and where it is (cOV_AverageDrift).

Host-side numpy over the overlay's ``[N, ...]`` state, as the
reference's probe reads every client directly; the port's tensors come
in through ``.cpu().numpy()``.  Works for any overlay with positions
``pos`` [N, 2], neighbor slots ``nbr`` [N, D] and their believed
positions ``nbr_pos`` [N, D, 2] (Vast and Quon).
"""

from __future__ import annotations

import numpy as np
import torch

NO_NODE = -1


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def connectivity_probe(pos, alive, nbr, nbr_pos, aoi: float) -> dict:
    """The ConnectivityProbeApp metrics.

    ``pos`` [N, 2] true positions; ``alive`` [N] bool; ``nbr`` [N, D]
    neighbor slots (NO_NODE padded); ``nbr_pos`` [N, D, 2] the believed
    positions of those neighbors; ``aoi`` the AOI radius."""
    pos = _host(pos).astype(np.float64)
    alive = _host(alive).astype(bool)
    nbr = _host(nbr)
    nbr_pos = _host(nbr_pos).astype(np.float64)
    n = pos.shape[0]

    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    truth = (d <= aoi) & alive[:, None] & alive[None, :]
    np.fill_diagonal(truth, False)

    known = np.zeros_like(truth)
    rows = np.repeat(np.arange(n), nbr.shape[1])
    cols = nbr.reshape(-1)
    okm = (cols != NO_NODE) & alive[rows]
    known[rows[okm], np.clip(cols[okm], 0, n - 1)] = True

    missing = (truth & ~known).sum(axis=1)[alive]
    node_count = int(alive.sum())

    # drift: |believed position of a neighbor - its true position|, in
    # the reference's order (node by node, neighbor slot by slot)
    drift_num, drift_den = 0.0, 0
    for i in np.nonzero(alive)[0]:
        for j, slot in enumerate(nbr[i]):
            if slot != NO_NODE and alive[slot]:
                drift_num += float(np.linalg.norm(nbr_pos[i, j] - pos[slot]))
                drift_den += 1

    return {
        "node_count": node_count,
        "zero_missing": int((missing == 0).sum()) if node_count else 0,
        "avg_missing": float(missing.mean()) if node_count else 0.0,
        "max_missing": int(missing.max()) if node_count else 0,
        "avg_drift": drift_num / drift_den if drift_den else 0.0,
    }
