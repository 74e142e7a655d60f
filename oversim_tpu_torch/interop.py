"""Carry simulation state between the JAX package and the port.

A state is exchanged as a flat dict ``{leaf path: np.ndarray}`` whose
paths are ``jax.tree_util.keystr`` spellings of the JAX ``SimState``
leaves (``.pool.blk``, ``.logic.lk.target``, ``.stats['c:kbr_sent']``).
The port's dataclasses keep the JAX field names, so the paths match one
to one — the sparse tick's counters (``.counters['awake_nodes']``) and
every churn model's ``ChurnState`` included.  u32 leaves (the rng key,
the key lanes, and the DHT's stored, operation, commit and truth-map
keys) are ``np.uint32`` on the JAX side and zero-extended int64 in the
port; every other leaf keeps its dtype.  Pastry's tables, the route
slots (``.logic.rr``, whose ``.key`` is u32) and KBRTest's duplicate
ring (``.logic.app.seen_*``) need nothing more, nor do Koorde's de
Bruijn fields (``.logic.db_node``, ``.db_list``, ``.t_db``), Broose's
buckets and join counters (``.logic.rb``, ``.lb_seen``, ...),
EpiChord's lists and finger cache (``.logic.cache``, ``.cache_seen``,
``.slice_cursor``), the router topology's underlay (``.underlay.router``,
``.access``, ``.rr_delay``), GIA's neighbor sets, capacities and tokens
(``.logic.nbr_cap``, ``.tokens``, ``.s_seq``), Vast's and Quon's float32
positions (``.logic.pos``, ``.wp``, ``.nbr_pos``; they ride the wire
bitcast into key lanes, which the pool's block holds as int32), NICE's
and PubSubMMOG's glob parts (``.logic.rp``, a 0-d int32, and
``.logic.glob.resp``), the u32 keys of NTree's cells, Scribe's groups
and P2PNS's names (``.logic.app_glob.cell_keys``, ``.keys``,
``.name_keys``, or ``.logic.app_glob[i].keys`` inside a TierStack's
tuple) and the lookups' extension words
(``.logic.lk.ext``, int32 on both sides: a key lane at or above 2**31
is the same negative int32 there, read back as u32 by the overlay).
This module imports
neither JAX nor the JAX package: the caller flattens the JAX state
(``jax.tree_util.tree_flatten_with_path``).
"""

from __future__ import annotations

import numpy as np
import torch

from oversim_tpu_torch import tree

# leaf-name suffixes holding u32 values (key lanes and rng words; the
# DHT's storage, operation, staged-commit and trace keys, the truth
# map's key ring, NTree's cell and Scribe's group rendezvous keys, and
# P2PNS's name table, inside a TierStack's glob tuple too)
U32_SUFFIXES = (".rng", ".node_keys", ".target", ".key", ".s_key",
                ".op_key", ".commit_key", ".tr_key", ".app_glob.keys",
                ".cell_keys", ".name_keys", "].keys")


def is_u32(path: str) -> bool:
    return path.endswith(U32_SUFFIXES)


def state_to_numpy(state) -> dict:
    """Port state → ``{keystr path: np.ndarray}`` in the JAX dtypes."""
    out = {}
    for path, leaf in tree.leaves_with_path(state):
        a = leaf.detach().cpu().numpy()
        out[path] = a.astype(np.uint32) if is_u32(path) else a
    return out


def state_from_numpy(flat: dict, sim, device=None):
    """``{keystr path: np.ndarray}`` → the port's ``SimState`` for
    ``sim`` (its structure and dtypes come from ``sim.init``), on
    ``device`` (default: the simulation's own device)."""
    device = sim.device if device is None else device
    template = sim.init(0)
    missing = [p for p, _ in tree.leaves_with_path(template)
               if p not in flat]
    if missing:
        raise KeyError(f"state_from_numpy: missing leaves {missing[:5]}")

    def load(path, leaf):
        a = np.asarray(flat[path])
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{tuple(leaf.shape)}")
        if is_u32(path):
            a = a.astype(np.int64)
        return torch.as_tensor(np.array(a), device=device).to(leaf.dtype)

    return tree.map_with_path(load, template)
