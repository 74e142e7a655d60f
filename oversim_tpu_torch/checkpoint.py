"""Checkpoint / resume: snapshot the full simulation state (PyTorch).

Counterpart of ``oversim_tpu/checkpoint.py``.  A state is a tree of
tensors, so a checkpoint is a flat array dump and resume is exact: a
restored run continues bit-identically (same rng key, pool contents and
timers).

Format ``oversim-tpu-torch-ckpt-v1`` (the port's own; the JAX package's
``oversim-tpu-ckpt-v*`` files are refused): one ``.npz`` whose arrays
are keyed by the ``jax.tree_util.keystr`` leaf paths of
``interop.state_to_numpy`` (``.pool.blk``, ``.stats['c:kbr_sent']``),
u32 leaves stored as ``uint32`` — so a file holds the same arrays, under
the same paths, as the JAX checkpoint of the same state — plus a
structure fingerprint over (path, shape, dtype) and a JSON ``__meta__``
manifest (tick / t_now, git rev, and the caller's extras: the config
hash, the service loop's window bookkeeping, a campaign's identity).  A
campaign's state (a list of S solo rows) is stored stacked ``[S, ...]``,
the JAX campaign's layout, and loads back into S rows.  Restoring needs
a structurally identical example (same configuration); the fingerprint
turns a shape mismatch into a clear error, and ``expect_config`` also
refuses a checkpoint whose recorded config hash names another scenario
with the same layout.

Writes are KILL-SAFE and POWER-LOSS-SAFE: the file is written to
``path + ".tmp"``, fsynced, ``os.replace``d, and the containing
directory is fsynced, so a SIGKILL at any instant leaves either the
previous complete checkpoint or the new one.  Directories that refuse
fsync (some network or overlay mounts) are tolerated: the rename is
still atomic there.  Arrays are deflated at level 1 (zlib, which
releases the GIL, so a writer thread overlaps the launching thread).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from oversim_tpu_torch import interop
from oversim_tpu_torch import telemetry as telemetry_mod
from oversim_tpu_torch import tree

FORMAT = "oversim-tpu-torch-ckpt-v1"
JAX_FORMATS = ("oversim-tpu-ckpt-v1", "oversim-tpu-ckpt-v2")
_RESERVED = ("__format__", "__fingerprint__", "__meta__")


def _is_rows(state) -> bool:
    """A campaign's state: a non-empty list of same-typed dataclass rows."""
    return (isinstance(state, list) and bool(state)
            and all(dataclasses.is_dataclass(r)
                    and type(r) is type(state[0]) for r in state))


def _np_dtype(path: str, dtype: torch.dtype) -> np.dtype:
    if interop.is_u32(path):
        return np.dtype(np.uint32)
    return torch.empty((), dtype=dtype).numpy().dtype


def _signature(state) -> list:
    """[(path, shape, numpy dtype)] in flattening order; campaign rows
    count as one ``[S, ...]`` stack."""
    rows = _is_rows(state)
    head = (len(state),) if rows else ()
    return [(p, head + tuple(x.shape), _np_dtype(p, x.dtype))
            for p, x in tree.leaves_with_path(state[0] if rows else state)]


def _fingerprint(sig) -> str:
    text = ";".join(f"{p}:{tuple(shape)}:{dt}" for p, shape, dt in sig)
    return hashlib.sha1(text.encode()).hexdigest()


def to_numpy(state) -> dict:
    """``{keystr path: np.ndarray}`` of a state (rows stacked)."""
    if _is_rows(state):
        state = tree.stack([tree.tree_map(lambda x: x.detach().cpu(), r)
                            for r in state])
    return interop.state_to_numpy(state)


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so the ``os.replace`` itself
    is durable; a directory that refuses fsync (EINVAL/EBADF on some
    mounts) is tolerated."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_npz(f, arrays: dict) -> None:
    with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1, allowZip64=True) as z:
        for name, a in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as member:
                np.lib.format.write_array(member, np.asarray(a),
                                          allow_pickle=False)


def save(path: str, state, meta: dict | None = None) -> int:
    """Atomically write ``state`` (a SimState, a campaign's rows, or any
    tree of tensors on any device) to ``path``; returns the file's bytes.

    ``meta`` is merged into the ``__meta__`` manifest; ``tick`` /
    ``t_now`` (read off the state's fields: scalars solo, lists for a
    campaign), ``git_rev`` and ``format`` are filled in when absent."""
    flat = to_numpy(state)
    m = dict(meta or {})
    m.setdefault("format", FORMAT)
    for name in ("tick", "t_now"):
        if name not in m and "." + name in flat:
            m[name] = flat["." + name].tolist()
    if "git_rev" not in m:
        m["git_rev"] = telemetry_mod.git_rev()
    arrays = {"__format__": np.asarray(FORMAT),
              "__fingerprint__": np.asarray(_fingerprint(_signature(state))),
              "__meta__": np.asarray(json.dumps(m, sort_keys=True))}
    arrays.update(flat)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_npz(f, arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)
    return os.path.getsize(path)


def _open(path: str):
    data = np.load(path, allow_pickle=False)
    fmt = str(data["__format__"]) if "__format__" in data.files else None
    if fmt == FORMAT:
        return data
    data.close()
    if fmt in JAX_FORMATS:
        raise ValueError(
            f"{path} is a JAX-package checkpoint ({fmt}); the PyTorch port "
            f"reads only its own format ({FORMAT})")
    raise ValueError(f"not an oversim-tpu-torch checkpoint: {path}")


def read_meta(path: str) -> dict:
    """The ``__meta__`` manifest without reading the array payload."""
    with _open(path) as data:
        return json.loads(str(data["__meta__"]))


def load_raw(path: str):
    """``({keystr path: np.ndarray}, meta)``: the stored arrays in the
    JAX dtypes (campaigns stacked), without an example structure."""
    with _open(path) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k not in _RESERVED}
    return flat, meta


def load(path: str, example, *, expect_config: str | None = None):
    """Restore a checkpoint into the structure of ``example`` (a state of
    the same configuration, typically ``sim.init()`` or
    ``campaign.init()``; its values are discarded).  Leaves land on the
    example's device with the example's dtypes.  ``expect_config``: a
    ``telemetry.config_hash``; a checkpoint recording another hash is
    refused even when the layout matches."""
    with _open(path) as data:
        meta = json.loads(str(data["__meta__"]))
        if expect_config is not None:
            got = meta.get("config_hash")
            if got is not None and got != expect_config:
                raise ValueError(
                    "checkpoint scenario mismatch: checkpoint was written "
                    f"by config {got} but this run is config "
                    f"{expect_config} ({path})")
        want = _fingerprint(_signature(example))
        got = str(data["__fingerprint__"])
        if want != got:
            raise ValueError(
                "checkpoint structure mismatch (different Simulation "
                f"configuration): checkpoint {got[:12]} vs example "
                f"{want[:12]}")
        flat = {k: data[k] for k in data.files if k not in _RESERVED}

    def put(path_, leaf, a):
        if interop.is_u32(path_):
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(
            device=leaf.device, dtype=leaf.dtype)

    if _is_rows(example):
        return [tree.map_with_path(lambda p, x, r=r: put(p, x, flat[p][r]),
                                   row)
                for r, row in enumerate(example)]
    return tree.map_with_path(lambda p, x: put(p, x, flat[p]), example)
