"""Minimal pytree walking over the port's state containers.

State is made of dataclasses (fields whose metadata says ``static`` are
configuration, not leaves), dicts, tuples/lists, ``None`` and tensors.
Leaf paths are spelled like ``jax.tree_util.keystr`` (``.pool.blk``,
``.stats['c:kbr_sent']``), so a state maps one to one onto the JAX
package's pytree; dict keys are visited in sorted order, as JAX does.
``to_host`` copies a tree to host memory with one wait.
"""

from __future__ import annotations

import dataclasses

import torch


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)
            if not f.metadata.get("static", False)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to corresponding tensor leaves of same-shaped trees."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        kw = {name: tree_map(fn, getattr(tree, name),
                             *(getattr(r, name) for r in rest))
              for name in _fields(tree)}
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    raise TypeError(f"tree_map: unsupported node {type(tree)}")


def stack(trees):
    """Same-shaped trees -> one tree whose tensor leaves gain a leading
    ``[S]`` axis (a campaign's stacked layout); ``None`` stays None."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def unstack(tree) -> list:
    """The inverse of ``stack``: the S trees along the leading axis."""
    leaves = leaves_with_path(tree)
    s = leaves[0][1].shape[0] if leaves else 0
    return [tree_map(lambda x, r=r: x[r], tree) for r in range(s)]


def map_with_path(fn, tree, prefix=""):
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's path."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if dataclasses.is_dataclass(tree):
        kw = {name: map_with_path(fn, getattr(tree, name), f"{prefix}.{name}")
              for name in _fields(tree)}
        return dataclasses.replace(tree, **kw)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    raise TypeError(f"map_with_path: unsupported node {type(tree)}")


def leaves_with_path(tree):
    """[(keystr path, tensor)] in JAX's flattening order (sorted dict
    keys)."""
    out = []

    def visit(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], f"{prefix}[{k!r}]")
        elif dataclasses.is_dataclass(node):
            for name in _fields(node):
                visit(getattr(node, name), f"{prefix}.{name}")
        else:
            map_with_path(lambda p, t: out.append((p, t)), node, prefix)

    visit(tree, "")
    return out


def to_host(tree):
    """Every tensor leaf copied to host memory with ONE wait: card
    tensors go into pinned buffers by non-blocking copies enqueued in
    stream order, then the host waits on one CUDA event; host tensors
    pass through as they are."""
    on_card = []

    def copy(x):
        if not x.is_cuda:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        on_card.append(x.device)
        return h

    out = tree_map(copy, tree)
    if on_card:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(on_card[0]))
        ev.synchronize()
    return out
