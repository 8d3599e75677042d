"""Helpers over the port's parameter trees: nested dicts and lists of
tensors (or numpy arrays), and dataclasses of them (`TrainState`).

The reference stacks repeated blocks on leading axes; the port keeps a
list of per-layer dicts (`models/convert.py`).  So a list here stands for
one stacked leaf per path below it: `tree_flatten_with_names` gives each
such leaf the name the reference gives it, and its value stacked over the
list's entries (nested lists: one leading axis each), in the reference's
order (dict keys sorted, dataclass fields in order).  Names join the path
with "/" as the reference's `repro.utils.tree.tree_flatten_with_names`
does (its module calls them dotted names), so a checkpoint written by
either package names its leaves alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _items(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return sorted(tree.items())
    return None


def named_groups(tree, prefix: str = ""):
    """[(name, parts, lead)]: each stacked leaf of the reference's layout
    as the flat list of the port's leaves that make it (row-major over the
    lists' entries) and the list lengths `lead` that stack them (() for a
    leaf under no list)."""
    items = _items(tree)
    if items is not None:
        out = []
        for k, v in items:
            out += named_groups(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    if isinstance(tree, list):
        per = [named_groups(t, prefix) for t in tree]
        if any(len(p) != len(per[0]) for p in per):
            raise ValueError(f"{prefix}: list entries differ in structure")
        return [(name, [x for p in per for x in p[i][1]],
                 (len(tree),) + lead)
                for i, (name, _, lead) in enumerate(per[0])]
    return [(prefix, [tree], ())]


def stack_parts(parts, lead):
    """One array of shape lead + part shape from `named_groups`' parts
    (torch tensors or numpy arrays); a lone leaf comes back as it is."""
    if not lead:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts).reshape(*lead, *parts[0].shape)
    return np.stack(parts).reshape(*lead, *np.shape(parts[0]))


def tree_flatten_with_names(tree):
    """(name, leaf) pairs in the reference's layout and order."""
    return [(name, stack_parts(parts, lead))
            for name, parts, lead in named_groups(tree)]


def tree_leaves(tree) -> list:
    """The port's own leaves (tensors, arrays, numbers) in a fixed order."""
    return [x for _, parts, _ in named_groups(tree) for x in parts]


def tree_map(fn, tree, *rest):
    """The tree with every leaf x (and its twins in `rest`) -> fn(x, ...)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten_with_names(like, arrays: dict,
                              fn=lambda a, ref, name: a):
    """The inverse of `tree_flatten_with_names` into the structure of
    `like`: the leaf of each reference name is split over its lists'
    entries, and every part passes through fn(part, like's part, name)."""
    parts_of = {}
    for name, parts, lead in named_groups(like):
        if name not in arrays:
            raise KeyError(f"missing leaf {name!r}")
        a = arrays[name]
        want = tuple(lead) + tuple(np.shape(parts[0]))
        if tuple(np.shape(a)) != want:
            raise ValueError(f"leaf {name!r}: shape {tuple(np.shape(a))} != "
                             f"expected {want}")
        n = int(np.prod(lead)) if lead else 1
        flat = a.reshape(n, *want[len(lead):]) if lead else [a]
        parts_of[name] = iter([fn(flat[i], parts[i], name)
                               for i in range(n)])

    def build(tree, prefix):
        items = _items(tree)
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            return dataclasses.replace(tree, **{
                k: build(v, f"{prefix}/{k}" if prefix else k)
                for k, v in items})
        if items is not None:
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(t, prefix) for t in tree]
        return next(parts_of[prefix])
    return build(like, "")


def _size(x) -> int:
    return int(np.prod(np.shape(x)))


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.asarray(x).dtype.itemsize


def tree_num_params(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(_size(x) for x in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves (meta tensors count too)."""
    return sum(_size(x) * _itemsize(x) for x in tree_leaves(tree))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def tree_allclose(a, b, rtol=1e-5, atol=1e-5) -> bool:
    la, lb = tree_flatten_with_names(a), tree_flatten_with_names(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        return False
    return all(np.allclose(_numpy(x), _numpy(y), rtol=rtol, atol=atol)
               for (_, x), (_, y) in zip(la, lb))


def tree_any_nan(tree) -> bool:
    return any(bool(torch.isnan(x).any()) if isinstance(x, torch.Tensor)
               else bool(np.isnan(np.asarray(x, np.float64)).any())
               for x in tree_leaves(tree))
