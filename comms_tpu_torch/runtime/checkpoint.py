"""Pipeline-state checkpoint / resume, in the JAX package's file format.

Counterpart of :mod:`comms_tpu.runtime.checkpoint`.  A state is saved as
an ``.npz`` of its leaves (``leaf_0``, ``leaf_1``, ... in JAX's pytree
order, complex leaves as ``[..., 2]`` re/im pairs tagged in the sidecar)
beside a ``.json`` sidecar with the leaf count, the tags and the leaf
paths (JAX's ``keystr`` strings).  Resume is exact: the restored stream
continues bit for bit.

The files carry across: a checkpoint that the JAX package wrote for a
``Pipeline`` loads into the port's counterpart ``Pipeline`` (the states
have the same structure, leaf for leaf) and the other way round.  A
leaf is cast to its template's type on load: the port's threefry keys
are int64 words where JAX's are uint32, its mixer words Python integers
(written as uint32, as JAX writes them).  :func:`state_from_jax` turns
a JAX state's leaves, as numpy arrays, into the port's state.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from comms_tpu_torch.runtime import _tree, boundary

__all__ = ["save_state", "load_state", "state_from_jax"]

_COMPLEX_TAG = "__complex_pairs__"
_M32 = 0xFFFFFFFF


def _path_fingerprint(tree) -> list[str]:
    """The key path of every leaf, as JAX's ``keystr`` writes it."""
    return [p for p, _ in _tree.leaves_with_paths(tree)]


def _norm_path(path) -> str:
    """np.savez appends .npz when missing; normalise up front so the
    array file and the json sidecar share one basename."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and 0 <= leaf <= _M32:
        return np.asarray(leaf, np.uint32)
    return np.asarray(leaf)


def save_state(path, state: Any, meta: dict | None = None) -> None:
    """Snapshot a state to an .npz (+ json metadata)."""
    path = _norm_path(path)
    leaves = _tree.leaves(boundary.encode_state(state))
    tags = [_COMPLEX_TAG if boundary.is_complex_leaf(l) else ""
            for l in _tree.leaves(state)]
    np.savez(path, **{f"leaf_{i}": _host(l) for i, l in enumerate(leaves)})
    sidecar = {
        "num_leaves": len(leaves),
        "tags": tags,
        "paths": _path_fingerprint(state),
        "meta": meta or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)


def _like(value, tmpl):
    """A loaded leaf as its template's type, dtype and device: a tensor,
    or a Python integer (the mixer's fixed-point words)."""
    if isinstance(tmpl, torch.Tensor):
        a = np.array(value)          # a writable copy
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device=tmpl.device, dtype=tmpl.dtype)
    return type(tmpl)(np.asarray(value))


def _restore(like, values, tags):
    out = [boundary.leaf_from_pairs(v, t) if tag == _COMPLEX_TAG
           else _like(v, t)
           for v, tag, t in zip(values, tags, _tree.leaves(like))]
    return _tree.unflatten_like(like, out)


def load_state(path, like: Any):
    """Restore a state saved by :func:`save_state` (here or by the JAX
    package).  ``like``: a template with the target structure, dtypes
    and devices (e.g. ``pipeline.init_state()``)."""
    path = _norm_path(path)
    data = np.load(path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    n = len(_tree.leaves(like))
    if n != sidecar["num_leaves"]:
        raise ValueError(f"checkpoint has {sidecar['num_leaves']} leaves, "
                         f"template has {n}")
    paths = _path_fingerprint(like)
    saved = sidecar.get("paths", paths)  # absent in old checkpoints
    if saved != paths:
        raise ValueError("checkpoint structure mismatch: saved leaf paths "
                         f"{saved} != template {paths}")
    values = [data[f"leaf_{i}"] for i in range(n)]
    return _restore(like, values, sidecar["tags"])


def state_from_jax(pipe, leaves, device="cuda"):
    """The JAX package's state of ``pipe``'s counterpart -> the port's
    state of ``pipe`` (a ``Pipeline`` or ``Graph``) on ``device``.
    ``leaves``: the JAX state's leaves as numpy arrays, in
    ``jax.tree_util.tree_leaves`` order (or the state itself, a nest of
    tuples, lists and dicts of arrays); complex leaves stay complex."""
    like = pipe.init_state(device=device)
    values = _tree.leaves(leaves)
    n = len(_tree.leaves(like))
    if len(values) != n:
        raise ValueError(f"{len(values)} leaves for a state of {n}")
    return _tree.unflatten_like(
        like, [_like(v, t) for v, t in zip(values, _tree.leaves(like))])
