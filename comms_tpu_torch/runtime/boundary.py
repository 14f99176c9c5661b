"""Complex values as float re/im pairs: the boundary codecs.

Counterpart of :mod:`comms_tpu.runtime.boundary`.  The JAX package
speaks float32 pairs at every jit boundary because its TPU runtime
cannot move complex arrays; PyTorch has no such limit, so the port uses
the codecs where a format asks for pairs: the device-side
:func:`pairs_to_complex` / :func:`complex_to_pairs` (tensors in and
out, on any device), the host pair helpers and the state codecs; its
checkpoint files hold complex leaves as ``[..., 2]`` pairs, the JAX
package's format.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.runtime._tree import tree_map

__all__ = [
    "pairs_to_complex",
    "complex_to_pairs",
    "host_complex_to_pairs",
    "host_pairs_to_complex",
    "encode_state",
    "decode_state",
    "is_complex_leaf",
    "leaf_to_pairs",
    "leaf_from_pairs",
]


def pairs_to_complex(p):
    """``[..., 2]`` float -> ``[...]`` complex of the matching width
    (float32 -> complex64, float64 -> complex128), on ``p``'s device."""
    p = torch.as_tensor(p)
    return torch.complex(p[..., 0], p[..., 1])


def complex_to_pairs(z):
    """``[...]`` complex -> ``[..., 2]`` float re/im pairs, on ``z``'s
    device."""
    z = torch.as_tensor(z)
    return torch.stack([z.real, z.imag], dim=-1)


def host_complex_to_pairs(x: np.ndarray) -> np.ndarray:
    """Host-side complex -> float32 pairs (a view when contiguous)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def host_pairs_to_complex(p: np.ndarray) -> np.ndarray:
    """Host-side float32 pairs -> complex64 (a view when contiguous)."""
    p = np.ascontiguousarray(p, dtype=np.float32)
    return p.view(np.complex64).reshape(p.shape[:-1])


def is_complex_leaf(leaf) -> bool:
    """Whether a state leaf (tensor or numpy value) is complex."""
    if isinstance(leaf, torch.Tensor):
        return leaf.is_complex()
    return np.iscomplexobj(leaf)


def leaf_to_pairs(leaf):
    """A complex tensor leaf as ``[..., 2]`` re/im pairs of its real
    dtype."""
    return torch.view_as_real(leaf.resolve_conj()).clone()


def leaf_from_pairs(pairs, like):
    """``[..., 2]`` pairs (a tensor or numpy array) as a complex tensor
    of ``like``'s dtype and device."""
    p = torch.as_tensor(np.asarray(pairs), device=like.device)
    return torch.complex(p[..., 0], p[..., 1]).to(like.dtype)


def encode_state(state):
    """Map every complex leaf of a state to ``[..., 2]`` real pairs."""
    return tree_map(lambda l: leaf_to_pairs(l) if is_complex_leaf(l) else l,
                    state)


def decode_state(encoded, like):
    """Inverse of :func:`encode_state`, given the original structure
    ``like`` (whose leaves carry the target dtypes and devices)."""
    return tree_map(
        lambda e, l: leaf_from_pairs(e, l) if is_complex_leaf(l) else e,
        encoded, like)
