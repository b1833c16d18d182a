"""Numerical-debugging helpers.

The port of the JAX package's `core/debug.py`.  What is worth guarding is
numerics: NaN propagation in training, and the determinism of cross-shard
reductions.

- `nan_guard()`: inside the scope every floating-point output of every
  torch operation, forward and backward, is checked, and the first that
  holds a NaN raises FloatingPointError naming the operation (JAX's
  `jax_debug_nans`).  It is a `TorchDispatchMode`: autograd's anomaly
  mode alone checks only the backward.  Each check reads a flag back from
  the device, so the scope runs slowly on a card;
- `assert_finite(tree, name)`: fail fast on a nested dict / list / tuple
  of tensors (or arrays, or numbers) holding a NaN or an infinity,
  naming the leaf's path as JAX's `keystr` does; integer leaves are
  skipped;
- determinism: every top-k merge tie-breaks by global index
  (ops/topk.py), so retrieval results do not depend on the shard layout,
  and a sharded lookup has exactly one non-zero term per row
  (parallel/embedding.py), so it is bitwise the dense gather.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise at the first operation inside the scope that outputs a NaN."""
    with _NanCheck():
        yield


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ValueError naming the first non-finite floating leaf."""
    for path, leaf in _leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise ValueError(f"non-finite values in {name}{path}")
