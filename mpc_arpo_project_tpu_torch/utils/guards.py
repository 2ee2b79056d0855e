"""Numeric guards: NaN/divergence detection on rollout outputs.

Counterpart of ``mpc_arpo_project_tpu/utils/guards.py``. The JAX package
flattens pytrees; here the containers a rollout returns (NamedTuples,
dataclasses, dicts, lists and tuples) are walked directly, and each
non-finite leaf is named by its path, as ``jax.tree_util.keystr`` names it
(``.x_true``, ``['acc']``, ``[2]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def tree_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            yield from tree_leaves(getattr(tree, k), f"{path}.{k}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming every floating-point leaf of
    ``tree`` (tensors on any device, numpy arrays, Python floats) that holds
    a non-finite value."""
    bad = []
    for path, leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            ok = (not leaf.is_floating_point()
                  or bool(torch.isfinite(leaf).all()))
        else:
            arr = np.asarray(leaf)
            ok = arr.dtype.kind != "f" or bool(np.isfinite(arr).all())
        if not ok:
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def finite_or(x: torch.Tensor, fallback: float) -> torch.Tensor:
    """Replace non-finite entries (guards optional telemetry paths)."""
    return torch.where(torch.isfinite(x), x, fallback)
