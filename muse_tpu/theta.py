"""Hyper-parameter (θ) handling: named flat vectors.

The reference uses ComponentArrays.jl to give θ both flat-vector semantics
(for the outer Newton iteration / dense linear algebra) and named-field
access (reference ``src/util.jl:32-53``, ``standardizeθ`` at
``src/interface.jl:134`` / ``src/turing.jl:188``).

The equivalent here is a :class:`ThetaSpec` built from an example θ
PyTree: it ravels any user-facing θ (scalar, dict, NamedTuple-like mapping,
or array PyTree) into a flat ``jnp`` vector for the solver, and unravels
solver output back into the user's structure.  All solver math operates on
the flat vector (tiny dense linalg, replicated across the mesh); only the
user-facing API sees the structured form.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

__all__ = ["ThetaSpec"]


def _canonicalize(theta: Any, dtype) -> Any:
    """Convert user θ (scalar / dict / pytree) into a pytree of jnp arrays."""
    if isinstance(theta, Mapping):
        return {k: jnp.asarray(v, dtype=dtype) for k, v in theta.items()}
    return jax.tree.map(lambda v: jnp.asarray(v, dtype=dtype), theta)


@dataclasses.dataclass(frozen=True)
class ThetaSpec:
    """Maps user-facing θ structures to flat vectors and back.

    Attributes:
      unravel: callable taking a flat ``(n,)`` vector to the user structure.
      n: flat dimension of θ.
      scalar: True if the user passed a bare scalar (so results are returned
        as scalars rather than length-1 vectors).
      names: flat coordinate names, e.g. ``["theta", "mu[0]", "mu[1]"]`` —
        the ComponentArrays label analog, used for pretty-printing results.
    """

    unravel: Callable[[jnp.ndarray], Any]
    n: int
    scalar: bool
    names: tuple
    dtype: Any

    @classmethod
    def from_example(cls, theta: Any, dtype=jnp.float32) -> "ThetaSpec":
        tree = _canonicalize(theta, dtype)
        flat, unravel = ravel_pytree(tree)
        scalar = jnp.ndim(theta) == 0 if not isinstance(theta, Mapping) else False
        names = _leaf_names(tree)
        return cls(unravel=unravel, n=int(flat.shape[0]), scalar=scalar,
                   names=tuple(names), dtype=dtype)

    def flatten(self, theta: Any) -> jnp.ndarray:
        """User θ → flat (n,) vector. The ``standardizeθ`` analog."""
        tree = _canonicalize(theta, self.dtype)
        flat, _ = ravel_pytree(tree)
        if flat.shape[0] != self.n:
            raise ValueError(
                f"θ has flat dimension {flat.shape[0]}, expected {self.n}")
        return flat

    def unflatten(self, flat: jnp.ndarray) -> Any:
        """Flat vector → user structure (scalar unwrap included)."""
        out = self.unravel(jnp.asarray(flat, dtype=self.dtype))
        return out

    def to_user(self, flat) -> Any:
        """Like :meth:`unflatten` but converts to host-side numpy/py floats."""
        out = self.unflatten(jnp.asarray(flat))
        def conv(v):
            v = np.asarray(v)
            return float(v) if v.ndim == 0 else v
        return jax.tree.map(conv, out)


def _leaf_names(tree: Any) -> list:
    """Flat coordinate labels for a θ pytree (stable, matches ravel order)."""
    names = []
    leaves_with_paths = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves_with_paths:
        base = "".join(_path_str(p) for p in path).lstrip(".")
        size = int(np.prod(np.shape(leaf))) if np.ndim(leaf) > 0 else 1
        if size == 1 and np.ndim(leaf) == 0:
            names.append(base or "theta")
        else:
            names.extend(f"{base or 'theta'}[{i}]" for i in range(size))
    return names


def _path_str(p) -> str:
    from jax.tree_util import DictKey, GetAttrKey, SequenceKey
    if isinstance(p, DictKey):
        return f".{p.key}"
    if isinstance(p, GetAttrKey):
        return f".{p.name}"
    if isinstance(p, SequenceKey):
        return f"[{p.idx}]"
    return str(p)
