"""Minimal distribution library backing the PPL adapter, models, and results.

The reference leans on Distributions.jl / MeasureTheory.jl for model
definitions and for the convenience ``result.dist`` (``Normal`` /
``MvNormal`` built in ``finalize_result!``, reference ``src/muse.jl:542-546``).
numpyro / TFP are not available in this environment, so this module provides
a self-contained JAX-native equivalent: pure dataclass-style distributions
with ``sample`` / ``log_prob`` / ``support``, broadcastable parameters, and
an ``expand`` for i.i.d. batches.  Everything is jit/vmap/grad-safe.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "Distribution", "Normal", "LogNormal", "HalfNormal", "Uniform",
    "Exponential", "Gamma", "Beta", "StudentT", "MvNormal", "MvNormalDiag",
]

_LOG2PI = float(np.log(2.0 * np.pi))


class Distribution:
    """Base: broadcastable elementwise distribution."""

    support = "real"
    shape: Tuple[int, ...] = ()

    def sample(self, key, shape=None):
        raise NotImplementedError

    def log_prob(self, x):
        """Elementwise log density (NOT summed; the PPL sums per site)."""
        raise NotImplementedError

    def expand(self, shape):
        """Broadcast parameters to ``shape`` (i.i.d. batch)."""
        return _Expanded(self, tuple(shape))

    def bijector(self):
        """Support bijector (constrained → unconstrained) for this
        distribution's actual support, bounds included.  The PPL links
        latents and hypers through this (Turing's link machinery analog,
        reference src/turing.jl:142-153)."""
        from .transforms import from_support
        return from_support(self.support)

    def _param_shape(self):
        return self.shape


@dataclasses.dataclass(frozen=True)
class _Expanded(Distribution):
    base: Distribution
    _shape: Tuple[int, ...]

    @property
    def support(self):  # type: ignore[override]
        return self.base.support

    @property
    def shape(self):  # type: ignore[override]
        return self._shape

    def sample(self, key, shape=None):
        return self.base.sample(key, self._shape if shape is None else shape)

    def log_prob(self, x):
        # broadcast to the expanded batch shape so a scalar value under
        # an expansion/plate is counted once PER BATCH ELEMENT when the
        # PPL sums the site density (numpyro's accounting)
        lp = self.base.log_prob(x)
        return jnp.broadcast_to(
            lp, jnp.broadcast_shapes(jnp.shape(lp), self._shape))

    def bijector(self):
        return self.base.bijector()


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: jnp.ndarray = 0.0
    scale: jnp.ndarray = 1.0
    support = "real"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))

    @property
    def mean(self):
        """Distributions.jl ``mean(result.dist)`` parity (docs/index.md)."""
        return self.loc

    @property
    def stddev(self):
        return self.scale

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG2PI) - jnp.log(self.scale)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: jnp.ndarray = 0.0
    scale: jnp.ndarray = 1.0
    support = "positive"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc), jnp.shape(self.scale))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return jnp.exp(self.loc + self.scale * eps)

    def log_prob(self, x):
        lx = jnp.log(x)
        z = (lx - self.loc) / self.scale
        return -0.5 * (z * z + _LOG2PI) - jnp.log(self.scale) - lx


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    lo: jnp.ndarray = 0.0
    hi: jnp.ndarray = 1.0

    @property
    def support(self):  # type: ignore[override]
        if np.shape(self.lo) == () and np.shape(self.hi) == () \
                and float(self.lo) == 0.0 and float(self.hi) == 1.0:
            return "unit_interval"
        return "interval"

    def bijector(self):
        from .transforms import Logit
        return Logit(self.lo, self.hi)

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.lo), jnp.shape(self.hi))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        u = jax.random.uniform(key, shape, dtype=jnp.result_type(float))
        return self.lo + (self.hi - self.lo) * u

    def log_prob(self, x):
        inside = (x >= self.lo) & (x <= self.hi)
        lp = -jnp.log(self.hi - self.lo)
        return jnp.where(inside, lp, -jnp.inf)


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: jnp.ndarray = 1.0
    support = "positive"

    @property
    def shape(self):
        return jnp.shape(self.rate)

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        u = jax.random.uniform(key, shape, dtype=jnp.result_type(float))
        return -jnp.log1p(-u) / self.rate

    def log_prob(self, x):
        return jnp.log(self.rate) - self.rate * x


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    scale: jnp.ndarray = 1.0
    support = "positive"

    @property
    def shape(self):
        return jnp.shape(self.scale)

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        return jnp.abs(self.scale * jax.random.normal(
            key, shape, dtype=jnp.result_type(float)))

    def log_prob(self, x):
        z = x / self.scale
        return (-0.5 * (z * z + _LOG2PI) + jnp.log(2.0)
                - jnp.log(self.scale))


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    concentration: jnp.ndarray = 1.0
    rate: jnp.ndarray = 1.0
    support = "positive"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.concentration),
                                    jnp.shape(self.rate))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        g = jax.random.gamma(key, jnp.broadcast_to(self.concentration,
                                                   shape),
                             dtype=jnp.result_type(float))
        return g / self.rate

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return (a * jnp.log(b) + (a - 1) * jnp.log(x) - b * x
                - jax.scipy.special.gammaln(a))


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: jnp.ndarray = 1.0
    b: jnp.ndarray = 1.0
    support = "unit_interval"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.a), jnp.shape(self.b))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        return jax.random.beta(key, jnp.broadcast_to(self.a, shape),
                               jnp.broadcast_to(self.b, shape),
                               dtype=jnp.result_type(float))

    def log_prob(self, x):
        a, b = self.a, self.b
        return ((a - 1) * jnp.log(x) + (b - 1) * jnp.log1p(-x)
                - (jax.scipy.special.gammaln(a)
                   + jax.scipy.special.gammaln(b)
                   - jax.scipy.special.gammaln(a + b)))


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    df: jnp.ndarray = 1.0
    loc: jnp.ndarray = 0.0
    scale: jnp.ndarray = 1.0
    support = "real"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.df), jnp.shape(self.loc),
                                    jnp.shape(self.scale))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        t = jax.random.t(key, self.df, shape,
                         dtype=jnp.result_type(float))
        return self.loc + self.scale * t

    def log_prob(self, x):
        v = self.df
        z = (x - self.loc) / self.scale
        return (jax.scipy.special.gammaln((v + 1) / 2)
                - jax.scipy.special.gammaln(v / 2)
                - 0.5 * jnp.log(v * jnp.pi) - jnp.log(self.scale)
                - ((v + 1) / 2) * jnp.log1p(z * z / v))


@dataclasses.dataclass(frozen=True)
class MvNormalDiag(Distribution):
    """Diagonal-covariance multivariate normal (event dim = last axis)."""

    loc: jnp.ndarray
    scale_diag: jnp.ndarray
    support = "real"

    @property
    def shape(self):
        return jnp.broadcast_shapes(jnp.shape(self.loc),
                                    jnp.shape(self.scale_diag))

    def sample(self, key, shape=None):
        shape = self.shape if shape is None else tuple(shape)
        eps = jax.random.normal(key, shape, dtype=jnp.result_type(float))
        return self.loc + self.scale_diag * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale_diag
        lp = -0.5 * (z * z + _LOG2PI) - jnp.log(self.scale_diag)
        return jnp.sum(lp, axis=-1)


@dataclasses.dataclass(frozen=True)
class MvNormal(Distribution):
    """Full-covariance multivariate normal (for ``result.dist``)."""

    loc: jnp.ndarray
    cov: jnp.ndarray
    support = "real"

    @property
    def shape(self):
        return jnp.shape(self.loc)

    @property
    def _chol(self):
        return jnp.linalg.cholesky(self.cov)

    def sample(self, key, shape=None):
        n = jnp.shape(self.loc)[-1]
        batch = () if shape is None else tuple(shape)[:-1]
        eps = jax.random.normal(key, batch + (n,), dtype=jnp.result_type(float))
        return self.loc + jnp.matmul(eps, self._chol.T,
                                     precision=jax.lax.Precision.HIGHEST)

    def log_prob(self, x):
        L = self._chol
        d = x - self.loc
        y = jax.scipy.linalg.solve_triangular(L, d[..., None], lower=True)[..., 0]
        n = jnp.shape(self.loc)[-1]
        return (-0.5 * jnp.sum(y * y, axis=-1)
                - jnp.sum(jnp.log(jnp.diagonal(L)))
                - 0.5 * n * _LOG2PI)

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return jnp.sqrt(jnp.diagonal(self.cov, axis1=-2, axis2=-1))
