"""Matmul (einsum) DFT — a drop-in rfft2/irfft2 for layouts XLA's fft
thunk cannot take.

Why this exists: the field-axis (model-parallel) mesh mode shards the
flattened latent inside each MAP solve (SURVEY §2.2's beyond-reference
capability).  Under a 2-axis sims×field GSPMD partition, XLA may assign
the FFT operand a non-default layout, which the CPU backend's fft thunk
rejects outright (``fft_thunk.cc:167 RET_CHECK
IsMonotonicWithDim0Major`` — reproduced on jax 0.9).  Expressed as two
complex contractions, the same transform is just einsums — partitionable
by GSPMD like any matmul (collectives over the contracted/sharded axis),
and accepted on every backend.

Cost: O(n³) per field vs O(n² log n) — the right trade at small/medium n
or when the alternative is "does not run at all".  The GRF model family
selects this path automatically when its mesh has a field axis on a
backend whose fft thunk rejects partitioned layouts (models/grf.py).

Math (n×n real grid, rfft convention, verified against jnp.fft):
  rfft2:   V = F U Rᵀ,        F[k,a] = e^{-2πi ka/n}  (n×n),
                              R[k,b] = e^{-2πi kb/n}  (n_r×n, n_r=n//2+1)
  irfft2:  U = Re[ F̄ (w∘V) R̄ᵀ ] / n²,   w = hermitian column weights
           (1 for the self-conjugate k∈{0, n/2} columns, 2 otherwise):
           the conjugate half-spectrum contributes the complex conjugate
           of each interior column's term, so doubling + Re replaces the
           explicit hermitian extension.  Exact for hermitian-consistent
           V (anything derived from rfft2 of real data times real
           spectra — all uses here).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["plan_dft2", "Dft2Plan"]

# full-f32 products: the default precision lets a GPU run these
# contractions in TF32 (about three significant digits), far coarser than
# the jnp.fft path this transform stands in for
_HIGHEST = jax.lax.Precision.HIGHEST


class Dft2Plan:
    """Precomputed DFT matrices for an n×n grid (complex64).

    ``rfft2``/``irfft2`` accept arbitrary leading batch dims, transform
    the trailing two axes, and match ``jnp.fft.rfft2``/``irfft2`` to f32
    roundoff.
    """

    def __init__(self, n: int):
        self.n = n
        k = np.arange(n)
        kr = np.arange(n // 2 + 1)
        tw = np.exp(-2j * np.pi * np.outer(k, k) / n)
        self.F = jnp.asarray(tw, jnp.complex64)                 # (n, n)
        self.R = jnp.asarray(tw[: n // 2 + 1], jnp.complex64)   # (n_r, n)
        w = np.full(n // 2 + 1, 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        # fold the hermitian weights and 1/n² into the inverse column
        # matrix so irfft2 is exactly two contractions + real part
        Rc = np.exp(2j * np.pi * np.outer(kr, k) / n) * w[:, None] / n ** 2
        self.Fi = jnp.asarray(tw.conj(), jnp.complex64)         # (n, n)
        self.Ri = jnp.asarray(Rc, jnp.complex64)                # (n_r, n)

    def rfft2(self, U):
        """(…, n, n) real → (…, n, n_r) complex, = jnp.fft.rfft2(U)."""
        V = jnp.einsum("...ab,kb->...ak", U.astype(jnp.complex64), self.R,
                       precision=_HIGHEST)
        return jnp.einsum("ka,...ab->...kb", self.F, V, precision=_HIGHEST)

    def irfft2(self, V):
        """(…, n, n_r) hermitian-consistent complex → (…, n, n) real."""
        W = jnp.einsum("...ak,kb->...ab", V, self.Ri, precision=_HIGHEST)
        return jnp.einsum("ka,...ab->...kb", self.Fi, W,
                          precision=_HIGHEST).real


@functools.lru_cache(maxsize=None)
def plan_dft2(n: int) -> Dft2Plan:
    """Cached :class:`Dft2Plan` for an n×n grid."""
    return Dft2Plan(n)
