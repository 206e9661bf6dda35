"""Bandpower GRF model — many-component vector θ (the CMB-bandpower config).

The real-world problem family MUSE was built for (arXiv:2112.09354 §5:
CMB lensing BANDPOWERS — tens of θ components, one per annulus of |k|):
infer the per-band log-amplitudes θ ∈ R^nbands of a 2D Gaussian random
field's power spectrum from a noisy map,

  C_k(θ) = exp(θ_{b(k)}) · (|k| + k0)^{-γ},    b(k) = the |k|-annulus,
  u ~ N(0, I),  z = S_θ u,  x = z + σ n.

Reference anchor: the reference handles vector θ generically through
ComponentArrays (`src/muse.jl:277-333` pmaps the FD Jacobian over θ
columns when length(θ) > nsims — `pmap_over=:jac`); it ships no field
model, so this family is the framework-native config that actually
exercises that nθ ≫ 1 regime (BASELINE configs 4-5 extended to vector θ).

Design: carried end-to-end in the isometric PACKED-SPECTRAL
coordinates of :mod:`muse_tpu.models.grf` (``grf_spectral_problem``) —
every density, score, MAP solve, and the exact implicit-diff H
preconditioner is diagonal elementwise work, the hermitian white noise is
drawn by indexing (``hermitian_white_packed``), and the per-band score
reduction is one ``segment_sum`` over static band indices.  A full MUSE
iteration runs ZERO FFT-sized kernels at any nbands.

Closed-form oracle: the bands are disjoint, so the marginal MLE decouples
per band and the Fisher matrix is exactly DIAGONAL — `bandpower_mle`
returns both, pinning MUSE's full vector-θ pipeline (θ̂, Σ, and the
off-diagonals of Σ, which must vanish here) far more sharply than the
reference's z<2 oracle (test/runtests.jl:31).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..adapters.simple import SimpleMuseProblem
from ..ops.cg import batched_cg
from .grf import GrfConfig, hermitian_white_packed

__all__ = ["band_edges", "bandpower_problem", "bandpower_mle"]


def _k_grid64(n: int) -> np.ndarray:
    """The rfft grid's |k| in float64 — THE band-assignment coordinate.

    Band membership must be decided on the same float64 values that
    ``band_edges`` quantized, everywhere: a float32 round-trip (e.g. via
    ``GrfConfig.k``) can push a mode sitting exactly on an edge into the
    band below, emptying a band that ``band_edges`` guaranteed non-empty
    (and making the decoupled Fisher matrix singular)."""
    ky = np.fft.fftfreq(n) * n
    kx = np.fft.rfftfreq(n) * n
    return np.hypot(ky[:, None], kx[None, :])


def band_edges(n: int, nbands: int) -> np.ndarray:
    """|k|-annulus edges with ~equal hermitian-weighted mode counts.

    Quantile edges over the rfft grid's |k| distribution (counting each
    conjugate pair once via the hermitian weights), deduplicated so every
    band is non-empty.  Raises if the grid can't support ``nbands``
    distinct annuli.
    """
    k = _k_grid64(n).ravel()
    w = np.full((n, n // 2 + 1), 2.0)
    w[:, 0] = 1.0
    if n % 2 == 0:
        w[:, -1] = 1.0
    order = np.argsort(k)
    cw = np.cumsum(w.ravel()[order])
    targets = cw[-1] * np.arange(1, nbands) / nbands
    idx = np.searchsorted(cw, targets)
    edges = np.unique(k[order][idx])
    if len(edges) != nbands - 1:
        raise ValueError(
            f"grid n={n} has too few distinct |k| annuli for "
            f"nbands={nbands}; use a larger n or fewer bands")
    return edges


def bandpower_problem(n: int = 64, nbands: int = 8, *,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true=None, data_key=None,
                      x_obs=None, solver: str = "cg",
                      cg_maxiter: int = 200, prior_std: float = 3.0,
                      mesh=None) -> SimpleMuseProblem:
    """Build the bandpower MUSE problem (see module docstring).

    θ is the length-``nbands`` vector of per-annulus log-amplitudes.
    ``x_obs`` may be a pixel-space (n, n) map (converted host-side) or an
    already-packed vector; ``prob.x_real`` holds the pixel map for the
    closed-form oracle.  ``solver="cg"`` (default) is the batched
    diagonal-operator PCG; ``"direct"`` the per-mode Wiener closed form.
    """
    cfg = GrfConfig(n, sigma_noise, gamma, k0, False)
    s2 = sigma_noise ** 2
    nr = n // 2 + 1
    sqw_n = jnp.sqrt(cfg.herm_weight) / n

    k64 = _k_grid64(n)
    edges = band_edges(n, nbands)
    band_grid = np.searchsorted(edges, k64, side="right")
    band_idx = jnp.asarray(np.tile(band_grid.reshape(-1), 2), jnp.int32)
    # base spectrum per packed coordinate (θ=0 shape)
    P0 = jnp.tile(jnp.asarray(
        (k64 + k0) ** (-gamma), jnp.float32).reshape(-1), 2)

    def _C2(theta):
        """C per packed coordinate: P0 · exp(θ_{band})."""
        th = jnp.asarray(theta, jnp.float32)
        return P0 * jnp.exp(th[band_idx])

    if mesh is not None and mesh.field_axis is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        _packed_sh = NamedSharding(mesh.mesh, P(mesh.sims_axis,
                                                mesh.field_axis))

        def stage(Zt):
            return jax.lax.with_sharding_constraint(Zt, _packed_sh)
    else:
        stage = lambda a: a

    # CRN white split (problem.py): both hermitian whites are
    # θ-independent, so the muse loop hoists the RNG out of the
    # iteration — only the √C(θ) scaling re-runs per step
    def sample_white(key):
        k1, k2 = jax.random.split(key)
        return (hermitian_white_packed(k1, n),
                hermitian_white_packed(k2, n))

    def x_of_white(W, theta):
        ut, et = W
        return jnp.sqrt(_C2(theta)) * ut + sigma_noise * et, ut

    def sample_x_z(key, theta):
        return x_of_white(sample_white(key), theta)

    def log_like(xt, ut, theta):
        r = xt - jnp.sqrt(_C2(theta)) * ut
        return -0.5 * (jnp.sum(r * r) / s2 + jnp.sum(ut * ut))

    def log_prior(theta):
        th = jnp.asarray(theta)
        return -jnp.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(xt, ut, theta):
        """Analytic ∂θ log_like at the exact MAP — the all-positive
        packed Fourier score (grf.grad_theta rationale: the real-space
        form loses the residual's bits to f32 cancellation at high SNR),
        reduced per band in one segment_sum: ∂C/∂θ_b = C·1_{band b}, so
          g_b = ½ Σ_{c ∈ band b} x̃_c² C/(C+σ²)².
        """
        C2 = _C2(theta)
        q = 0.5 * xt * xt * C2 / (C2 + s2) ** 2
        return jax.ops.segment_sum(q, band_idx, num_segments=nbands)

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG, diagonal operator — zero FFTs (grf.zhat_cg)."""
        C2 = _C2(th_flat)[None]
        A = 1.0 + C2 / s2
        xs, Z0 = stage(xs), stage(Z0)
        b = jnp.sqrt(C2) * xs / s2
        r0 = b - A * Z0
        b_norm = jnp.linalg.norm(b, axis=-1)
        rel_tol = atol * jnp.sqrt(float(Z0.shape[1])) / jnp.maximum(
            b_norm, 1e-30)
        res = batched_cg(lambda V: A * V, None, Z0, tol=rel_tol,
                         maxiter=cg_maxiter, precond=lambda R: R / A,
                         r0=r0, z0=r0 / A, b_norm=b_norm)
        return res.x, {"converged": res.converged,
                       "failed": ~jnp.isfinite(res.r_norm),
                       "iterations": res.iterations, "g_norm": res.r_norm}

    def zhat_direct(xs, Z0, th_flat, atol):
        C2 = _C2(th_flat)[None]
        Z = jnp.sqrt(C2) * xs / (s2 + C2)
        B = Z.shape[0]
        return Z, {"converged": jnp.ones(B, bool),
                   "failed": jnp.zeros(B, bool)}

    custom = {"cg": zhat_cg, "direct": zhat_direct, "lbfgs": None}[solver]

    if theta_true is None:
        theta_true = jnp.zeros((nbands,))
    if x_obs is None:
        data_key = jax.random.PRNGKey(42) if data_key is None else data_key
        x_obs, _ = jax.jit(sample_x_z)(data_key,
                                       jnp.asarray(theta_true, jnp.float32))
    elif np.ndim(x_obs) == 2:
        xf = np.fft.rfft2(np.asarray(x_obs, np.float64))
        xf = xf * np.asarray(sqw_n, np.float64)
        x_obs = jnp.asarray(
            np.concatenate([xf.real.reshape(-1), xf.imag.reshape(-1)]),
            jnp.float32)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=custom,
                             grad_theta_log_like=grad_theta,
                             sample_white=sample_white,
                             x_of_white=x_of_white)
    prob.grf_config = cfg
    prob.nbands = nbands
    prob.band_edges = edges

    def unpack_field(vt):
        re, im = np.split(np.asarray(vt, np.float64), 2)
        zf = (re + 1j * im).reshape(n, nr) / np.asarray(sqw_n, np.float64)
        return np.fft.irfft2(zf, s=(n, n))

    prob.x_real = unpack_field(x_obs)
    prob.unpack_field = unpack_field
    prob.fft_grid = None            # the compiled step has no fft ops

    def h_precond(w, x, th_flat):
        """Exact A⁻¹ for implicit-diff get_H — diagonal in packed
        coordinates (the Pl hook, src/muse.jl:312)."""
        return w / (1.0 + _C2(th_flat) / s2)

    prob.suggested_h_precond = h_precond
    return prob


def bandpower_mle(x_obs, n: int, nbands: int, *, sigma_noise: float = 1.0,
                  gamma: float = 2.0, k0: float = 1.0,
                  iters: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Exact marginal MLE θ̂ and Fisher covariance for the bandpower model.

    Marginally x̂_k ~ CN(0, n²(C_k(θ)+σ²)); the bands are disjoint so the
    MLE decouples per band and the expected Fisher matrix is DIAGONAL:
      I_bb = ½ Σ_{k ∈ b} w_k C_k²/(C_k+σ²)².
    Solved by damped Fisher scoring in float64 (grf_marginal_mle
    machinery specialized to the band parameterization).  ``x_obs`` is
    the pixel-space (n, n) map.  Returns ``(θ̂ (nbands,), Σ (nbands,
    nbands) = I⁻¹)``; raises RuntimeError on non-convergence (a band
    consistent with zero amplitude runs to the θ→−∞ boundary).
    """
    cfg = GrfConfig(n, sigma_noise, gamma, k0, False)
    xf = np.fft.rfft2(np.asarray(x_obs, np.float64))
    p = (np.abs(xf) ** 2) / (n ** 2)
    w = np.asarray(cfg.herm_weight, np.float64)
    kk = _k_grid64(n)
    s2 = sigma_noise ** 2
    P0 = (kk + k0) ** (-gamma)
    edges = band_edges(n, nbands)
    band = np.searchsorted(edges, kk, side="right")
    onehot = (band[None] == np.arange(nbands)[:, None, None])  # (B, n, nr)

    th = np.zeros(nbands)
    for _ in range(iters):
        C = P0 * np.exp(th[band])
        D = C + s2
        d = onehot * C                      # ∂C/∂θ_b, stacked (disjoint)
        dn = 0.5 * np.einsum("kl,akl->a", w * (1.0 - p / D), d / D)
        I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
        step = -np.linalg.solve(I, dn)
        nrm = np.linalg.norm(step)
        if nrm > 1.0:
            step *= 1.0 / nrm
        th += step
        if nrm < 1e-12:
            break
    else:
        raise RuntimeError(
            f"bandpower_mle: Fisher scoring did not converge in {iters} "
            f"iterations (last |step| = {nrm:.3g}, θ = {th}); some band "
            "may be consistent with zero amplitude (θ→−∞ boundary).")
    C = P0 * np.exp(th[band])
    D = C + s2
    d = onehot * C
    I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
    return th, np.linalg.inv(I)
