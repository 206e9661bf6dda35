"""Gaussian-random-field model family — the large-latent benchmark configs.

BASELINE.md configs 4–5: infer power-spectrum hyper-parameters (amplitude,
optionally tilt) of a 2D Gaussian random field z from noisy observations
x = z + n.  The reference has no field models in-repo (its docs/paper
target CMB fields through user code); this family is the framework-native
equivalent, designed for batched accelerator execution:

  * **Whitened latent**: the solver's latent is the white field u ~ N(0,I),
    with z = S_θ u, S_θ = F⁻¹ diag(√C_k(θ)) F (FFT-diagonal).  The latent
    Hessian is I + S_θᵀS_θ/σ² — bounded condition number, so iterative MAP
    solves converge in tens of iterations regardless of the spectrum.
  * **Solver choice per problem**: ``solver="cg"`` (default) runs the MAP
    as a batched conjugate-gradient solve (the conditional is Gaussian —
    CG is optimal and needs no L-BFGS history: O(1) memory per lane at
    1024²) in packed-spectral coordinates, where the normal-equation
    operator is diagonal and the CG loop is FFT-free (see ``zhat_cg``);
    ``"lbfgs"`` exercises the generic path; ``"direct"`` uses the
    Fourier-diagonal closed form û = √C x̂/(σ²+C) (oracle for tests).
  * FFTs via jnp.fft (mesh-aware under GSPMD); elementwise Fourier ops
    fuse into the surrounding kernels.

Closed forms used as test oracles (stronger than anything the reference
tests): marginally x̂_k ~ N(0, (C_k(θ)+σ²)·n²/2 per re/im dof), so the
exact marginal MLE θ̂ and its Fisher σθ are computable by 1D optimization —
MUSE must match them for this Gaussian problem (MUSE is exact in the
Gaussian limit, arXiv:2112.09354 §2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..adapters.simple import SimpleMuseProblem
from ..ops.cg import batched_cg

__all__ = ["GrfConfig", "grf_problem", "grf_spectral_problem",
           "grf_field_problem", "grf_marginal_mle", "hermitian_white_packed",
           "pack_rfft2", "pack_weights", "spectrum_quadform_reference"]


_HERM_COEFF_CACHE = {}


def _herm_white_coeffs(n: int):
    """Mask coefficients for drawing pack(rfft2(N(0,1)^{n×n})) by indexing.

    Per packed coordinate of a hermitian white spectrum: generic modes
    (herm weight 2) are iid N(0,1); in the two self-mirrored columns
    (0 and n/2) rows r and n−r are conjugate duplicates (re copied, im
    negated, each N(0,1/2)); the four self-conjugate modes are real
    N(0,1).  Encoded as a mask-weighted combination of a normal draw and
    its row-flip r→(n−r) mod n — no FFT at all.  Cached per n (trace-time
    constants).
    """
    if n in _HERM_COEFF_CACHE:
        return _HERM_COEFF_CACHE[n]
    nr = n // 2 + 1
    a = np.ones((n, nr), np.float32)         # own-draw coefficient (re)
    b = np.zeros((n, nr), np.float32)        # flipped-draw coefficient
    c = np.ones((n, nr), np.float32)         # own-draw coefficient (im)
    d = np.zeros((n, nr), np.float32)
    self_rows = [0] + ([n // 2] if n % 2 == 0 else [])
    spec_cols = [0] + ([nr - 1] if n % 2 == 0 else [])
    for col in spec_cols:
        for r in range(n):
            if r in self_rows:
                a[r, col], c[r, col] = 1.0, 0.0      # real mode
            elif r < n - r:
                a[r, col] = c[r, col] = 1.0 / np.sqrt(2.0)
            else:                                    # mirror of n−r
                a[r, col] = c[r, col] = 0.0
                b[r, col] = 1.0 / np.sqrt(2.0)
                d[r, col] = -1.0 / np.sqrt(2.0)
    # cache NUMPY arrays: jnp constants created inside one jit trace must
    # not leak into another (UnexpectedTracerError); jnp.asarray at use
    # site re-binds them as per-trace constants for free
    out = (a, b, c, d)
    _HERM_COEFF_CACHE[n] = out
    return out


def hermitian_white_packed(key, n: int) -> jnp.ndarray:
    """Draw pack(rfft2(white n×n field))-distributed noise FFT-free.

    Distributionally identical to ``pack(rfft2(N(0,1)^{n×n}))`` (the
    isometric packing of a white field's spectrum) but constructed by
    indexing — the sampler behind ``grf_spectral_problem``'s marginal/direct modes
    and the bandpower family.  Uses 2 key splits and two (n, n//2+1)
    normal draws.
    """
    nr = n // 2 + 1
    a, b, c, d = (jnp.asarray(v) for v in _herm_white_coeffs(n))
    kg, kh = jax.random.split(key)
    g = jax.random.normal(kg, (n, nr))
    h = jax.random.normal(kh, (n, nr))

    def flip(v):                              # r → (n − r) mod n
        return jnp.roll(v[::-1], 1, axis=0)

    re = a * g + b * flip(g)
    im = c * h + d * flip(h)
    return jnp.concatenate([re.reshape(-1), im.reshape(-1)])


class GrfConfig:
    """Static configuration for a GRF amplitude(/tilt) problem."""

    def __init__(self, n: int = 256, sigma_noise: float = 1.0,
                 gamma: float = 2.0, k0: float = 1.0,
                 infer_tilt: bool = False):
        self.n = n
        self.sigma_noise = sigma_noise
        self.gamma = gamma
        self.k0 = k0
        self.infer_tilt = infer_tilt
        self.fft_mode = "fft"
        self._dft_plan = None
        ky = np.fft.fftfreq(n) * n
        kx = np.fft.rfftfreq(n) * n
        self.k = jnp.asarray(np.hypot(ky[:, None], kx[None, :]),
                             jnp.float32)
        # multiplicity of each rfft2 mode when summing over the full
        # hermitian spectrum (columns 0 and n/2 appear once, others twice)
        w = np.full((n, n // 2 + 1), 2.0)
        w[:, 0] = 1.0
        if n % 2 == 0:
            w[:, -1] = 1.0
        self.herm_weight = jnp.asarray(w, jnp.float32)

    def set_fft_mode(self, mode: str):
        """Pick the 2D-transform implementation: ``"fft"`` (jnp.fft, the
        default) or ``"matmul"`` (einsum DFT, ops/dft.py) — the fallback
        for field-sharded layouts XLA's fft thunk rejects (CPU backend
        under a 2-axis GSPMD partition)."""
        if mode not in ("fft", "matmul"):
            raise ValueError(f"fft_mode must be 'fft'|'matmul', got {mode!r}")
        self.fft_mode = mode
        if mode == "matmul":
            from ..ops.dft import plan_dft2
            self._dft_plan = plan_dft2(self.n)
        else:
            self._dft_plan = None

    def rfft2(self, u):
        """Batched 2D real FFT over the trailing axes (mode-dispatched)."""
        if self._dft_plan is not None:
            return self._dft_plan.rfft2(u)
        return jnp.fft.rfft2(u, axes=(-2, -1))

    def irfft2(self, v):
        """Inverse of :meth:`rfft2` for hermitian-consistent spectra."""
        if self._dft_plan is not None:
            return self._dft_plan.irfft2(v)
        return jnp.fft.irfft2(v, s=(self.n, self.n), axes=(-2, -1))

    def spectrum(self, theta) -> jnp.ndarray:
        """C_k(θ) = e^{θ₀} (k+k0)^{-(γ+θ₁)} on the rfft grid."""
        th = jnp.atleast_1d(jnp.asarray(theta))
        log_amp = th[0]
        gamma = self.gamma + (th[1] if self.infer_tilt else 0.0)
        return jnp.exp(log_amp) * (self.k + self.k0) ** (-gamma)

    def apply_sqrtC(self, u, theta):
        """z = S_θ u = F⁻¹(√C_k · F u) — real symmetric operator."""
        return self.irfft2(jnp.sqrt(self.spectrum(theta)) * self.rfft2(u))

    def apply_C(self, u, theta):
        return self.irfft2(self.spectrum(theta) * self.rfft2(u))


def grf_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                sigma_noise: float = 1.0, gamma: float = 2.0,
                k0: float = 1.0, infer_tilt: bool = False,
                theta_true=None, data_key=None, x_obs=None,
                solver: str = "cg", cg_maxiter: int = 200,
                prior_std: float = 3.0, mesh=None,
                fft_mode: str = "auto") -> SimpleMuseProblem:
    """Build the GRF MUSE problem (see module docstring).

    With a 2-axis ``mesh`` (sims × field), the CG solve keeps its
    (packed-spectral) state field-sharded and stages the entry/exit 2D
    transforms:

      * ``fft_mode="fft"``: reshard→local-FFT→reshard — the field is
        gathered per-sim for the (local) 2D FFT and re-scattered for the
        elementwise spectrum/CG updates.  Works where the backend's fft
        op accepts GSPMD-partitioned layouts (the GPU: ``chip_smoke.py
        --multi`` runs it on a sims × field mesh).
      * ``fft_mode="matmul"``: the transform is the einsum DFT
        (ops/dft.py) and the grid stays ROW-SHARDED over the field axis
        through it — GSPMD partitions the contractions with
        collectives, and no backend fft thunk is involved.
      * ``"auto"`` (default): ``"matmul"`` when the mesh has a field
        axis on the CPU backend (whose fft thunk rejects partitioned
        layouts — fft_thunk.cc:167 RET_CHECK, reproduced), else
        ``"fft"``.
    """
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    ntheta = 2 if cfg.infer_tilt else 1

    has_field_axis = mesh is not None and mesh.field_axis is not None
    if fft_mode == "auto":
        fft_mode = ("matmul" if has_field_axis
                    and jax.default_backend() == "cpu" else "fft")
    if config is not None and fft_mode != cfg.fft_mode:
        # the problem's closures capture cfg, so resolving a different
        # transform mode must not retroactively switch a caller-shared
        # config (and any earlier problem built from it) — copy instead
        import copy
        cfg = copy.copy(cfg)
    cfg.set_fft_mode(fft_mode)

    if has_field_axis:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if fft_mode == "matmul":
            # einsum DFT tolerates (indeed exploits) a sharded grid: keep
            # the rows sharded over the field axis through the transform
            _full = NamedSharding(mesh.mesh,
                                  P(mesh.sims_axis, mesh.field_axis, None))
        else:
            _full = NamedSharding(mesh.mesh, P(mesh.sims_axis, None, None))
        _flat = NamedSharding(mesh.mesh, P(mesh.sims_axis, mesh.field_axis))
        _lane = NamedSharding(mesh.mesh, P(mesh.sims_axis, None))

        def stage_full(U):     # (B, n, n): grid layout for the transform
            return jax.lax.with_sharding_constraint(U, _full)

        def stage_packed(Zt):  # (B, 2·n·nr): packed-spectral CG state —
            # elementwise ops only, so scatter it over the field axis too
            return jax.lax.with_sharding_constraint(Zt, _flat)

        def stage_lane(Zf):    # (B, n²): sims-sharded only (solver output)
            return jax.lax.with_sharding_constraint(Zf, _lane)
    else:
        stage_full = stage_packed = stage_lane = lambda a: a

    # CRN white split (problem.py ``sample_white``/``x_of_white``): the
    # pixel whites are θ-independent, so the muse loop hoists the RNG out
    # of the outer iteration (the θ-dependent √C FFT scaling stays).
    def sample_white(key):
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, (n, n)),
                jax.random.normal(k2, (n, n)))

    def x_of_white(W, theta):
        u, e = W
        return cfg.apply_sqrtC(u, theta) + cfg.sigma_noise * e, u

    def sample_x_z(key, theta):
        return x_of_white(sample_white(key), theta)

    def log_like(x, u, theta):
        r = x - cfg.apply_sqrtC(u, theta)
        return -0.5 * (jnp.sum(r * r) / s2 + jnp.sum(u * u))

    def log_prior(theta):
        th = jnp.atleast_1d(jnp.asarray(theta))
        return -jnp.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(x, u, theta):
        """Analytic ∂θ log_like in Fourier space (∇θ_logLike override).

        Per rfft mode, with r̂ = x̂ − √C û and p = |x̂|²/n²:
          g_α = ½/σ² Σ w Re[r̂·conj(∂_α√C·û)]/n²
        which, *at the exact MAP* û = √C x̂/(C+σ²), collapses to the
        cancellation-free all-positive form
          g_α = ½ Σ w p ∂_αC/(C+σ²)²            (∂C/∂θ₀ = C;
                                                 ∂C/∂θ₁ = −log(k+k₀)C).

        Why this form: at high SNR (σ² ≪ C) the real-space product
        rᵀSu/σ² loses the residual's significant bits to f32 FFT rounding
        — measured per-sim score error std 160 vs true scatter 73 at
        1024², inflating J ~4-40×.  The Fourier form has per-mode
        relative error ~ε and no cancellation.  It assumes the latent
        solve converged to the Wiener MAP (exact for solver="direct",
        and for "cg" to solver tolerance).
        """
        C = cfg.spectrum(theta)
        p = jnp.abs(cfg.rfft2(x)) ** 2 / (n * n)
        w = cfg.herm_weight
        denom = (C + s2) ** 2
        g0 = 0.5 * jnp.sum(w * p * C / denom)
        if not cfg.infer_tilt:
            return g0 if jnp.ndim(theta) == 0 else jnp.array([g0])
        g1 = 0.5 * jnp.sum(w * p * (-jnp.log(cfg.k + cfg.k0)) * C / denom)
        return jnp.array([g0, g1])

    # --- batched MAP solvers over the whitened latent ----------------- #
    # normal equations: (I + S_θᵀS_θ/σ²) u = S_θᵀ x / σ², S_θᵀS_θ = C_k

    def _theta_of(th_flat):
        return th_flat if ntheta > 1 else th_flat[0]

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG in PACKED-SPECTRAL coordinates.

        The normal-equation operator A = I + SᵀS/σ² is exactly diagonal
        per Fourier mode (SᵀS = C_k), so the CG runs on the isometric
        packing ũ = pack(√w/n · rfft2(u)) (Parseval with hermitian
        column weights — the lensing VarPro coordinates): every matvec
        and preconditioner apply is a pointwise multiply, and the only
        transforms in the whole solve are rfft2(x), rfft2(Z0) at entry
        and one irfft2 at exit.  vs the pixel-space CG this removes ALL
        in-loop FFT passes (4 per iteration) plus the stacked spectral
        init — the 1024² muse step drops from ~9 FFT-sized kernels to 5.

        CG in exact arithmetic is invariant under an isometric change of
        basis, and the packed residual norm equals the pixel-space
        gradient norm by Parseval, so the stopping semantics are
        unchanged.  Consistency caveat: the diagonal operator preserves
        the hermitian-consistent subspace only because the spectrum is
        radial (C_k = C_|k|, reflection-symmetric rows) — true for every
        GrfConfig spectrum by construction.
        """
        th = _theta_of(th_flat)
        B = xs.shape[0]
        C = cfg.spectrum(th)
        nr = n // 2 + 1
        sqw_n = jnp.sqrt(cfg.herm_weight) / n   # isometric pack scale

        def _pack(zf):                 # (B, n, nr) complex → (B, 2·n·nr)
            zs = zf * sqw_n
            return jnp.concatenate(
                [zs.real.reshape(B, -1), zs.imag.reshape(B, -1)], -1)

        def _unpack(zt):               # inverse of _pack
            re, im = jnp.split(zt, 2, axis=-1)
            return (re + 1j * im).reshape(B, n, nr) / sqw_n

        Adiag = 1.0 + C / s2
        A_packed = jnp.tile(Adiag.reshape(-1), 2)[None]   # (1, 2·n·nr)

        xhat = cfg.rfft2(stage_full(xs))
        u0hat = cfg.rfft2(stage_full(Z0.reshape(B, n, n)))
        bhat = jnp.sqrt(C) * xhat / s2
        bt = stage_packed(_pack(bhat))
        u0t = stage_packed(_pack(u0hat))
        r0 = bt - A_packed * u0t
        z0 = r0 / A_packed
        b_norm = jnp.linalg.norm(bt, axis=-1)   # = Parseval ‖b‖ in pixels
        # The CG residual r = b − Au equals −∇u(−log_like) exactly (in
        # packed coordinates, by the isometry), so the stopping rule must
        # match the solver-wide ∇z tolerance semantics: an ABSOLUTE
        # gradient norm (reference ∇z_logLike_atol, an L∞ bound).
        # Convert atol·√N (L∞→L2 envelope) into the per-lane relative
        # tolerance batched_cg expects.  A relative 1e-2 here would be
        # off by ‖b‖ ~ 10⁵ at high SNR and silently bias the score
        # (measured: σθ wrong by 5× at σ_noise=0.01 before this).
        rel_tol = atol * jnp.sqrt(float(Z0.shape[1])) / jnp.maximum(
            b_norm, 1e-30)
        res = batched_cg(lambda V: A_packed * V, None,
                         u0t, tol=rel_tol, maxiter=cg_maxiter,
                         precond=lambda R: R / A_packed,
                         r0=r0, z0=z0, b_norm=b_norm)
        aux = {"converged": res.converged,
               "failed": ~jnp.isfinite(res.r_norm),
               "iterations": res.iterations, "g_norm": res.r_norm}
        # hand the MAP back pixel-space and sims-sharded so downstream
        # per-lane FFTs (θ-gradients of log_like) stay device-local
        U = cfg.irfft2(_unpack(res.x))
        return stage_lane(U.reshape(B, -1)), aux

    def zhat_direct(xs, Z0, th_flat, atol):
        th = _theta_of(th_flat)
        C = cfg.spectrum(th)

        def one(x):
            xf = cfg.rfft2(x)
            uf = jnp.sqrt(C) * xf / (s2 + C)
            return cfg.irfft2(uf).reshape(-1)

        Z = jax.vmap(one)(xs)
        B = Z.shape[0]
        return Z, {"converged": jnp.ones(B, bool),
                   "failed": jnp.zeros(B, bool)}

    custom = {"cg": zhat_cg, "direct": zhat_direct, "lbfgs": None}[solver]

    if theta_true is None:
        theta_true = jnp.zeros((ntheta,)) if cfg.infer_tilt else 0.0
    if x_obs is None:
        data_key = jax.random.PRNGKey(42) if data_key is None else data_key
        x_obs, _ = sample_x_z(data_key, theta_true)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=custom,
                             grad_theta_log_like=grad_theta,
                             sample_white=sample_white,
                             x_of_white=x_of_white)
    prob.grf_config = cfg
    # matmul mode has no backend-fft op, so the fused-FFT integrity
    # self-check does not apply there
    prob.fft_grid = n if cfg.fft_mode == "fft" else None

    def h_precond(w, x, th_flat):
        """Ready-made CG preconditioner for implicit-diff get_H (the Pl
        hook, src/muse.jl:312): for the whitened latent the z-Hessian is
        EXACTLY Fourier-diagonal, A = −∇z²logLike = I + C_θ/σ², so this
        is the exact inverse and the per-column CG solves converge in
        O(1) iterations.  Pass as ``get_H(..., implicit_diff=True,
        implicit_diff_precond=prob.suggested_h_precond)``."""
        C = cfg.spectrum(_theta_of(th_flat))
        return cfg.irfft2(cfg.rfft2(w.reshape(n, n))
                          / (1.0 + C / s2)).reshape(-1)

    prob.suggested_h_precond = h_precond
    return prob


def grf_spectral_problem(config: Optional[GrfConfig] = None, *,
                         n: int = 256, sigma_noise: float = 1.0,
                         gamma: float = 2.0, k0: float = 1.0,
                         infer_tilt: bool = False, theta_true=None,
                         data_key=None, x_obs=None, solver: str = "cg",
                         cg_maxiter: int = 200, prior_std: float = 3.0,
                         mesh=None, noise: str = "marginal"
                         ) -> SimpleMuseProblem:
    """The whitened GRF problem with x AND z in packed-spectral coords.

    Same statistical model as :func:`grf_problem` — the observation and
    the white latent are carried in the isometric packing
    ``ṽ = pack(√w/n · rfft2(v))`` end-to-end, exploiting that x/z are
    opaque pytrees to the solver machinery.  Consequences:

      * ``noise="marginal"`` (default): hermitian white draws by
        indexing (mask + row-flip, ``hermitian_white_packed``) in the
        marginal-x/conditional-u factorization of the joint law — the
        ENTIRE muse iteration is FFT-free, and programs that consume
        only x (the muse iteration: every MUSE estimator is a
        functional of x alone) dead-code-eliminate the conditional
        u-draw, halving the RNG work that dominates the 1024² step.
        ``noise="direct"`` is the same indexed sampler in the
        conventional x = √C·u + σ·e factorization (both draws always
        live).  ``noise="fft"`` draws the noise as rfft2 of pixel
        normals — 2 FFT passes per iteration, but bit-compatible with
        the pixel representation's CRN stream (same key ⇒ same sim),
        which the cross-representation parity tests pin.

        Two caveats of ``"marginal"``: (1) the returned z is a
        CONDITIONAL draw u|x, not the u that "generated" x — correct
        under the joint law, and inside this framework it is consumed
        only as a MAP warm start (src/muse.jl:511-512), but a
        ``custom_zhat`` or external consumer that treats the returned z
        as the truth paired with x by the direct factorization (or that
        relies on the u-draw being dead code for speed) must account
        for this; (2) each ``noise`` mode is a DIFFERENT functional of
        the PRNG key, so the round-3 default change direct→marginal
        broke same-key sim/x_obs reproducibility with earlier versions
        — pass ``noise="direct"`` to recover the old CRN stream.
      * The MAP solve, the analytic θ-score, the implicit-H
        preconditioner, warm starts, and all solver state are FFT-FREE
        elementwise/reduction work in both modes: Σ_c x̃_c² over packed
        coordinates equals Σ_k w|x̂_k|²/n² (Parseval), so every
        density/score reduces to diagonal arithmetic.  A full MUSE
        iteration runs 0 (marginal/direct) / 2 (fft) FFT-sized kernels vs the
        pixel representation's 5 (vs 9 in round 2).
      * Under a mesh the packed axis shards freely (elementwise ops
        partition with zero collectives until the final score psum).

    The packing covers the full rfft2 storage, so packed space has ~2n
    redundant coordinates (hermitian-pair duplicates in columns 0 and
    n/2); all operators here are diagonal with reflection-symmetric
    (radial) spectra, so consistent states stay consistent and the
    unconstrained per-coordinate optimum coincides with the constrained
    one — generic jax.grad solvers are safe on this representation.

    ``x_obs`` may be the real-space field (converted host-side via
    numpy) or an already-packed vector; ``prob.x_real`` always holds the
    pixel-space data for closed-form oracles (grf_marginal_mle).
    Reference anchor: same role as grf_problem (BASELINE configs 4-5);
    no reference analog for the representation (SURVEY §2.2).
    """
    if noise not in ("marginal", "direct", "fft"):
        raise ValueError(
            f"noise must be 'marginal'|'direct'|'fft', got {noise!r}")
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    ntheta = 2 if cfg.infer_tilt else 1
    nr = n // 2 + 1                      # packed length L = 2·n·nr
    sqw_n = jnp.sqrt(cfg.herm_weight) / n
    logk_tiled = jnp.tile(jnp.log(cfg.k + cfg.k0).reshape(-1), 2)

    def _theta_of(th_flat):
        th_flat = jnp.atleast_1d(jnp.asarray(th_flat))
        return th_flat if ntheta > 1 else th_flat[0]

    def _C2(theta):
        """Spectrum per packed coordinate: C_k tiled over (re, im)."""
        return jnp.tile(cfg.spectrum(theta).reshape(-1), 2)

    def _pack1(zf):                       # (n, nr) complex → (L,)
        zs = zf * sqw_n
        return jnp.concatenate([zs.real.reshape(-1), zs.imag.reshape(-1)])

    def pack_field(v):
        """Host/device helper: real (n, n) field → packed (L,)."""
        return _pack1(jnp.fft.rfft2(v))

    def unpack_field(vt):
        """Packed (L,) → real (n, n) field (numpy, host-side safe)."""
        re, im = np.split(np.asarray(vt, np.float64), 2)
        zf = (re + 1j * im).reshape(n, nr) / np.asarray(sqw_n, np.float64)
        return np.fft.irfft2(zf, s=(n, n))

    if mesh is not None and mesh.field_axis is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        _packed_sh = NamedSharding(mesh.mesh, P(mesh.sims_axis,
                                                mesh.field_axis))

        def stage(Zt):
            return jax.lax.with_sharding_constraint(Zt, _packed_sh)
    else:
        stage = lambda a: a

    # ---- packed white noise ---------------------------------------- #
    # noise="direct": pack(rfft2(white))-distributed draws by indexing —
    # no FFT at all (see hermitian_white_packed)
    def _herm_white(key):
        return hermitian_white_packed(key, n)

    if noise == "marginal":
        # Marginal-x / conditional-u factorization of the SAME joint law:
        #   x̃ ~ N(0, C+σ²)                    (one herm draw)
        #   ũ|x̃ ~ N(√C x̃/(C+σ²), σ²/(C+σ²))   (a second herm draw)
        # — jointly Gaussian with Var(x̃)=C+σ², Var(ũ)=1, Cov=√C: exactly
        # the (x, u) distribution of the other modes.  Payoff: every MUSE
        # estimator is a functional of x alone (the truth z only seeds
        # warm starts, src/muse.jl:511-512), so in programs that drop ũ —
        # the muse iteration itself — XLA dead-code-eliminates the second
        # draw and the sampling work HALVES (the RNG is the dominant
        # kernel of the keyed 1024²×100 step).
        def sample_white(key):
            k1, k2 = jax.random.split(key)
            return _herm_white(k1), _herm_white(k2)

        def x_of_white(W, theta):
            w1, w2 = W
            C2 = _C2(theta)
            D = C2 + s2
            xt = jnp.sqrt(D) * w1
            ut = (jnp.sqrt(C2) / D) * xt + jnp.sqrt(s2 / D) * w2
            return xt, ut
    elif noise == "direct":
        def sample_white(key):
            k1, k2 = jax.random.split(key)
            return _herm_white(k1), _herm_white(k2)

        def x_of_white(W, theta):
            ut, et = W
            xt = jnp.sqrt(_C2(theta)) * ut + cfg.sigma_noise * et
            return xt, ut
    else:
        def sample_white(key):
            # the rfft2 passes are θ-independent too: hoisting removes
            # the iteration's only FFT-sized kernels in this mode
            k1, k2 = jax.random.split(key)
            return (_pack1(jnp.fft.rfft2(jax.random.normal(k1, (n, n)))),
                    _pack1(jnp.fft.rfft2(jax.random.normal(k2, (n, n)))))

        def x_of_white(W, theta):
            ut, nt = W
            xt = jnp.sqrt(_C2(theta)) * ut + cfg.sigma_noise * nt
            return xt, ut

    def sample_x_z(key, theta):
        # single source of truth: the CRN stream of every noise mode is
        # exactly the white split composed (problem.py contract)
        return x_of_white(sample_white(key), theta)

    def log_like(xt, ut, theta):
        r = xt - jnp.sqrt(_C2(theta)) * ut
        return -0.5 * (jnp.sum(r * r) / s2 + jnp.sum(ut * ut))

    def log_prior(theta):
        th = jnp.atleast_1d(jnp.asarray(theta))
        return -jnp.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(xt, ut, theta):
        """Analytic ∂θ log_like at the exact MAP, all-positive packed
        form: Σ_c x̃_c²·∂C/(C+σ²)² — the pixel model's Fourier score
        (grf_problem.grad_theta) with the hermitian weights absorbed
        into the packing."""
        C2 = _C2(theta)
        q = xt * xt / (C2 + s2) ** 2
        g0 = 0.5 * jnp.sum(q * C2)
        if not cfg.infer_tilt:
            return g0 if jnp.ndim(theta) == 0 else jnp.array([g0])
        g1 = 0.5 * jnp.sum(q * (-logk_tiled) * C2)
        return jnp.array([g0, g1])

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG, diagonal operator — zero FFTs (module docstring)."""
        C2 = _C2(_theta_of(th_flat))[None]
        A = 1.0 + C2 / s2
        xs, Z0 = stage(xs), stage(Z0)
        b = jnp.sqrt(C2) * xs / s2
        r0 = b - A * Z0
        b_norm = jnp.linalg.norm(b, axis=-1)
        # same stopping semantics as grf_problem.zhat_cg: absolute
        # gradient sup-norm atol → per-lane relative L2 tolerance
        rel_tol = atol * jnp.sqrt(float(Z0.shape[1])) / jnp.maximum(
            b_norm, 1e-30)
        res = batched_cg(lambda V: A * V, None, Z0, tol=rel_tol,
                         maxiter=cg_maxiter,
                         precond=lambda R: R / A,
                         r0=r0, z0=r0 / A, b_norm=b_norm)
        return res.x, {"converged": res.converged,
                       "failed": ~jnp.isfinite(res.r_norm),
                       "iterations": res.iterations, "g_norm": res.r_norm}

    def zhat_direct(xs, Z0, th_flat, atol):
        C2 = _C2(_theta_of(th_flat))[None]
        Z = jnp.sqrt(C2) * xs / (s2 + C2)
        B = Z.shape[0]
        return Z, {"converged": jnp.ones(B, bool),
                   "failed": jnp.zeros(B, bool)}

    custom = {"cg": zhat_cg, "direct": zhat_direct, "lbfgs": None}[solver]

    if theta_true is None:
        theta_true = jnp.zeros((ntheta,)) if cfg.infer_tilt else 0.0
    if x_obs is None:
        data_key = jax.random.PRNGKey(42) if data_key is None else data_key
        x_obs, _ = jax.jit(sample_x_z)(data_key, theta_true)
    elif np.ndim(x_obs) == 2:
        # pixel-space data → packed, host-side in float64 numpy
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
    prob.x_real = unpack_field(x_obs)     # for closed-form oracles
    prob.pack_field = pack_field
    prob.unpack_field = unpack_field
    # noise="fft": the only backend-fft ops left are the two sampling
    # rfft2 passes — keep the fused-FFT integrity check armed for them;
    # noise="direct": the compiled step has NO fft ops to validate
    prob.fft_grid = n if noise == "fft" else None

    def h_precond(w, x, th_flat):
        """Exact A⁻¹ for implicit-diff get_H — diagonal in packed
        coordinates, so (unlike grf_problem's) FFT-free."""
        return w / (1.0 + _C2(_theta_of(th_flat)) / s2)

    prob.suggested_h_precond = h_precond
    return prob


def pack_rfft2(z: jnp.ndarray) -> jnp.ndarray:
    """(…, n, n) real field → (…, n, 2m) packed rfft2 spectrum, real
    parts in ``[..., :m]`` and imaginary parts in ``[..., m:]``."""
    zf = jnp.fft.rfft2(z, axes=(-2, -1))
    return jnp.concatenate([zf.real, zf.imag], axis=-1)


def pack_weights(a: jnp.ndarray) -> jnp.ndarray:
    """(n, m) per-mode weights → (n, 2m) matching the packed layout."""
    return jnp.concatenate([a, a], axis=-1)


def spectrum_quadform_reference(z_ri, invCw2):
    """Σ_k w_k|ẑ_k|²/C_k per lane: (B, n, 2m) packed spectra
    (:func:`pack_rfft2`) against (n, 2m) packed w/C
    (:func:`pack_weights`) → (B,).  Written as an elementwise product and
    a sum, not an einsum: XLA then fuses the value and its z-gradient
    into one pass over the spectra, where the einsum lowers to a matrix
    product over a materialized z² (PERF.md, bring-up findings)."""
    return jnp.sum(z_ri * z_ri * invCw2, axis=(-2, -1))


def grf_field_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true: float = 0.0,
                      data_key=None, x_obs=None,
                      prior_std: float = 3.0) -> SimpleMuseProblem:
    """Non-whitened GRF variant: the latent IS the field z ~ N(0, F⁻¹CF).

    Same marginal model for x as :func:`grf_problem` (z = S_θ u), so both
    parameterizations must deliver the same θ̂ — a parameterization-
    invariance oracle.  The Fourier-space prior term is the packed
    spectrum quadform (:func:`spectrum_quadform_reference`):

      log p(z|θ) = −½ [ Σ_k w_k|ẑ_k|²/C_k / n² + Σ_k w_k log C_k ] + const

    The MAP is the Wiener filter ẑ_k = C x̂_k/(C+σ²) (Fourier-diagonal
    closed form) — with explicit C this latent is badly conditioned for
    iterative solvers, which is exactly why the primary model family uses
    the whitened parameterization (module docstring).
    """
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, False)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2

    def sample_x_z(key, theta):
        k1, k2 = jax.random.split(key)
        u = jax.random.normal(k1, (n, n))
        z = cfg.apply_sqrtC(u, theta)
        x = z + cfg.sigma_noise * jax.random.normal(k2, (n, n))
        return x, z

    def log_like(x, z, theta):
        C = cfg.spectrum(theta)
        invCw2 = pack_weights(cfg.herm_weight / C)
        quad = spectrum_quadform_reference(pack_rfft2(z)[None],
                                           invCw2)[0] / n ** 2
        logdet = jnp.sum(cfg.herm_weight * jnp.log(C))
        r = x - z
        return -0.5 * (jnp.sum(r * r) / s2 + quad + logdet)

    def log_prior(theta):
        th = jnp.atleast_1d(jnp.asarray(theta))
        return -jnp.sum(th ** 2) / (2 * prior_std ** 2)

    def zhat_wiener(xs, Z0, th_flat, atol):
        C = cfg.spectrum(th_flat[0])

        def one(x):
            xf = jnp.fft.rfft2(x)
            return jnp.fft.irfft2(C * xf / (C + s2), s=(n, n)).reshape(-1)

        Z = jax.vmap(one)(xs)
        B = Z.shape[0]
        return Z, {"converged": jnp.ones(B, bool),
                   "failed": jnp.zeros(B, bool)}

    if x_obs is None:
        data_key = jax.random.PRNGKey(42) if data_key is None else data_key
        x_obs, _ = sample_x_z(data_key, theta_true)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=zhat_wiener)
    prob.grf_config = cfg
    prob.fft_grid = n
    return prob


def grf_marginal_mle(x_obs, cfg: GrfConfig, theta0=0.0,
                     iters: int = 200) -> Tuple[float, float]:
    """Exact marginal MLE θ̂ and Fisher width(s) for the GRF problem.

    Marginally x̂_k ~ CN(0, n²(C_k(θ)+σ²)) per rfft mode (hermitian
    weights w_k), so with p_k = |x̂_k|²/n² and d_α = ∂C/∂θ_α:
      ∂ nll/∂θ_α = ½ Σ w_k (d_α/(C+σ²)) (1 − p_k/(C+σ²))
      I_αβ       = ½ Σ w_k d_α d_β / (C+σ²)²     (expected Fisher)
    Solved by damped Fisher-scoring Newton in float64 — stable at any
    resolution (a finite-difference curvature is hopeless at 1024²:
    nll ~ 10⁶ and the usable information can be O(1)).

    Amplitude-only configs return ``(θ̂, 1/√I)`` as floats; with
    ``cfg.infer_tilt`` the θ is the 2-vector (log-amplitude, tilt) with
    ``∂C/∂θ₁ = −log(k+k₀)·C`` and the return is ``(θ̂ (2,), Σ (2,2))``
    where Σ = I⁻¹ — the oracle for MUSE's full vector-θ covariance
    assembly (the Fisher cross-term I₀₁ is negative, so the two
    *estimates* are strongly positively correlated — ρ ≈ +0.94 at n=32
    — and this pins the off-diagonal of Σ⁻¹ = HᵀJ⁻¹H too).  MUSE is
    exact for this Gaussian problem (arXiv:2112.09354 §2).

    Raises ``RuntimeError`` if Fisher scoring has not converged after
    ``iters`` damped steps — e.g. weak-signal data whose marginal MLE
    runs to the θ→−∞ boundary (amplitude indistinguishable from 0), in
    which case θ̂ and the Fisher width are meaningless.
    """
    xf = np.fft.rfft2(np.asarray(x_obs, np.float64))
    p = (np.abs(xf) ** 2) / (cfg.n ** 2)
    w = np.asarray(cfg.herm_weight, np.float64)
    kk = np.asarray(cfg.k, np.float64)
    s2 = cfg.sigma_noise ** 2
    logk = np.log(kk + cfg.k0)
    nth = 2 if cfg.infer_tilt else 1

    th = np.zeros(nth)
    th[:] = np.atleast_1d(np.asarray(theta0, np.float64))[:nth]
    for _ in range(iters):
        gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
        C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
        D = C + s2
        # stacked ∂C/∂θ_α over modes: (nth, n, nr)
        d = np.stack([C, -logk * C][:nth])
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
            f"grf_marginal_mle: Fisher scoring did not converge in "
            f"{iters} iterations (last |step| = {nrm:.3g}, θ = {th}); "
            "the marginal MLE may be at the θ→−∞ boundary (data "
            "consistent with zero signal amplitude).")
    gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
    C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
    D = C + s2
    d = np.stack([C, -logk * C][:nth])
    I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
    if not cfg.infer_tilt:
        return float(th[0]), float(1.0 / np.sqrt(I[0, 0]))
    return th, np.linalg.inv(I)
