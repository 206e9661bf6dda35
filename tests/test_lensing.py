"""Lensing-style model tests — the nonlinear large-field config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muse_tpu import check_self_consistency, muse
from muse_tpu.models.lensing import (bilinear_warp, gradient_field,
                                     lensing_problem, taylor_lens)


class TestWarpOps:
    def test_bilinear_identity(self):
        f = jax.random.normal(jax.random.PRNGKey(0), (8, 8))
        zero = jnp.zeros((8, 8))
        np.testing.assert_allclose(np.asarray(bilinear_warp(f, zero, zero)),
                                   np.asarray(f), atol=1e-6)

    def test_bilinear_integer_shift_is_roll(self):
        f = jax.random.normal(jax.random.PRNGKey(0), (8, 8))
        one = jnp.ones((8, 8))
        zero = jnp.zeros((8, 8))
        np.testing.assert_allclose(
            np.asarray(bilinear_warp(f, one, zero)),
            np.asarray(jnp.roll(f, -1, axis=1)), atol=1e-6)

    def test_taylor_identity(self):
        f = jax.random.normal(jax.random.PRNGKey(1), (16, 16))
        zero = jnp.zeros((16, 16))
        np.testing.assert_allclose(np.asarray(taylor_lens(f, zero, zero)),
                                   np.asarray(f), atol=1e-5)

    def test_taylor_matches_exact_shift_for_smooth_field(self):
        """For a single low-k Fourier mode, a small constant shift is
        computable exactly; Taylor must match to O(d³)."""
        n = 32
        xg = jnp.arange(n)
        f = jnp.cos(2 * jnp.pi * (xg[None, :] + 2 * xg[:, None]) / n)
        d = 0.2
        shifted_exact = jnp.cos(2 * jnp.pi * ((xg[None, :] + d)
                                              + 2 * xg[:, None]) / n)
        got = taylor_lens(f, jnp.full((n, n), d), jnp.zeros((n, n)))
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(shifted_exact), atol=2e-4)

    def test_gradient_field_of_plane_wave(self):
        n = 32
        xg = jnp.arange(n)
        phi = jnp.sin(2 * jnp.pi * xg[None, :] / n) * jnp.ones((n, 1))
        dx, dy = gradient_field(phi)
        expected = (2 * jnp.pi / n) * jnp.cos(2 * jnp.pi * xg / n)
        np.testing.assert_allclose(np.asarray(dx[0]), np.asarray(expected),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(dy), 0.0, atol=1e-5)


@pytest.fixture(scope="module")
def prob():
    return lensing_problem(n=32, data_key=jax.random.PRNGKey(42))


def test_self_consistency(prob):
    assert check_self_consistency(prob, 0.3)


def test_latent_is_two_fields(prob):
    _, u = prob.sample_x_z(jax.random.PRNGKey(0), 0.0)
    assert set(u) == {"uphi", "uz"}
    assert u["uz"].shape == (32, 32)


def test_end_to_end_amplitude_recovery(prob):
    res = muse(prob, 0.5, nsims=20, maxsteps=15, get_covariance=True,
               key=jax.random.PRNGKey(1))
    z = abs(float(res.theta[0])) / float(res.sigma[0])
    assert z < 3.0          # truth is 0; nonlinear model, modest sims
    assert np.isfinite(res.Sigma).all()
    # warm-started MAPs converge by the later iterations
    assert res.history[-1]["map_converged"].all()


def test_implicit_H_with_model_preconditioner():
    """get_H implicit-diff on the nonlinear flagship, using the model's
    suggested Fourier-diagonal CG preconditioner; cross-checked against
    the finite-difference estimator (both estimate the same E[dscore/dθ]).

    MAP tolerances are tightened beyond the reference defaults: the
    implicit formula assumes exact stationarity and the FD estimator a
    converged fiducial fit, and on this nonlinear model coarse fits
    bias the estimates by 10-30% (measured with the packed-Fourier
    VarPro solver: fit_atol 1e-2 → H 36.4, 1e-3 → 28.657 vs FD-at-1e-3
    28.654 — tight solves agree to 0.01%; the nonconvex latent
    landscape has near-stationary points whose curvature differs from
    the MAP's, so implicit-diff H on a 1e-2 fit is NOT trustworthy
    here)."""
    from muse_tpu import MuseResult, get_H, get_J

    prob = lensing_problem(n=16, data_key=jax.random.PRNGKey(42))
    res = MuseResult()
    get_J(res, prob, 0.0, nsims=6, key=jax.random.PRNGKey(3))
    get_H(res, prob, 0.0, nsims=3, implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          implicit_fit_atol=1e-3, key=jax.random.PRNGKey(4))
    H_imp = res.H.copy()
    resid = np.asarray(res.metadata["implicit_diff_cg_resid"])
    assert np.isfinite(H_imp).all()
    assert resid.max() < 1e-2    # preconditioned CG converged

    res_fd = MuseResult()
    res_fd.gs = list(res.gs)
    get_H(res_fd, prob, 0.0, nsims=3, grad_z_atol=1e-3,
          key=jax.random.PRNGKey(4))
    assert abs(H_imp[0, 0] - res_fd.H[0, 0]) < 0.03 * abs(res_fd.H[0, 0])


def test_get_J_direct_on_model():
    """get_J accepts a bare PPL model function + observed= (the
    get_J!(result, model, θ₀) overload, src/turing.jl:248-256)."""
    from muse_tpu import MuseResult, get_J
    from muse_tpu import ppl
    from muse_tpu.distributions import Normal

    def model(d=8):
        th = ppl.sample("theta", Normal(0.0, 3.0))
        z = ppl.sample("z", Normal(0.0, jnp.exp(th / 2)).expand((d,)))
        ppl.sample("x", Normal(z, 1.0))

    x = jnp.ones(8)
    res = MuseResult()
    get_J(res, model, {"theta": 0.5}, observed={"x": x}, nsims=4,
          key=jax.random.PRNGKey(0))
    assert res.J.shape == (1, 1) and np.isfinite(res.J).all()


def test_infer_z_amp_two_theta():
    """Joint (A_φ, A_z) inference: 2-vector θ through VarPro + the
    analytic θ-gradient (∂F/∂θ_z = F/2 branch)."""
    p2 = lensing_problem(n=16, infer_z_amp=True,
                         data_key=jax.random.PRNGKey(11))
    res = muse(p2, np.zeros(2), nsims=8, maxsteps=6,
               key=jax.random.PRNGKey(2))
    assert res.theta.shape == (2,)
    assert np.isfinite(res.theta).all()
    assert res.history[-1]["map_converged"].all()


def test_infer_z_amp_full_pipeline_mahalanobis():
    """Full pipeline on the joint (A_φ, A_z) nonlinear model: J and H are
    2×2, Σ assembled from them must cover the truth — Mahalanobis
    m² = (θ̂−θ)ᵀΣ⁻¹(θ̂−θ) under the χ²₂ 99% bound (9.21), and both H
    diagonal entries must carry real information (non-degenerate vector
    score).  Reference runs only scalar θ in its tests."""
    from muse_tpu import MuseResult, get_H, get_J
    from muse_tpu.solver.muse import muse_fit

    p2 = lensing_problem(n=16, infer_z_amp=True,
                         data_key=jax.random.PRNGKey(12))
    key = jax.random.PRNGKey(4)
    res = MuseResult()
    muse_fit(res, p2, np.zeros(2), nsims=16, theta_rtol=3e-2,
             Hinv_update="broyden", key=key)
    get_J(res, p2, nsims=16, key=key)
    get_H(res, p2, nsims=6, implicit_diff=True,
          implicit_diff_precond=p2.suggested_h_precond, key=key)
    assert res.Sigma.shape == (2, 2)
    d = np.asarray(res.theta)          # θ_true = 0
    m2 = float(d @ np.linalg.solve(np.asarray(res.Sigma), d))
    assert m2 < 9.21, (d, np.asarray(res.Sigma), m2)
    H = np.asarray(res.H)
    assert H[0, 0] != 0.0 and H[1, 1] != 0.0
    sd = np.asarray(res.sigma)
    assert np.all(np.isfinite(sd)) and np.all(sd > 0)


def test_suggested_z0_warm_start(prob):
    z0 = prob.suggested_z0
    assert set(z0) == {"uphi", "uz"}
    res = muse(prob, 0.5, nsims=10, maxsteps=3, z0=z0,
               key=jax.random.PRNGKey(2))
    assert np.isfinite(res.theta).all()
    # the informed start must not be slower than the zero start on the
    # first iteration's MAP solves
    res0 = muse(prob, 0.5, nsims=10, maxsteps=3,
                key=jax.random.PRNGKey(2))
    assert (res.history[0]["map_iterations"].max()
            <= res0.history[0]["map_iterations"].max() + 50)


def test_checkpoint_resume_with_varpro(tmp_path, prob):
    """Checkpoint/resume through the VarPro solver path: a loaded result
    continues the Newton iteration without redoing completed steps
    (reference resume semantics, src/muse.jl:159,234)."""
    from muse_tpu import MuseResult, muse_fit
    from muse_tpu.result import load_result

    f = str(tmp_path / "ck.pkl")
    r1 = MuseResult()
    muse_fit(r1, prob, 0.5, nsims=6, maxsteps=2, checkpoint_file=f,
             key=jax.random.PRNGKey(5))
    assert len(r1.history) == 2

    r2 = load_result(f)
    assert len(r2.history) == 2
    # tiny theta_rtol so the resumed run cannot declare convergence at
    # the step-3 check and must actually iterate
    muse_fit(r2, prob, nsims=6, maxsteps=4, theta_rtol=1e-8,
             key=jax.random.PRNGKey(5))
    assert len(r2.history) >= 3
    # the resumed run's first two iterations are the checkpointed ones
    np.testing.assert_allclose(r2.history[1]["theta"],
                               r1.history[1]["theta"])


def test_explicit_budgets_respected_at_large_n():
    """The n-dependent budget defaults (docstring) must never override an
    explicitly passed value — a user raising gn_cg_maxiter to cure
    non-convergence warnings has to actually get the larger budget."""
    x0 = np.zeros((512, 512), np.float32)
    p = lensing_problem(n=512, x_obs=x0, gn_cg_maxiter=200, gn_max_outer=70)
    assert p.solver_budgets["gn_cg_maxiter"] == 200
    assert p.solver_budgets["varpro_inner_cg_maxiter"] == 200
    assert p.solver_budgets["gn_max_outer"] == 70
    p2 = lensing_problem(n=512, x_obs=x0)
    # VarPro's inner elimination-CG scales down at flagship n; the
    # Newton-CG / polish budget does not — the dict must report both
    assert p2.solver_budgets["varpro_inner_cg_maxiter"] == 35
    assert p2.solver_budgets["gn_cg_maxiter"] == 50
    # solver="auto" keeps VarPro at flagship size (value corruption is
    # handled by runtime certification, not a build-time reroute)
    p3 = lensing_problem(n=1024, x_obs=np.zeros((1024, 1024), np.float32))
    assert p3.solver_budgets["solver"] == "varpro"
