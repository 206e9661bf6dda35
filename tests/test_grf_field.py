"""The non-whitened field GRF model and its packed spectrum quadform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muse_tpu import check_self_consistency, muse
from muse_tpu.models import grf_field_problem, grf_problem
from muse_tpu.models.grf import (GrfConfig, pack_rfft2, pack_weights,
                                 spectrum_quadform_reference)


@pytest.fixture(scope="module")
def data():
    B, n, m2 = 3, 16, 18
    z = jax.random.normal(jax.random.PRNGKey(0), (B, n, m2))
    ic = jax.random.uniform(jax.random.PRNGKey(1), (n, m2)) + 0.5
    return z, ic


def _np_quadform_and_grads(z, ic, w):
    """float64 numpy value of Σ_b w_b·q_b and its z- and C-gradients."""
    z, ic, w = (np.asarray(a, np.float64) for a in (z, ic, w))
    q = np.einsum("bnm,nm->b", z * z, ic)
    dz = 2.0 * w[:, None, None] * z * ic[None]
    dc = np.einsum("b,bnm->nm", w, z * z)
    return q, dz, dc


@pytest.mark.parametrize("part", ["value", "z_grad", "c_grad"])
def test_quadform_matches_float64(data, part):
    z, ic = data
    w = jnp.arange(1.0, z.shape[0] + 1)
    q_ref, dz_ref, dc_ref = _np_quadform_and_grads(z, ic, w)
    if part == "value":
        got, ref = spectrum_quadform_reference(z, ic), q_ref
    else:
        f = lambda zz, cc: jnp.sum(spectrum_quadform_reference(zz, cc) * w)
        dz, dc = jax.grad(f, argnums=(0, 1))(z, ic)
        got, ref = (dz, dz_ref) if part == "z_grad" else (dc, dc_ref)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref,
                               rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_pack_helpers_parseval():
    n = 16
    z = jax.random.normal(jax.random.PRNGKey(2), (n, n))
    cfg = GrfConfig(n=n)
    zri = pack_rfft2(z)
    w2 = pack_weights(cfg.herm_weight)
    # Parseval: Σ z² = (1/n²) Σ w |ẑ|²
    quad = spectrum_quadform_reference(zri[None], w2)[0] / n ** 2
    assert float(quad) == pytest.approx(float(jnp.sum(z * z)), rel=1e-4)


def test_field_model_theta_gradient_matches_fd():
    """∂θ log_like of the field model (through the quadform and log det)
    against a central finite difference in float64 arithmetic."""
    p = grf_field_problem(n=16, data_key=jax.random.PRNGKey(3))
    _, z = p.sample_x_z(jax.random.PRNGKey(4), 0.2)
    ll = lambda t: p.log_like(p.x, z, t)
    g = float(jax.grad(ll)(0.2))
    eps = 1e-2
    fd = (float(ll(0.2 + eps)) - float(ll(0.2 - eps))) / (2 * eps)
    # f32 values of |ll| ~ 1e2: roundoff in the difference ~ |ll|·ε/eps
    tol = 1e-3 * abs(g) + 4 * abs(float(ll(0.2))) * 1.2e-7 / eps
    assert abs(g - fd) < tol, (g, fd)


def test_field_model_self_consistency():
    p = grf_field_problem(n=32, data_key=jax.random.PRNGKey(42))
    assert check_self_consistency(p, 0.5)


def test_parameterization_invariance():
    """Whitened and non-whitened latents define the same marginal model;
    MUSE θ̂ must agree (both exact for this Gaussian problem)."""
    pw = grf_problem(n=32, solver="cg", data_key=jax.random.PRNGKey(42))
    pf = grf_field_problem(n=32, x_obs=pw.x)
    rw = muse(pw, 0.5, nsims=40, maxsteps=20, theta_rtol=1e-3,
              key=jax.random.PRNGKey(1))
    rf = muse(pf, 0.5, nsims=40, maxsteps=20, theta_rtol=1e-3,
              key=jax.random.PRNGKey(1))
    assert abs(float(rw.theta[0]) - float(rf.theta[0])) < 0.08
