"""Second-order solver tests: trust-region Newton-CG and VarPro.

Oracles: convex quadratics (Newton-CG must hit the exact solution in one
outer step — it degenerates to preconditioned CG), the batched Rosenbrock
family (nonconvex, curved valley — exercises the trust-region logic), and
linear observation models (VarPro's inner solve must reproduce the Wiener
solution with the nonlinear block untouched).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muse_tpu.ops.newton_cg import batched_newton_cg
from muse_tpu.ops.varpro import batched_varpro


class TestNewtonCg:
    def test_convex_quadratic_few_steps(self):
        """f = ½(z−a)ᵀD(z−a): inexact Newton with Eisenstat–Walker
        forcing reaches the exact solution in a handful of outer steps
        (each is a partial CG solve — deliberately loose early)."""
        B, N = 3, 16
        key = jax.random.PRNGKey(0)
        a = jax.random.normal(key, (B, N))
        d = jnp.linspace(0.5, 4.0, N)[None, :]

        def fn(Z):
            r = Z - a
            return 0.5 * jnp.sum(d * r * r, -1), d * r

        res = batched_newton_cg(fn, jnp.zeros((B, N)), g_atol=1e-5,
                                cg_maxiter=2 * N)
        assert bool(res.converged.all())
        np.testing.assert_allclose(np.asarray(res.z), np.asarray(a),
                                   atol=1e-4)
        assert int(res.iterations.max()) <= 10

    def test_rosenbrock_batch(self):
        """Nonconvex curved valley with indefinite Hessians en route."""
        B = 4
        x0 = jnp.stack([jnp.array([-1.2, 1.0]),
                        jnp.array([0.0, 0.0]),
                        jnp.array([2.0, 2.0]),
                        jnp.array([-0.5, 2.0])])

        def fn(Z):
            def one(z):
                return ((1 - z[0]) ** 2 + 100 * (z[1] - z[0] ** 2) ** 2)
            f = jax.vmap(one)(Z)
            g = jax.vmap(jax.grad(one))(Z)
            return f, g

        res = batched_newton_cg(fn, x0, g_atol=1e-4, max_outer=200)
        assert bool(res.converged.all()), np.asarray(res.g_norm)
        np.testing.assert_allclose(np.asarray(res.z),
                                   np.ones((B, 2)), atol=1e-3)

    def test_preconditioner_cuts_cg_iterations(self):
        """Ill-conditioned quadratic: the exact-inverse preconditioner
        must collapse the inner CG iteration count."""
        B, N = 2, 64
        d = jnp.logspace(0, 4, N)[None, :]
        a = jnp.ones((B, N))

        def fn(Z):
            r = Z - a
            return 0.5 * jnp.sum(d * r * r, -1), d * r

        plain = batched_newton_cg(fn, jnp.zeros((B, N)), g_atol=1e-3,
                                  cg_maxiter=500, max_outer=50)
        pre = batched_newton_cg(fn, jnp.zeros((B, N)), g_atol=1e-3,
                                cg_maxiter=500, max_outer=50,
                                precond=lambda v: v / d)
        assert bool(pre.converged.all())
        assert int(pre.cg_iterations.max()) < int(plain.cg_iterations.max())

    def test_nan_lane_flags_failed(self):
        B, N = 3, 4

        def fn(Z):
            f = jnp.sum(Z ** 2, -1)
            f = f.at[1].set(jnp.nan)
            return f, 2 * Z

        res = batched_newton_cg(fn, jnp.ones((B, N)), g_atol=1e-6)
        assert bool(res.failed[1])
        assert bool(res.converged[0]) and bool(res.converged[2])


class TestVarpro:
    def test_linear_case_is_wiener(self):
        """obs = z (identity G, no nonlinear dependence): the solution is
        the ridge/Wiener estimate z = x/(1+σ²) and u_nl stays at 0."""
        B, N = 3, 32
        s2 = 0.25
        xs = jax.random.normal(jax.random.PRNGKey(1), (B, N))

        def obs_op(U, Z):
            return Z

        res = batched_varpro(obs_op, xs, jnp.zeros((B, 4)),
                             jnp.zeros((B, N)), sigma2=s2, g_atol=1e-6)
        assert bool(res.converged.all())
        np.testing.assert_allclose(np.asarray(res.z_lin),
                                   np.asarray(xs / (1 + s2)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(res.u_nl), 0.0, atol=1e-6)

    def test_separable_bilinear(self):
        """obs = scale(u)·z with scale = 1+tanh(u): jointly nonconvex,
        separable.  Full-space gradient must satisfy the tolerance."""
        B, N = 4, 16
        s2 = 0.1
        key = jax.random.PRNGKey(2)
        xs = 2.0 * jax.random.normal(key, (B, N))

        def obs_op(U, Z):
            return (1.0 + jnp.tanh(U)) * Z   # U broadcast (B,1)->(B,N)

        res = batched_varpro(obs_op, xs, jnp.zeros((B, N)),
                             jnp.zeros((B, N)), sigma2=s2, g_atol=1e-4,
                             max_outer=300)
        assert bool(res.converged.all()), np.asarray(res.g_norm)

        def nll(u, z, x):
            r = x - (1.0 + jnp.tanh(u)) * z
            return 0.5 * (jnp.sum(r * r) / s2 + jnp.sum(u * u)
                          + jnp.sum(z * z))
        g_u = jax.vmap(jax.grad(nll, argnums=0))(res.u_nl, res.z_lin, xs)
        g_z = jax.vmap(jax.grad(nll, argnums=1))(res.u_nl, res.z_lin, xs)
        assert float(jnp.max(jnp.abs(g_u))) < 1e-4
        assert float(jnp.max(jnp.abs(g_z))) < 1e-4


class TestLensingSolvers:
    @pytest.fixture(scope="class")
    def setup(self):
        from muse_tpu.models.lensing import lensing_problem
        from muse_tpu.solver.compiled import CompiledProblem
        from muse_tpu.theta import ThetaSpec
        n = 16
        spec = ThetaSpec.from_example(0.0)
        th0 = spec.flatten(0.0)
        comps = {}
        for sv in ("varpro", "newton", "lbfgs"):
            p = lensing_problem(n=n, solver=sv,
                                data_key=jax.random.PRNGKey(1))
            comps[sv] = CompiledProblem(p, spec, th0)
        th = jnp.asarray(th0, jnp.float32)
        keys = jax.random.split(jax.random.PRNGKey(7), 3)
        xs, _ = jax.jit(comps["varpro"]._sample_batch)(keys, th)
        return comps, xs, th

    def test_varpro_converges_and_certifies_full_gradient(self, setup):
        comps, xs, th = setup
        c = comps["varpro"]
        Z0 = jnp.zeros((xs.shape[0], c.nz), jnp.float32)
        Z, aux = jax.jit(c._solve_maps)(xs, Z0, th,
                                        jnp.asarray(1e-2, jnp.float32))
        assert bool(aux["converged"].all()), np.asarray(aux["g_norm"])
        g = jax.vmap(lambda x, z: jax.grad(
            lambda zz: -c._ll(x, zz, th))(z))(xs, Z)
        assert float(jnp.max(jnp.abs(g))) < 1.5e-2

    def test_varpro_objective_not_worse_than_lbfgs(self, setup):
        """Different solvers may land in different local basins per lane;
        in aggregate VarPro's objectives must not be worse."""
        comps, xs, th = setup
        atol = jnp.asarray(1e-2, jnp.float32)
        Z0 = jnp.zeros((xs.shape[0], comps["varpro"].nz), jnp.float32)
        _, av = jax.jit(comps["varpro"]._solve_maps)(xs, Z0, th, atol)
        _, al = jax.jit(comps["lbfgs"]._solve_maps)(xs, Z0, th, atol)
        fv = float(np.asarray(av["neg_logp"]).sum())
        fl = float(np.asarray(al["neg_logp"]).sum())
        assert fv <= fl * 1.01 + 1.0, (fv, fl)

    def test_newton_solver_smoke(self, setup):
        comps, xs, th = setup
        c = comps["newton"]
        Z0 = jnp.zeros((xs.shape[0], c.nz), jnp.float32)
        Z, aux = jax.jit(c._solve_maps)(xs, Z0, th,
                                        jnp.asarray(5e-2, jnp.float32))
        assert np.isfinite(np.asarray(aux["neg_logp"])).all()
        assert not bool(aux["failed"].any())


def test_varpro_warm_start_cuts_iterations():
    """Warm-started re-solve (the muse loop's steady state,
    src/muse.jl:151,181) must converge in far fewer reduced iterations
    than the cold start."""
    import jax
    import jax.numpy as jnp
    from muse_tpu.models.lensing import lensing_problem
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec

    prob = lensing_problem(n=16, data_key=jax.random.PRNGKey(1))
    spec = ThetaSpec.from_example(0.0)
    c = CompiledProblem(prob, spec, spec.flatten(0.0))
    th = jnp.asarray(spec.flatten(0.0), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    xs, _ = jax.jit(c._sample_batch)(keys, th)
    atol = jnp.asarray(1e-2, jnp.float32)
    Z0 = jnp.zeros((3, c.nz), jnp.float32)
    sol = jax.jit(c._solve_maps)
    Z1, a1 = sol(xs, Z0, th, atol)
    Z2, a2 = sol(xs, Z1, th, atol)
    assert bool(a2["converged"].all())
    assert int(a2["iterations"].max()) <= max(
        2, int(a1["iterations"].max()) // 5)


class TestLensingExplicitAdjoint:
    """The hand-written (G, Gᵀ) pair behind lensing's VarPro inner CG
    (models/lensing.py lin_ops) must agree EXACTLY with the AD-derived
    linearization it replaces.  The pair exists because the compiler of
    the first accelerator value-corrupted the transpose-of-irfft2
    program inside lax.while_loop at specific batch widths — so the
    oracle here is the AD path on CPU, where linear_transpose is exact.
    """

    @pytest.fixture(scope="class", params=[16, 12])
    def ops(self, request):
        import muse_tpu.ops.varpro as vp
        from muse_tpu.models.lensing import lensing_problem
        n = request.param
        captured = {}
        orig = vp.batched_varpro

        def spy(obs_op, xs, U0, Z0, **kw):
            captured.update(obs_op=obs_op, lin_ops=kw.get("lin_ops"))
            return orig(obs_op, xs, U0, Z0, **kw)

        vp.batched_varpro = spy
        try:
            p = lensing_problem(n, solver="varpro")
            th = jnp.asarray(0.5)          # strong lensing: dx, dy large
            keys = jax.random.split(jax.random.PRNGKey(5), 3)
            xs, _ = jax.jit(jax.vmap(p.sample_x_z,
                                     in_axes=(0, None)))(keys, th)
            p.custom_zhat(xs, jnp.zeros((3, 2 * n * n), jnp.float32),
                          th, 1e-2)
        finally:
            vp.batched_varpro = orig
        assert captured.get("lin_ops") is not None
        kU, kZ, kW = jax.random.split(jax.random.PRNGKey(0), 3)
        Up = 0.5 * jax.random.normal(kU, (3, n * n))
        Zt = jax.random.normal(kZ, (3, 2 * n * (n // 2 + 1)))
        W = jax.random.normal(kW, (3, n, n))
        G, Gt = captured["lin_ops"](Up)
        return captured["obs_op"], G, Gt, Up, Zt, W

    def test_forward_matches_obs_op(self, ops):
        obs_op, G, Gt, Up, Zt, W = ops
        np.testing.assert_allclose(np.asarray(G(Zt)),
                                   np.asarray(obs_op(Up, Zt)),
                                   atol=2e-6)

    def test_adjoint_identity(self, ops):
        obs_op, G, Gt, Up, Zt, W = ops
        lhs = float(jnp.sum(G(Zt) * W))
        rhs = float(jnp.sum(Zt * Gt(W)))
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)

    def test_transpose_matches_ad(self, ops):
        obs_op, G, Gt, Up, Zt, W = ops
        Gt_ad = jax.linear_transpose(lambda V: obs_op(Up, V),
                                     jnp.zeros_like(Zt))
        np.testing.assert_allclose(np.asarray(Gt(W)),
                                   np.asarray(Gt_ad(W)[0]), atol=2e-6)
