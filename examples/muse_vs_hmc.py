"""MUSE vs HMC on the 512-dim noisy funnel.

The runnable analog of the reference docs' MUSE-vs-NUTS comparison
(MuseInference.jl docs/src/index.md, executed at doc-build time): both
methods target the same hierarchical posterior; MUSE gets the θ marginal
from a few hundred latent MAP solves where HMC must sample the full
513-dimensional joint.

Run:  python examples/muse_vs_hmc.py  [--dim 512 --nsims 100]
"""

import argparse
import os
import sys
import time

# allow running straight from a repo checkout: `python examples/<demo>.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from muse_tpu import SimpleMuseProblem, muse
from muse_tpu.utils.compile_cache import enable_compile_cache


def build_problem(dim, data_key):
    def sample_x_z(key, theta):
        k1, k2 = jax.random.split(key)
        z = jnp.exp(theta / 2) * jax.random.normal(k1, (dim,))
        return z + jax.random.normal(k2, (dim,)), z

    def log_like(x, z, theta):
        return -0.5 * (jnp.sum((x - z) ** 2)
                       + jnp.sum(z ** 2) / jnp.exp(theta) + dim * theta)

    x_obs, _ = sample_x_z(data_key, 0.0)
    return SimpleMuseProblem(x_obs, sample_x_z, log_like,
                             log_prior=lambda th: -th ** 2 / 18), x_obs


def hmc_joint(log_post, q0, key, *, n_samples=2000, n_leapfrog=30,
              step=0.02, burn=500):
    """Plain HMC over the joint (θ, z) — scan-compiled, one chain."""
    grad = jax.grad(log_post)

    def leapfrog(q, p):
        p = p + 0.5 * step * grad(q)

        def body(_, qp):
            q, p = qp
            q = q + step * p
            p = p + step * grad(q)
            return q, p

        q, p = jax.lax.fori_loop(0, n_leapfrog - 1, body, (q, p))
        q = q + step * p
        p = p + 0.5 * step * grad(q)
        return q, p

    def step_fn(carry, key):
        q, lp = carry
        kp, ka = jax.random.split(key)
        p = jax.random.normal(kp, q.shape)
        q_new, p_new = leapfrog(q, p)
        lp_new = log_post(q_new)
        log_accept = (lp_new - 0.5 * jnp.sum(p_new ** 2)
                      - lp + 0.5 * jnp.sum(p ** 2))
        accept = jnp.log(jax.random.uniform(ka)) < log_accept
        q = jnp.where(accept, q_new, q)
        lp = jnp.where(accept, lp_new, lp)
        return (q, lp), (q[0], accept)

    keys = jax.random.split(key, n_samples)
    (_, _), (thetas, accepts) = jax.lax.scan(
        step_fn, (q0, log_post(q0)), keys)
    burn = min(burn, n_samples // 3)     # short runs: keep ≥2/3 of chain
    return thetas[burn:], float(accepts.mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--nsims", type=int, default=100)
    ap.add_argument("--hmc-samples", type=int, default=2000)
    args = ap.parse_args()
    enable_compile_cache()

    prob, x_obs = build_problem(args.dim, jax.random.PRNGKey(42))

    # ---- exact marginal posterior (quadrature oracle) ----
    # this funnel admits a closed-form marginal, x ~ N(0, (1+e^θ)·I):
    # a 1D quadrature of P(θ|x) is the ground truth BOTH methods chase —
    # the oracle the reference's docs comparison lacks.
    x2 = float(jnp.sum(x_obs ** 2))
    th_grid = np.linspace(-4, 4, 8001)
    logp = (-0.5 * (x2 / (1 + np.exp(th_grid))
                    + args.dim * np.log(1 + np.exp(th_grid)))
            - th_grid ** 2 / 18)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mu_ex = float((w * th_grid).sum())
    sd_ex = float(np.sqrt((w * (th_grid - mu_ex) ** 2).sum()))
    print(f"exact: θ = {mu_ex:+.4f} ± {sd_ex:.4f}   (1D quadrature of "
          "the closed-form marginal)")

    # ---- MUSE ----
    t0 = time.perf_counter()
    res = muse(prob, 1.0, nsims=args.nsims, maxsteps=30, theta_rtol=1e-3,
               get_covariance=True, key=jax.random.PRNGKey(1))
    t_muse = time.perf_counter() - t0
    print(f"MUSE:  θ = {res.theta[0]:+.4f} ± {res.sigma[0]:.4f}   "
          f"({t_muse:.1f}s, {args.nsims} sims)  "
          f"[MUSE − exact = {float(res.theta[0]) - mu_ex:+.3f}]")

    # ---- HMC on the joint (θ, z) ----
    def log_post(q):
        theta, z = q[0], q[1:]
        return (prob.log_like(x_obs, z, theta) + prob.log_prior(theta))

    q0 = jnp.concatenate([jnp.array([1.0]), jnp.zeros(args.dim)])
    t0 = time.perf_counter()
    thetas, acc = hmc_joint(jax.jit(log_post), q0, jax.random.PRNGKey(2),
                            n_samples=args.hmc_samples)
    thetas = np.asarray(thetas)
    t_hmc = time.perf_counter() - t0
    print(f"HMC:   θ = {thetas.mean():+.4f} ± {thetas.std():.4f}   "
          f"({t_hmc:.1f}s, accept {acc:.2f}, "
          f"{args.hmc_samples} samples × 30 leapfrog)")

    print(f"\nagreement: Δμ = {abs(res.theta[0] - thetas.mean()):.3f}  "
          f"(σ ≈ {res.sigma[0]:.3f});  speedup ×{t_hmc / t_muse:.1f} "
          "(plain fixed-step HMC mixes poorly in the funnel neck — "
          "judge both against the exact line above)")
    # MUSE must match the exact marginal tightly; HMC is the contender
    # being benchmarked, not the oracle (its funnel bias is the point).
    assert abs(float(res.theta[0]) - mu_ex) < 0.5 * sd_ex, \
        "MUSE missed the exact marginal posterior"


if __name__ == "__main__":
    main()
