"""The MUSE problem interface — the L3 "ops/model" layer.

A JAX re-design of the reference's ``AbstractMuseProblem`` and its 9
overridable functions (``src/interface.jl``):

  reference (Julia, dispatch-based)         here (JAX, pure functions)
  ---------------------------------         --------------------------------
  sample_x_z(prob, rng, θ)                  MuseProblem.sample_x_z(key, θ)
  logLike(prob, x, z, θ, θ_space)           MuseProblem.log_like(x, z, θ)
                                            (+ bijector handles θ-spaces)
  ∇θ_logLike / logLike_and_∇z_logLike       derived via jax.grad / value_and_grad
                                            (reference derives the same from
                                            logLike, src/simple.jl:79-89)
  logPriorθ(prob, θ, θ_space)               MuseProblem.log_prior(θ)
  transform_θ / inv_transform_θ             MuseProblem.theta_bijector
  standardizeθ                              ThetaSpec.flatten (solver-side)
  ẑ_at_θ (Optim L-BFGS default)             solver's batched_lbfgs over sims
  ẑ_guess_from_truth (default zero(z))      MuseProblem.zhat_guess_from_truth

θ and z are arbitrary PyTrees in user code; the solver ravels them to flat
vectors (θ: tiny, replicated; z: the big batched state sharded over the
mesh).  All user functions must be jit/vmap/grad traceable.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["MuseProblem", "check_self_consistency"]


class MuseProblem:
    """Base class for MUSE problems.

    Subclasses must implement :meth:`sample_x_z` and :meth:`log_like`;
    everything else has defaults mirroring the reference
    (``src/interface.jl:20,28,120-121,134,184-186``).
    """

    #: observed data (x); set by subclass constructor.
    x: Any = None

    #: bijector mapping θ's constrained (model) space to unconstrained space
    #: for the outer Newton iteration; ``None`` ⇒ identity
    #: (``transform_θ`` default, src/interface.jl:20).
    theta_bijector: Optional[Any] = None

    #: whether transformed-space densities include the change-of-variables
    #: log-volume factor (Turing convention: True — src/turing.jl:171-186;
    #: Soss convention: False — src/soss.jl:111-118).
    volume_factor: bool = True

    # ------------------------------------------------------------------ #
    # required
    # ------------------------------------------------------------------ #

    def sample_x_z(self, key, theta) -> Tuple[Any, Any]:
        """Joint forward sample ``(x, z) ~ P(x, z | θ)``.

        Must be a deterministic pure function of ``key`` — the solver relies
        on common random numbers (same key re-used across θ perturbations,
        reference ``split_rng`` semantics, src/util.jl:87-92).
        θ arrives in the *untransformed* (model) space.
        """
        raise NotImplementedError

    def log_like(self, x, z, theta) -> jnp.ndarray:
        """Joint log density ``log P(x, z | θ)`` (scalar).

        θ arrives in the *untransformed* space; z must already live in
        unconstrained space (same contract as the reference,
        src/interface.jl:52-54).
        """
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # optional
    # ------------------------------------------------------------------ #

    def log_prior(self, theta) -> jnp.ndarray:
        """``log P(θ)``; defaults to flat (src/interface.jl:121)."""
        return jnp.zeros(())

    def zhat_guess_from_truth(self, x, z, theta) -> Any:
        """Starting guess for a simulation's MAP given its true z.

        Default ``zero(z)`` (src/interface.jl:184-186); ``get_J`` instead
        starts from the truth itself (src/muse.jl:511-512).
        """
        return jax.tree.map(jnp.zeros_like, z)

    # ------------------------------------------------------------------ #
    # θ-space plumbing (rarely overridden; driven by theta_bijector)
    # ------------------------------------------------------------------ #

    def transform_theta(self, theta_flat: jnp.ndarray) -> jnp.ndarray:
        b = self.theta_bijector
        return theta_flat if b is None else b.forward(theta_flat)

    def inv_transform_theta(self, theta_t_flat: jnp.ndarray) -> jnp.ndarray:
        b = self.theta_bijector
        return theta_t_flat if b is None else b.inverse(theta_t_flat)

    def _log_volume(self, theta_flat: jnp.ndarray) -> jnp.ndarray:
        """log|det ∂transform/∂θ| at an untransformed θ (flat)."""
        b = self.theta_bijector
        if b is None or not self.volume_factor:
            return jnp.zeros(())
        return b.log_det_jacobian(theta_flat)

    # Marker that a subclass provides its own latent solver.  The default
    # (None) means the solver uses the batched L-BFGS kernel; subclasses may
    # instead set ``custom_zhat`` to a callable
    # ``(x_batched, z0_flat, theta_flat, atol) -> (zhat_flat, aux_dict)``
    # operating on the whole sims batch — the analog of overriding ẑ_at_θ
    # (src/interface.jl:162 note), but batched for lockstep execution.
    custom_zhat = None

    # Optional analytic θ-gradient of log_like — the analog of a problem
    # overriding ∇θ_logLike instead of letting it be AD-derived
    # (src/interface.jl:56-58).  Signature ``(x, z, θ) -> ∂θ log_like``
    # returning a pytree matching θ's structure; used for the untransformed
    # θ-space score (the hot path); transformed-space gradients still go
    # through AD + the bijector chain rule.
    grad_theta_log_like = None

    # Problems whose forward pass runs batched 2D FFTs over an n×n grid
    # declare it here (the field models do).  The solvers then validate
    # the chosen per-device lane width once per shape with the empirical
    # fused-FFT self-check (utils.fft_check.validate_fft_lanes) instead of
    # silently trusting the odd-lane rule on an untested backend.
    fft_grid = None

    # Optional CRN white-noise split of the forward sampler — a
    # batched-execution optimization with no reference analog (the
    # reference re-runs each sim's full sampler at every outer iteration
    # with the same seed, src/muse.jl:169-170; under common random
    # numbers the θ-independent randomness is ITERATION-INVARIANT, so it
    # can be drawn once and reused).  A problem that can factor its sampler as
    #
    #   sample_x_z(key, θ) ≡ x_of_white(sample_white(key), θ)
    #
    # declares the pair here: ``sample_white(key) -> W`` draws every
    # θ-independent random intermediate (any pytree), and
    # ``x_of_white(W, θ) -> (x, z)`` deterministically completes the
    # sample.  The muse iteration loop then hoists ``sample_white`` out
    # of the outer loop entirely — at 1024²×100 sims the RNG is the
    # dominant kernel of the iteration, so this is a large per-iteration
    # win.  The equivalence above is a hard contract (CRN correctness and
    # the runtime value-certification probes both rely on it);
    # ``check_self_consistency`` verifies it when the hooks are present.
    sample_white = None
    x_of_white = None


def check_self_consistency(problem: MuseProblem, theta, *, key=None,
                           atol=1e-2, eps=1e-3, dtype=jnp.float32):
    """Problem self-test — port of ``check_self_consistency``
    (src/interface.jl:209-230), with AD in place of most finite differences.

    Checks, at the given θ:
      1. θ-transform round-trip: ``inv(transform(θ)) ≈ θ``.
      2. prior volume factor: ``logPrior(θ) ≈ logPrior_t(transform(θ)) + V(θ)``
         where V = log|det J| (or 0 without volume factor).
      3. chain rule across spaces:
         ``∇θ logLike(θ) ≈ J(θ)ᵀ ∇θ′ logLike_t(θ′) + ∇θ V(θ)``.
      4. AD-vs-finite-difference agreement of ∇z log_like (the AD sanity
         check the reference gets implicitly from FiniteDifferences).

    Raises AssertionError listing every failed check.
    """
    from .theta import ThetaSpec
    from jax.flatten_util import ravel_pytree

    key = jax.random.PRNGKey(0) if key is None else key
    spec = ThetaSpec.from_example(theta, dtype=dtype)
    th = spec.flatten(theta)

    x, z = problem.sample_x_z(key, spec.unflatten(th))
    z_flat, unravel_z = ravel_pytree(z)

    failures = []

    def check(name, a, b):
        a, b = jnp.asarray(a), jnp.asarray(b)
        err = float(jnp.max(jnp.abs(a - b)))
        if not err < atol:
            failures.append(f"{name}: max abs err {err:.3e} (atol {atol})")

    # 1. round trip
    th_t = problem.transform_theta(th)
    check("transform round-trip", problem.inv_transform_theta(th_t), th)

    V = problem._log_volume
    logp = lambda t: jnp.asarray(problem.log_prior(spec.unflatten(t)), dtype)
    logp_t = lambda tt: (logp(problem.inv_transform_theta(tt))
                         - V(problem.inv_transform_theta(tt)))

    # 2. prior volume factor
    check("prior volume factor", logp(th), logp_t(th_t) + V(th))

    # 3. gradient chain rule across θ-spaces
    ll = lambda t: jnp.asarray(
        problem.log_like(x, unravel_z(z_flat), spec.unflatten(t)), dtype)
    ll_t = lambda tt: (ll(problem.inv_transform_theta(tt))
                       - V(problem.inv_transform_theta(tt)))
    g_u = jax.grad(ll)(th)
    g_t = jax.grad(ll_t)(th_t)
    J = jax.jacfwd(problem.transform_theta)(th)
    gV = jax.grad(V)(th)
    check("θ-space gradient chain rule", g_u, J.T @ g_t + gV)

    # 4. ∇z AD vs central finite differences (on a few coordinates).
    # FD on a large-sum objective is limited by cancellation noise
    # ~|f|·ε_machine/eps, so the tolerance adapts to the objective scale.
    g_z = jax.grad(lambda zf: ll_z(problem, x, unravel_z, zf, spec, th))(z_flat)
    f0 = ll_z(problem, x, unravel_z, z_flat, spec, th)
    eps_mach = float(jnp.finfo(dtype).eps)
    fd_atol = max(atol, 10.0 * float(jnp.abs(f0)) * eps_mach / eps)
    n = z_flat.shape[0]
    idxs = jnp.linspace(0, n - 1, num=min(5, n)).astype(int)
    for i in [int(i) for i in idxs]:
        zp = z_flat.at[i].add(eps)
        zm = z_flat.at[i].add(-eps)
        fd = (ll_z(problem, x, unravel_z, zp, spec, th)
              - ll_z(problem, x, unravel_z, zm, spec, th)) / (2 * eps)
        err = float(jnp.abs(g_z[i] - fd))
        if not err < fd_atol:
            failures.append(
                f"∇z AD vs FD [coord {i}]: err {err:.3e} (fd_atol {fd_atol:.3e})")

    # 5. CRN white-noise split (when declared): the hoisted sampler must
    # reproduce sample_x_z exactly — the solver's white-hoisted iteration
    # path and the value-certification probes both rely on it.
    if problem.x_of_white is not None or problem.sample_white is not None:
        if problem.x_of_white is None or problem.sample_white is None:
            failures.append("sample_white/x_of_white must be declared "
                            "together (one of them is None)")
        else:
            W = problem.sample_white(key)
            xw, zw = problem.x_of_white(W, spec.unflatten(th))
            for name, a, b in (("x", x, xw), ("z", z, zw)):
                la, _ = ravel_pytree(a)
                lb, _ = ravel_pytree(b)
                err = float(jnp.max(jnp.abs(la - lb))) if la.size else 0.0
                if not err < atol:
                    failures.append(
                        f"white-split {name}: x_of_white(sample_white(key), θ)"
                        f" differs from sample_x_z(key, θ) by {err:.3e}")

    if failures:
        raise AssertionError("self-consistency failures:\n  " +
                             "\n  ".join(failures))
    return True


def ll_z(problem, x, unravel_z, z_flat, spec, th):
    return jnp.asarray(
        problem.log_like(x, unravel_z(z_flat), spec.unflatten(th)))
