"""Batched trust-region Newton-CG (Steihaug-Toint) — the second-order
latent MAP solver.

Why this exists: the reference solves every latent MAP with generic L-BFGS
(Optim.jl, ``src/interface.jl:162-166``).  For the framework's nonlinear
field models (lensing) that is the wrong algorithm twice over:

  * the objective ½‖x−F(u)‖²/σ² + ½‖u‖² has *indefinite* Hessians away
    from the optimum (measured: λmin ≈ −0.5 on the lensing benchmark —
    the bilinear z×φ coupling in the remap) — quasi-Newton models built
    from secant pairs crawl through such regions (measured: 150–240
    L-BFGS iterations per cold-start solve);
  * the L-BFGS two-loop touches 2·m·B·N floats of history per iteration
    (1.4 GB/step of device-memory traffic at m=10, B=65, 1024² latents)
    — bandwidth spent on no new curvature information.

Trust-region Newton-CG fixes both: curvature comes from exact
Hessian-vector products (one ``jax.jvp`` over the gradient — a fused
batched FFT chain for field models, no history state), and the Steihaug
CG exits along negative-curvature directions instead of stalling on them.
When F is linear (Gaussian conditionals) the method degenerates to exact
preconditioned CG on the normal equations — the provably optimal solver.

Lockstep/masking discipline matches ops/lbfgs.py: one ``lax.while_loop``
advances all lanes, converged lanes freeze, NaN lanes flag failed
(the vmap-safe ``skip_errors`` analog, reference src/muse.jl:515-521).
Convergence is sup-norm of the gradient < ``g_atol`` — identical
semantics to the generic path (Optim ``g_tol`` / ``∇z_logLike_atol``,
reference src/muse.jl:122), so solvers are interchangeable.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["NewtonCgResult", "batched_newton_cg"]


class NewtonCgResult(NamedTuple):
    z: jnp.ndarray            # (B, N) final iterates
    f: jnp.ndarray            # (B,)  final objective values
    g: jnp.ndarray            # (B, N) final gradients
    converged: jnp.ndarray    # (B,)  bool: sup-norm(g) < g_atol
    failed: jnp.ndarray       # (B,)  bool: NaN/Inf or dead trust region
    iterations: jnp.ndarray   # (B,)  int32 outer TR iterations
    cg_iterations: jnp.ndarray  # (B,) int32 cumulative inner CG iterations
    g_norm: jnp.ndarray       # (B,)  final sup-norm of gradient


def _steihaug(hvp, g, delta, Minv, maxiter, rtol_cap, active=None):
    """Batched preconditioned Steihaug-Toint CG for  H d = −g,  ‖d‖ ≤ Δ.

    Preconditioned search directions, Euclidean trust-region norm (the
    standard pragmatic combination).  Inner tolerance is the
    Eisenstat–Walker forcing  ‖r‖ ≤ min(rtol_cap, √‖g‖)·‖g‖  for
    superlinear outer convergence without wasted early precision.
    ``active`` masks lanes the outer loop has already frozen
    (converged/failed) so they don't drag the lockstep inner loop down to
    their tiny forcing tolerance for discarded results.
    Returns (d, boundary_hit, iters_used).
    """
    B = g.shape[0]
    g_norm = jnp.linalg.norm(g, axis=-1)
    tol = jnp.minimum(rtol_cap, jnp.sqrt(g_norm)) * g_norm

    d0 = jnp.zeros_like(g)
    r0 = -g
    z0 = Minv(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0, -1)
    done0 = g_norm <= 0.0
    if active is not None:
        done0 = done0 | ~active
    bhit0 = jnp.zeros((B,), bool)

    def to_boundary(d, p, delta):
        """τ ≥ 0 with ‖d + τp‖ = Δ (d inside the ball, p ≠ 0)."""
        a = jnp.sum(p * p, -1)
        b = 2.0 * jnp.sum(d * p, -1)
        c = jnp.sum(d * d, -1) - delta ** 2
        disc = jnp.sqrt(jnp.maximum(b * b - 4 * a * c, 0.0))
        return (-b + disc) / jnp.maximum(2 * a, 1e-30)

    def cond(carry):
        _, _, _, _, _, done, _, _, k = carry
        return (k < maxiter) & ~jnp.all(done)

    def body(carry):
        d, r, z, p, rz, done, bhit, iters, k = carry
        Hp = hvp(p)
        pHp = jnp.sum(p * Hp, -1)
        neg = pHp <= 0

        alpha = rz / jnp.where(pHp != 0, pHp, 1.0)
        d_try = d + alpha[:, None] * p
        crossed = jnp.linalg.norm(d_try, axis=-1) >= delta

        tau = to_boundary(d, p, delta)
        d_bnd = d + tau[:, None] * p

        exit_bnd = (neg | crossed) & ~done
        d1 = jnp.where(done[:, None], d,
                       jnp.where(exit_bnd[:, None], d_bnd, d_try))

        r1 = jnp.where((done | exit_bnd)[:, None], r,
                       r - alpha[:, None] * Hp)
        z1 = Minv(r1)
        rz1 = jnp.sum(r1 * z1, -1)
        small = jnp.linalg.norm(r1, axis=-1) <= tol
        finite = jnp.isfinite(rz1)
        done1 = done | exit_bnd | small | ~finite
        beta = jnp.where(done1, 0.0, rz1 / jnp.where(rz != 0, rz, 1.0))
        p1 = jnp.where(done1[:, None], p, z1 + beta[:, None] * p)
        return (d1, r1, z1, p1, rz1, done1, bhit | exit_bnd,
                iters + (~done).astype(jnp.int32), k + 1)

    carry = (d0, r0, z0, p0, rz0, done0, bhit0,
             jnp.zeros((B,), jnp.int32), jnp.zeros((), jnp.int32))
    d, _, _, _, _, _, bhit, iters, _ = lax.while_loop(cond, body, carry)
    return d, bhit, iters


@partial(jax.jit, static_argnames=(
    "fn", "precond", "max_outer", "cg_maxiter"))
def batched_newton_cg(
    fn: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]],
    z0: jnp.ndarray,
    *,
    g_atol=1e-2,
    max_outer: int = 100,
    cg_maxiter: int = 50,
    cg_rtol_cap: float = 0.25,
    precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    delta_max: float = 1e6,
    eta: float = 0.01,
    tr_refresh: int = 25,
) -> NewtonCgResult:
    """Minimize ``fn`` over a batch of lanes in lockstep (2nd order).

    Args:
      fn: batched value-and-grad, ``(B, N) -> ((B,), (B, N))``, pure and
        AD-differentiable (HVPs are taken by forward-over-reverse through
        it); per-lane data closed over as batched arrays.
      z0: ``(B, N)`` initial iterates (warm starts, src/muse.jl:151,181).
      g_atol: sup-norm gradient tolerance (scalar or ``(B,)``).
      cg_maxiter / cg_rtol_cap: inner Steihaug budget; the outer loop owns
        true convergence, so a loose inner tolerance only costs extra
        outer iterations, never correctness.
      precond: optional SPD approximation of H⁻¹ on flat lanes (the
        model-supplied Fourier-diagonal inverse for field problems — the
        ``Pl`` analog, reference src/muse.jl:312).
      eta: minimum actual/predicted reduction ratio to accept a step.
      tr_refresh: every this many outer iterations, still-unconverged
        lanes get their trust radius refreshed to the preconditioned-
        gradient scale (the delta0 rule).  Repeated rejections can
        collapse Δ to where the predicted reduction sits below the f32
        resolution floor of f — there ρ is pure rounding noise and the
        lane limit-cycles (grow-on-noise / shrink-on-noise) without
        progress.  A fresh radius makes pred resolvable again; measured
        on the lensing polish: a lane that made no progress in 80
        budget iterations of the cycle converges 18 iterations after a
        refresh.  Costs at most one rejected big step per period for
        lanes that genuinely need a small Δ.
    """
    B, N = z0.shape
    dtype = z0.dtype
    g_atol = jnp.broadcast_to(jnp.asarray(g_atol, dtype), (B,))
    Minv = (lambda v: v) if precond is None else precond

    def grad_only(U):
        return fn(U)[1]

    f0, g0 = fn(z0)
    bad0 = ~(jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0), -1))
    conv0 = jnp.max(jnp.abs(g0), -1) < g_atol
    # initial radius ≈ the preconditioned-gradient (quasi-Newton) step
    delta0 = jnp.clip(jnp.linalg.norm(Minv(g0), axis=-1), 1.0, 1e4)

    class _St(NamedTuple):
        U: jnp.ndarray
        f: jnp.ndarray
        g: jnp.ndarray
        delta: jnp.ndarray
        converged: jnp.ndarray
        failed: jnp.ndarray
        iters: jnp.ndarray
        cg_iters: jnp.ndarray
        k: jnp.ndarray

    init = _St(z0, f0, g0, delta0, conv0, bad0,
               jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
               jnp.zeros((), jnp.int32))

    def cond(st):
        return (st.k < max_outer) & ~jnp.all(st.converged | st.failed)

    def body(st):
        active = ~(st.converged | st.failed)

        # Linearize-hoisted HVP: the Steihaug solve applies the Hessian at
        # the FIXED iterate st.U tens of times, so computing the gradient's
        # linearization once per outer iteration and reusing its residuals
        # makes every inner application tangent-only — ~2× cheaper than
        # jvp-of-grad per call (which re-runs the primal sweep each time).
        # Same hoist as the VarPro inner CG's deflection fields.
        _, hvp = jax.linearize(grad_only, st.U)

        d, bhit, cg_its = _steihaug(hvp, st.g, st.delta, Minv,
                                    cg_maxiter, cg_rtol_cap, active)

        # predicted reduction of the quadratic model (one extra HVP)
        Hd = hvp(d)
        pred = -(jnp.sum(st.g * d, -1) + 0.5 * jnp.sum(d * Hd, -1))
        f_try, g_try = fn(st.U + d)
        # f32-resolution floor on the actual reduction: at large |f| a
        # genuine small improvement is unresolvable in f (|f|·ε), which
        # would reject every step and stall the lane (see ops/varpro.py)
        f_floor = 8.0 * jnp.finfo(dtype).eps * jnp.abs(st.f)
        actual = st.f - f_try + f_floor
        rho = actual / jnp.where(pred > 0, pred, 1e-30)
        ok = (pred > 0) & (rho > eta) & jnp.isfinite(f_try)
        take = ok & active

        U1 = jnp.where(take[:, None], st.U + d, st.U)
        f1 = jnp.where(take, f_try, st.f)
        g1 = jnp.where(take[:, None], g_try, st.g)
        bad = take & ~jnp.all(jnp.isfinite(g_try), -1)

        # trust-radius update (standard Conn–Gould–Toint schedule)
        d_norm = jnp.linalg.norm(d, axis=-1)
        grow = ok & bhit & (rho > 0.75)
        shrink = ~ok | (rho < 0.25)
        delta1 = jnp.where(grow, jnp.minimum(2.0 * st.delta, delta_max),
                           jnp.where(shrink,
                                     0.25 * jnp.maximum(d_norm, 1e-30),
                                     st.delta))
        delta1 = jnp.where(active, delta1, st.delta)

        conv = st.converged | (take & ~bad &
                               (jnp.max(jnp.abs(g1), -1) < g_atol))
        # a trust region collapsed below any representable step is a stall
        # (checked before the periodic refresh so hopeless lanes — every
        # direction rejected until collapse — still fail fast)
        dead = active & (delta1 < 1e-10)
        failed = st.failed | (active & bad) | dead

        # periodic trust-radius refresh for cycling lanes (see docstring)
        refresh = (st.k % tr_refresh) == (tr_refresh - 1)
        delta_fresh = jnp.clip(jnp.linalg.norm(Minv(g1), axis=-1), 1.0, 1e4)
        delta1 = jnp.where(refresh & active & ~conv & ~failed,
                           jnp.maximum(delta1, delta_fresh), delta1)

        return _St(
            U=U1, f=f1, g=g1, delta=delta1, converged=conv, failed=failed,
            iters=st.iters + active.astype(jnp.int32),
            cg_iters=st.cg_iters + jnp.where(active, cg_its, 0),
            k=st.k + 1)

    st = lax.while_loop(cond, body, init)
    return NewtonCgResult(
        z=st.U, f=st.f, g=st.g,
        converged=st.converged, failed=st.failed,
        iterations=st.iters, cg_iterations=st.cg_iters,
        g_norm=jnp.max(jnp.abs(st.g), -1))
