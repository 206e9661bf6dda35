"""Batched variable projection (VarPro) — the separable nonlinear MAP solver.

Why this exists: the lensing-style models' joint latent MAP

    min_{u_nl, z}  ½‖x − G(u_nl) z‖²/σ² + ½‖u_nl‖² + ½‖z‖²

is *separable*: the observation is strictly LINEAR in the large latent
block z (the unlensed field) for any fixed nonlinear block u_nl (the
lensing potential).  Joint quasi-Newton over (u_nl, z) fights a curved
valley — moving u_nl shifts the optimal z, so L-BFGS needs 150–250
iterations tracking the coupling (measured), and trust-region Newton-CG
rejects half its steps on the same geometry (the joint Hessian is
indefinite en route, λmin ≈ −0.5 measured).

Variable projection eliminates the valley structurally:
  * inner: for fixed u_nl, z*(u_nl) is an SPD linear solve
    (I + GᵀG/σ²) z = Gᵀx/σ² — masked lockstep PCG, Fourier-diagonal
    preconditioner, warm-started across outer iterations;
  * outer: L-BFGS on the *reduced* objective f(u_nl, z*(u_nl)) whose
    gradient is, by the envelope theorem, just ∂f/∂u_nl at the solved z.

Measured on the lensing benchmark (32², single lane): 68 reduced
iterations vs 252 joint L-BFGS iterations, converging to a lower
objective.  The inner CG residual is exactly the z-block gradient, so
convergence is certified in the FULL space: sup|∇f| < g_atol over both
blocks — identical semantics to every other solver here (Optim ``g_tol``
/ ``∇z_logLike_atol``, reference src/muse.jl:122).

No reference analog: MuseInference.jl solves every MAP with generic
L-BFGS (src/interface.jl:162-166) and has no field models in-repo.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["VarproResult", "batched_varpro"]


class VarproResult(NamedTuple):
    u_nl: jnp.ndarray         # (B, Nnl) nonlinear block at the MAP
    z_lin: jnp.ndarray        # (B, Nlin) linear block at the MAP
    f: jnp.ndarray            # (B,)  final objective values
    converged: jnp.ndarray    # (B,)  bool: full-space sup|∇f| < g_atol
    failed: jnp.ndarray       # (B,)  bool: NaN/Inf or line-search stall
    iterations: jnp.ndarray   # (B,)  int32 outer (reduced) iterations
    inner_iterations: jnp.ndarray  # (B,) int32 cumulative inner CG iters
    g_norm: jnp.ndarray       # (B,)  final full-space sup-norm of ∇f


def _sup(v):
    return jnp.max(jnp.abs(v), axis=-1)


@partial(jax.jit, static_argnames=(
    "obs_op", "precond_lin", "lin_sup", "lin_ops", "m", "max_outer",
    "max_ls", "inner_maxiter"))
def batched_varpro(
    obs_op: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    xs: jnp.ndarray,
    Unl0: jnp.ndarray,
    Zlin0: jnp.ndarray,
    *,
    sigma2,
    g_atol=1e-2,
    m: int = 10,
    max_outer: int = 200,
    max_ls: int = 15,
    c1: float = 1e-4,
    inner_maxiter: int = 50,
    inner_kappa: float = 0.1,
    precond_lin: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    lin_sup: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    lin_ops: Optional[Callable[[jnp.ndarray], Tuple[Callable, Callable]]]
    = None,
) -> VarproResult:
    """Minimize ½‖x − obs_op(u, z)‖²/σ² + ½‖u‖² + ½‖z‖² in lockstep.

    Args:
      obs_op: batched observation operator ``((B,Nnl), (B,Nlin)) ->
        (B,*obs)``; must be STRICTLY linear in its second argument
        (``obs_op(u, 0) = 0``) — the transpose is taken with
        ``jax.linear_transpose``.  Pure; statics closed over.
      xs: (B, *obs) per-lane observations.
      Unl0/Zlin0: initial iterates (warm starts, src/muse.jl:151,181).
      g_atol: FULL-space sup-norm gradient tolerance (scalar or (B,)).
      inner_kappa: inner forcing — each inner solve stops at
        sup|r| ≤ max(κ·sup|g_nl|, 0.5·g_atol), so early solves are loose
        (inexact VarPro) and the final ones certify the z-block gradient.
      precond_lin: optional SPD approx of (I + GᵀG/σ²)⁻¹ on flat z lanes.
      lin_sup: per-lane effective sup-norm of a z-block residual,
        ``(B, Nlin) -> (B,)`` (default: elementwise max-abs).  Callers
        whose linear block lives in a rotated basis (e.g. packed-Fourier
        coordinates, models/lensing.py) pass a basis-appropriate measure
        here — a smooth pixel-space gradient concentrates into few
        Fourier modes, so the raw spectral max-abs can be ~√N stricter
        than the pixel-space sup the tolerance was calibrated for.
      lin_ops: optional EXPLICIT linearization factory
        ``(Unl) -> (G, Gt)`` returning the batched linear operator
        ``G: (B, Nlin) -> (B, *obs)`` (= ``obs_op(Unl, ·)``) and its
        exact adjoint ``Gt: (B, *obs) -> (B, Nlin)`` under the Euclidean
        inner products of both spaces.  When given, the inner PCG uses
        these instead of ``jax.linearize``/``jax.linear_transpose`` —
        a performance/hardening hook (hand-fused operator pairs, no
        linearize machinery in the compiled program).  On the accelerator
        this engine was first built on it was NOT a complete workaround
        for that compiler's batch-width value-corruption family
        (models/lensing.py docstring): at 1024² the explicit adjoint
        fixed width 13 but width 17 still corrupted — the trigger was
        the FFT-chain program structure inside ``lax.while_loop``.
        Correctness contract: ⟨G z, w⟩ = ⟨z, Gt w⟩ exactly — test with
        the adjoint-identity check in tests/test_newton_varpro.py.
    """
    B, Nnl = Unl0.shape
    dtype = Unl0.dtype
    g_atol = jnp.broadcast_to(jnp.asarray(g_atol, dtype), (B,))
    sigma2 = jnp.asarray(sigma2, dtype)
    Minv = (lambda v: v) if precond_lin is None else precond_lin
    lsup = _sup if lin_sup is None else lin_sup
    Z_ex = jnp.zeros_like(Zlin0)

    def _inner(Unl, Z0, rho, rho_from_r0=False):
        """PCG on (I + GᵀG/σ²) z = Gᵀx/σ² with ABSOLUTE sup-norm stop:
        the residual b − Az is exactly −∇_z f, so sup|r| ≤ rho certifies
        the z-block gradient.  With ``rho_from_r0`` the target is
        max(rho, κ·sup|r₀|) — the cold-start forcing, scaled off the
        solve's own initial residual instead of a separate gradient probe.

        G is linearized once per solve: every u_nl-derived quantity in
        obs_op (e.g. the deflection fields) is computed in the primal
        pass and REUSED by the jvp, so CG matvecs pay only the z-path
        transforms (measured ~36% of the matvec FLOPs saved for the
        lensing forward)."""
        if lin_ops is not None:
            G, Gt = lin_ops(Unl)
        else:
            _, G = jax.linearize(lambda V: obs_op(Unl, V), Z_ex)
            Gt = lambda W: jax.linear_transpose(G, Z_ex)(W)[0]

        def A(V):
            return V + Gt(G(V)) / sigma2

        b = Gt(xs) / sigma2
        r0 = b - A(Z0)
        if rho_from_r0:
            rho = jnp.maximum(rho, inner_kappa * lsup(r0))
        z0 = Minv(r0)
        done0 = lsup(r0) <= rho

        def cond2(c):
            done, k = c[4], c[6]
            return (k < inner_maxiter) & ~jnp.all(done)

        def body2(c):
            Z, r, p, rz, done, its, k = c
            Ap = A(p)
            pAp = jnp.sum(p * Ap, -1)
            alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
            alpha = jnp.where(done | (pAp <= 0), 0.0, alpha)
            Z1 = Z + alpha[:, None] * p
            r1 = r - alpha[:, None] * Ap
            z1 = Minv(r1)
            rz1 = jnp.sum(r1 * z1, -1)
            done1 = done | (lsup(r1) <= rho) | ~jnp.isfinite(rz1)
            beta = jnp.where(done1, 0.0,
                             rz1 / jnp.where(rz != 0, rz, 1.0))
            p1 = jnp.where(done1[:, None], p, z1 + beta[:, None] * p)
            return (Z1, r1, p1, rz1, done1,
                    its + (~done).astype(jnp.int32), k + 1)

        init = (Z0, r0, z0, jnp.sum(r0 * z0, -1), done0,
                jnp.zeros((B,), jnp.int32), jnp.zeros((), jnp.int32))
        Z, r, _, _, _, its, _ = lax.while_loop(cond2, body2, init)
        return Z, lsup(r), its

    def _f_and_g(Unl, Z):
        """Per-lane objective + envelope gradient ∂f/∂u_nl at fixed
        (solved) Z — one AD pass (lanes are independent, so the gradient
        of the sum is the per-lane gradient)."""
        def fval(U):
            res = xs - obs_op(U, Z)
            f = 0.5 * (jnp.sum(res.reshape(B, -1) ** 2, -1) / sigma2
                       + jnp.sum(U * U, -1) + jnp.sum(Z * Z, -1))
            return jnp.sum(f), f
        (_, f), g = jax.value_and_grad(fval, has_aux=True)(Unl)
        return f, g

    # --- initial inner solve + reduced gradient ---------------------- #
    Z0s, rsup0, in0 = _inner(Unl0, Zlin0, 0.5 * g_atol, rho_from_r0=True)
    f0, g0 = _f_and_g(Unl0, Z0s)
    bad0 = ~(jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0), -1))
    conv0 = (_sup(g0) < g_atol) & (rsup0 < g_atol)

    class _St(NamedTuple):
        U: jnp.ndarray            # (B, Nnl)
        Z: jnp.ndarray            # (B, Nlin)
        f: jnp.ndarray
        g: jnp.ndarray            # (B, Nnl) reduced gradient
        rsup: jnp.ndarray         # (B,) last inner residual sup-norm
        S: jnp.ndarray            # (m, B, Nnl)
        Y: jnp.ndarray            # (m, B, Nnl)
        rho: jnp.ndarray          # (m, B)
        valid: jnp.ndarray        # (m, B)
        head: jnp.ndarray
        k: jnp.ndarray
        converged: jnp.ndarray
        failed: jnp.ndarray
        iters: jnp.ndarray
        inner_its: jnp.ndarray

    init = _St(
        U=Unl0, Z=Z0s, f=f0, g=g0, rsup=rsup0,
        S=jnp.zeros((m, B, Nnl), dtype), Y=jnp.zeros((m, B, Nnl), dtype),
        rho=jnp.zeros((m, B), dtype), valid=jnp.zeros((m, B), bool),
        head=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
        converged=conv0, failed=bad0,
        iters=jnp.zeros((B,), jnp.int32),
        inner_its=in0)

    from .lbfgs import _two_loop_chrono

    def cond(st):
        return (st.k < max_outer) & ~jnp.all(st.converged | st.failed)

    def body(st):
        active = ~(st.converged | st.failed)

        d = _two_loop_chrono(st.g, st.S, st.Y, st.rho, st.valid,
                             st.head, m)
        dg = jnp.sum(d * st.g, -1)
        descent = dg < 0
        d = jnp.where(descent[:, None], d, -st.g)
        dg = jnp.where(descent, dg, -jnp.sum(st.g * st.g, -1))

        gnorm = jnp.linalg.norm(st.g, axis=-1)
        a0 = jnp.where(st.k == 0,
                       jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm, 1e-12)),
                       1.0).astype(dtype)

        # inner forcing for this outer step's trials
        rho_in = jnp.maximum(inner_kappa * _sup(st.g), 0.5 * g_atol)

        # --- backtracking Armijo on the REDUCED objective: each trial
        # re-solves the inner problem warm-started from the current Z ---
        def ls_cond(carry):
            t, accepted, *_ = carry
            return (t < max_ls) & ~jnp.all(accepted | ~active)

        # Armijo at the f32 resolution floor: at large |f| (field models:
        # |f| ~ n²) the requested decrease c1·α·dg can be smaller than
        # |f|·ε — the comparison is then unresolvable and every trial is
        # rejected, stalling the lane for max_ls wasted inner solves
        # (measured at 1024²: 5/17 lanes burned the whole budget while
        # the rest converged in 2 iterations).  Accepting any non-increase
        # within a few ulps lets those lanes keep moving on gradient
        # information, which f32 still resolves.
        f_floor = 8.0 * jnp.finfo(dtype).eps * jnp.abs(st.f)

        def ls_body(carry):
            (t, accepted, alpha, U_new, Z_new, f_new, g_new, rs_new,
             ii) = carry
            U_try = st.U + alpha[:, None] * d
            Z_try, rs_try, its = _inner(U_try, st.Z, rho_in)
            # trial objective + envelope gradient in ONE AD pass — the
            # gradient of the accepting trial is the next iterate's g
            f_try, g_try = _f_and_g(U_try, Z_try)
            ok = (f_try <= st.f + c1 * alpha * dg + f_floor) \
                & jnp.isfinite(f_try)
            take = ok & ~accepted
            U_new = jnp.where(take[:, None], U_try, U_new)
            Z_new = jnp.where(take[:, None], Z_try, Z_new)
            f_new = jnp.where(take, f_try, f_new)
            g_new = jnp.where(take[:, None], g_try, g_new)
            rs_new = jnp.where(take, rs_try, rs_new)
            accepted = accepted | ok
            alpha = jnp.where(accepted, alpha, alpha * 0.5)
            return (t + 1, accepted, alpha, U_new, Z_new, f_new, g_new,
                    rs_new, ii + jnp.where(active, its, 0))

        carry0 = (jnp.zeros((), jnp.int32), jnp.zeros((B,), bool), a0,
                  st.U, st.Z, st.f, st.g, st.rsup,
                  jnp.zeros((B,), jnp.int32))
        (_, accepted, _, U_new, Z_new, f_new, g_new, rs_new,
         inner_used) = lax.while_loop(ls_cond, ls_body, carry0)

        step_ok = accepted & active
        U1 = jnp.where(step_ok[:, None], U_new, st.U)
        Z1 = jnp.where(step_ok[:, None], Z_new, st.Z)
        f1 = jnp.where(step_ok, f_new, st.f)
        rs1 = jnp.where(step_ok, rs_new, st.rsup)

        g1 = jnp.where(step_ok[:, None], g_new, st.g)
        bad = ~(jnp.isfinite(f1) & jnp.all(jnp.isfinite(g1), -1))

        # masked circular-buffer curvature update, GLOBAL clock with
        # per-lane EXPIRY (chronological variant of ops/lbfgs.py's exact
        # per-lane head): every iteration advances one shared slot, and a
        # lane that skips the store has that slot INVALIDATED rather than
        # keeping the m-iterations-stale pair — so slot order stays the
        # time order for every lane (no stale-newest promotion) with no
        # per-lane gathers in the two-loop.  Tradeoff vs the per-lane
        # head: a skip costs the lane its oldest pair one step early
        # (effective memory expires by global age).  Chosen here because
        # this loop's state is field-sized — a per-lane gather reads a
        # field-sized row per lane and slot every step — while skips are
        # rare for the smooth reduced objective.  ops/lbfgs.py (small-N
        # problems) keeps the exact per-lane semantics.
        s = U1 - st.U
        y = g1 - st.g
        sy = jnp.sum(s * y, -1)
        store = step_ok & (sy > 1e-10 * jnp.sum(y * y, -1))
        slot = st.head % m
        S = st.S.at[slot].set(jnp.where(store[:, None], s, st.S[slot]))
        Y = st.Y.at[slot].set(jnp.where(store[:, None], y, st.Y[slot]))
        rho = st.rho.at[slot].set(
            jnp.where(store, 1.0 / jnp.maximum(sy, 1e-30), st.rho[slot]))
        valid = st.valid.at[slot].set(store)

        conv = st.converged | (active & ~bad & (_sup(g1) < g_atol)
                               & (rs1 < g_atol))
        failed = st.failed | (active & bad) | (active & ~accepted & ~conv)

        return _St(
            U=U1, Z=Z1, f=f1, g=g1, rsup=rs1,
            S=S, Y=Y, rho=rho, valid=valid,
            head=st.head + 1, k=st.k + 1,
            converged=conv, failed=failed,
            iters=st.iters + active.astype(jnp.int32),
            inner_its=st.inner_its + inner_used)

    st = lax.while_loop(cond, body, init)
    g_full = jnp.maximum(_sup(st.g), st.rsup)
    return VarproResult(
        u_nl=st.U, z_lin=st.Z, f=st.f,
        converged=st.converged, failed=st.failed,
        iterations=st.iters, inner_iterations=st.inner_its,
        g_norm=g_full)
