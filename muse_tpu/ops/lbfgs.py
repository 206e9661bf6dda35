"""Batched L-BFGS with masked lockstep convergence — the innermost kernel.

In the reference, >95% of wall-clock is the per-simulation latent MAP solve:
an Optim.jl L-BFGS over z with AD gradients, run independently per
simulation (``src/interface.jl:162-166``, call site ``src/muse.jl:169-171``).
This design runs *all* simulations' solves in lockstep as one
batched optimizer: a single ``lax.while_loop`` advancing a ``(B, N)`` state,
with per-lane convergence masks so finished lanes freeze while the rest
continue.  This keeps every step a large fused batched op (no host
round-trips, no dynamic shapes) and lets the sims axis
shard over the device mesh.

Semantics parity with the reference:
  * convergence is sup-norm of the gradient < ``g_atol``, matching Optim's
    ``g_tol`` / ``∇z_logLike_atol`` (``src/muse.jl:122``).
  * warm starts are supported by passing ``z0`` (``src/muse.jl:151,181``).
  * a lane that hits NaN/Inf is frozen and flagged rather than raising,
    which is the vmap-safe analog of ``skip_errors=true``
    (``src/muse.jl:515-521``).

This module minimizes; callers pass the negative log-likelihood.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["LbfgsResult", "batched_lbfgs"]


class LbfgsResult(NamedTuple):
    """Solution + per-lane diagnostics (the ``history`` analog that the
    reference stores per-sim in ``result.history`` via ``ẑ_history_sims``)."""

    z: jnp.ndarray            # (B, N) final iterates
    f: jnp.ndarray            # (B,)  final objective values
    g: jnp.ndarray            # (B, N) final gradients
    converged: jnp.ndarray    # (B,)  bool: sup-norm(g) < g_atol
    failed: jnp.ndarray       # (B,)  bool: NaN/Inf encountered (lane frozen)
    iterations: jnp.ndarray   # (B,)  int32 per-lane iteration counts
    g_norm: jnp.ndarray       # (B,)  final sup-norm of gradient


class _State(NamedTuple):
    z: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    S: jnp.ndarray            # (m, B, N) step history
    Y: jnp.ndarray            # (m, B, N) grad-diff history
    rho: jnp.ndarray          # (m, B) 1/(s·y)
    valid: jnp.ndarray        # (m, B) bool: slot holds a usable pair
    head: jnp.ndarray         # (B,) int32 per-lane circular-buffer write index
    k: jnp.ndarray            # ()  int32 global iteration
    converged: jnp.ndarray    # (B,)
    failed: jnp.ndarray       # (B,)
    iters: jnp.ndarray        # (B,) per-lane iterations actually taken


def _take_slot(A, idx):
    """Per-lane slot gather: ``A`` is ``(m, B, ...)``, ``idx`` is ``(B,)``
    per-lane slot indices → ``(B, ...)`` rows ``A[idx[b], b]``.

    A lane's history lives in its own circular buffer position (per-lane
    ``head``), so the two-loop recursion must gather a *different* slot per
    lane.  ``take_along_axis`` over the leading (slot) axis keeps each
    gathered row a contiguous ``(N,)`` vector — a cheap dynamic-gather for
    XLA (no transpose, no scalarization)."""
    ix = idx.reshape((1,) + idx.shape + (1,) * (A.ndim - 2))
    return jnp.take_along_axis(A, ix, axis=0)[0]


def _two_loop(g, S, Y, rho, valid, head, m):
    """Batched L-BFGS two-loop recursion → approximate -H⁻¹g direction.

    ``head`` is per-lane ``(B,)``: each lane advances its write index only
    when IT stores a pair, so recency order (newest→oldest, the order the
    recursion requires for true L-BFGS semantics) is exact per lane even
    when lanes store raggedly (curvature-skips, frozen lanes)."""

    def bwd(j, carry):
        q, alphas = carry
        idx = (head - 1 - j) % m                         # (B,) per-lane
        v = _take_slot(valid, idx)                       # (B,)
        Sj = _take_slot(S, idx)                          # (B, N)
        a = _take_slot(rho, idx) * jnp.sum(Sj * q, axis=-1)
        a = jnp.where(v, a, 0.0)
        q = q - (a * v)[:, None] * _take_slot(Y, idx)
        return q, alphas.at[j].set(a)

    B = g.shape[0]
    q, alphas = lax.fori_loop(0, m, bwd, (g, jnp.zeros((m, B), g.dtype)))

    # γ = s·y / y·y of the newest valid pair (per lane); identity fallback.
    newest = (head - 1) % m
    Sn, Yn = _take_slot(S, newest), _take_slot(Y, newest)
    sy = jnp.sum(Sn * Yn, axis=-1)
    yy = jnp.sum(Yn * Yn, axis=-1)
    gamma = jnp.where(_take_slot(valid, newest) & (yy > 0),
                      sy / jnp.maximum(yy, 1e-30), 1.0)
    r = gamma[:, None] * q

    def fwd(j_rev, r):
        j = m - 1 - j_rev
        idx = (head - 1 - j) % m
        v = _take_slot(valid, idx)
        b = _take_slot(rho, idx) * jnp.sum(_take_slot(Y, idx) * r, axis=-1)
        b = jnp.where(v, b, 0.0)
        return r + ((alphas[j] - b) * v)[:, None] * _take_slot(S, idx)

    r = lax.fori_loop(0, m, fwd, r)
    return -r


def _two_loop_chrono(g, S, Y, rho, valid, head, m):
    """Two-loop recursion for the GLOBAL-clock history layout.

    ``head`` is a scalar: every iteration writes (or per-lane
    invalidates) the same slot, so slot order IS time order for every
    lane and plain static indexing suffices — no per-lane gathers.  The
    caller must enforce the expiry contract: a lane that skips a store
    has the overwritten slot's ``valid`` cleared (never left holding an
    m-stale pair), which is what keeps ``(head-1) % m`` the true newest
    for the γ scaling.  Used by ops/varpro.py, whose history rows are
    field-sized (a per-lane head would gather a field-sized row per lane
    and slot every step); :func:`batched_lbfgs` itself keeps the exact
    per-lane head."""
    B = g.shape[0]

    def bwd(j, carry):
        q, alphas = carry
        idx = (head - 1 - j) % m
        v = valid[idx]                                   # (B,)
        a = rho[idx] * jnp.sum(S[idx] * q, axis=-1)      # (B,)
        a = jnp.where(v, a, 0.0)
        q = q - (a * v)[:, None] * Y[idx]
        return q, alphas.at[j].set(a)

    q, alphas = lax.fori_loop(0, m, bwd, (g, jnp.zeros((m, B), g.dtype)))

    newest = (head - 1) % m
    sy = jnp.sum(S[newest] * Y[newest], axis=-1)
    yy = jnp.sum(Y[newest] * Y[newest], axis=-1)
    gamma = jnp.where(valid[newest] & (yy > 0),
                      sy / jnp.maximum(yy, 1e-30), 1.0)
    r = gamma[:, None] * q

    def fwd(j_rev, r):
        j = m - 1 - j_rev
        idx = (head - 1 - j) % m
        v = valid[idx]
        b = rho[idx] * jnp.sum(Y[idx] * r, axis=-1)
        b = jnp.where(v, b, 0.0)
        return r + ((alphas[j] - b) * v)[:, None] * S[idx]

    r = lax.fori_loop(0, m, fwd, r)
    return -r


@partial(jax.jit, static_argnames=(
    "fn", "m", "max_iters", "max_ls", "c1"))
def batched_lbfgs(
    fn: Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]],
    z0: jnp.ndarray,
    *,
    g_atol=1e-2,
    m: int = 10,
    max_iters: int = 500,
    max_ls: int = 25,
    c1: float = 1e-4,
) -> LbfgsResult:
    """Minimize ``fn`` over a batch of lanes in lockstep.

    Args:
      fn: batched value-and-grad, ``(B, N) -> ((B,), (B, N))``.  Must be pure
        (it is traced once); per-lane data (e.g. each sim's x) should be
        closed over as batched arrays.
      z0: ``(B, N)`` initial iterates (warm starts).
      g_atol: sup-norm gradient tolerance (scalar or ``(B,)``).
    Returns:
      :class:`LbfgsResult`.
    """
    B, N = z0.shape
    dtype = z0.dtype
    g_atol = jnp.broadcast_to(jnp.asarray(g_atol, dtype), (B,))

    f0, g0 = fn(z0)
    bad0 = ~(jnp.isfinite(f0) & jnp.all(jnp.isfinite(g0), axis=-1))
    conv0 = jnp.max(jnp.abs(g0), axis=-1) < g_atol

    init = _State(
        z=z0, f=f0, g=g0,
        S=jnp.zeros((m, B, N), dtype), Y=jnp.zeros((m, B, N), dtype),
        rho=jnp.zeros((m, B), dtype),
        valid=jnp.zeros((m, B), bool),
        head=jnp.zeros((B,), jnp.int32),
        k=jnp.zeros((), jnp.int32),
        converged=conv0, failed=bad0,
        iters=jnp.zeros((B,), jnp.int32),
    )

    def cond(st: _State):
        return (st.k < max_iters) & ~jnp.all(st.converged | st.failed)

    def body(st: _State):
        active = ~(st.converged | st.failed)                      # (B,)

        d = _two_loop(st.g, st.S, st.Y, st.rho, st.valid, st.head, m)
        # Safeguard: fall back to steepest descent on non-descent directions.
        dg = jnp.sum(d * st.g, axis=-1)                           # (B,)
        descent = dg < 0
        d = jnp.where(descent[:, None], d, -st.g)
        dg = jnp.where(descent, dg, -jnp.sum(st.g * st.g, axis=-1))

        # First step: scale to unit-ish step (Optim alphaguess analog).
        gnorm = jnp.linalg.norm(st.g, axis=-1)
        a0 = jnp.where(st.k == 0,
                       jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm, 1e-12)),
                       1.0).astype(dtype)

        # --- backtracking Armijo line search, lockstep with accept masks ---
        def ls_cond(carry):
            t, accepted, *_ = carry
            return (t < max_ls) & ~jnp.all(accepted | ~active)

        def ls_body(carry):
            t, accepted, alpha, z_new, f_new, g_new = carry
            z_try = st.z + alpha[:, None] * d
            f_try, g_try = fn(z_try)
            ok = (f_try <= st.f + c1 * alpha * dg) & jnp.isfinite(f_try)
            take = ok & ~accepted
            z_new = jnp.where(take[:, None], z_try, z_new)
            f_new = jnp.where(take, f_try, f_new)
            g_new = jnp.where(take[:, None], g_try, g_new)
            accepted = accepted | ok
            alpha = jnp.where(accepted, alpha, alpha * 0.5)
            return t + 1, accepted, alpha, z_new, f_new, g_new

        carry0 = (jnp.zeros((), jnp.int32), jnp.zeros((B,), bool), a0,
                  st.z, st.f, st.g)
        _, accepted, _, z_new, f_new, g_new = lax.while_loop(
            ls_cond, ls_body, carry0)

        step_ok = accepted & active
        bad = ~(jnp.isfinite(f_new) & jnp.all(jnp.isfinite(g_new), axis=-1))
        step_ok = step_ok & ~bad

        z1 = jnp.where(step_ok[:, None], z_new, st.z)
        f1 = jnp.where(step_ok, f_new, st.f)
        g1 = jnp.where(step_ok[:, None], g_new, st.g)

        # --- curvature-checked history update (masked circular buffer,
        # per-lane write index: a lane only advances ITS head when IT
        # stores, so each lane's buffer is a true chronological ring) ---
        s = z1 - st.z
        y = g1 - st.g
        sy = jnp.sum(s * y, axis=-1)
        store = step_ok & (sy > 1e-10 * jnp.sum(y * y, axis=-1))
        slot = st.head % m                                        # (B,)
        lanes = jnp.arange(B)
        S = st.S.at[slot, lanes].set(
            jnp.where(store[:, None], s, _take_slot(st.S, slot)))
        Y = st.Y.at[slot, lanes].set(
            jnp.where(store[:, None], y, _take_slot(st.Y, slot)))
        rho = st.rho.at[slot, lanes].set(
            jnp.where(store, 1.0 / jnp.maximum(sy, 1e-30),
                      _take_slot(st.rho, slot)))
        valid = st.valid.at[slot, lanes].set(
            _take_slot(st.valid, slot) | store)

        conv = st.converged | (active & (jnp.max(jnp.abs(g1), axis=-1) < g_atol))
        # A lane whose line search exhausted all trials without acceptance
        # cannot make progress — freeze it as failed (≈ Optim non-convergence
        # warning, reference src/interface.jl:168-171).
        failed = st.failed | (active & bad) | (active & ~accepted & ~conv)

        return _State(
            z=z1, f=f1, g=g1, S=S, Y=Y, rho=rho, valid=valid,
            head=st.head + store.astype(jnp.int32), k=st.k + 1,
            converged=conv, failed=failed,
            iters=st.iters + active.astype(jnp.int32),
        )

    st = lax.while_loop(cond, body, init)
    return LbfgsResult(
        z=st.z, f=st.f, g=st.g,
        converged=st.converged, failed=st.failed,
        iterations=st.iters,
        g_norm=jnp.max(jnp.abs(st.g), axis=-1),
    )
