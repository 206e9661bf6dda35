"""J and H estimators for the MUSE covariance.

Ports of ``get_J!`` (reference ``src/muse.jl:484-532``) and ``get_H!``
(``src/muse.jl:296-450``), with the reference's per-sim ``pmap`` pipelines
re-expressed as single batched compiled calls:

  * get_J: per-sim [sample at θ₀ → MAP warm-started from the TRUE z →
    ∇θ logLike] runs as one lockstep batch; J is the corrected sample
    covariance of the per-sim scores (src/muse.jl:529).  Incremental: only
    ``nsims − len(result.gs)`` new sims run (src/muse.jl:499-506), and the
    key array indexing reproduces the reference's
    ``split_rng(rng, nsims)[existing+1:end]`` superset-prefix semantics.

  * get_H finite-difference mode: sims × θ-columns × ±stencil all batch
    into one solve (see ``CompiledProblem.h_fd``) — the lockstep answer to
    the reference's pmap_over=:sims/:jac pool routing (src/muse.jl:329-333).
    The FD step defaults to 0.1σ estimated from result.gs
    (src/muse.jl:411-414), so run get_J first.

  * get_H implicit-diff mode: jvp-over-grad jacobians + matrix-free CG
    (src/muse.jl:335-405); CG residuals land in
    ``result.metadata["implicit_diff_cg_resid"]`` (:405 analog).

Per-sim fault tolerance: ``skip_errors=True`` drops failed lanes (NaN MAP
or line-search stall) with a warning instead of raising — the masked-lane
analog of the reference's ``missing`` + ``skipmissing`` (src/muse.jl:515-521).
"""

from __future__ import annotations

import warnings
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..problem import MuseProblem
from ..result import MuseResult
from ..utils.keys import as_key, sim_keys
from ..utils.progress import ProgressReporter
from .compiled import CompiledProblem
from .covariance import finalize_result

__all__ = ["get_J", "get_H", "sample_covariance"]


def sample_covariance(gs: np.ndarray) -> np.ndarray:
    """Corrected sample covariance — ``SimpleCovariance(corrected=true)``
    default (src/muse.jl:495,529)."""
    return np.atleast_2d(np.cov(np.asarray(gs), rowvar=False, ddof=1))


def _key_chunks(keys, max_batch, mesh, fft_n=None, certifier=None,
                kind=None):
    """Yield (device_keys, true_count) chunks of the per-sim key array.

    ``max_batch`` bounds device memory (the BatchWorkerPool analog,
    src/util.jl:79-83): each chunk is padded to exactly ``max_batch``
    lanes so every chunk reuses one compiled shape; padded lanes compute
    discarded work.  With a mesh, each chunk is sharded over the sims
    axis.  ``fft_n`` (a problem's declared ``fft_grid``) triggers the
    empirical fused-FFT integrity check at the chosen per-device width.
    ``certifier``/``kind`` route the width away from batch sizes a
    previous value-integrity probe found corrupted (solver/certify.py).
    """
    import jax.numpy as jnp

    from ..utils.fft_check import (pad_lanes_to, safe_lane_count,
                                   validate_fft_lanes)

    n = keys.shape[0]
    step = n if max_batch is None else max_batch
    # odd *per-device* padded width: even batched-FFT lane counts were
    # miscompiled on the first accelerator (utils/fft_check.py); under a
    # mesh the width is a device-count multiple with odd shards.
    # Routing is re-checked before every chunk so a failed verdict
    # MID-pass moves the remaining chunks to the fallback width instead
    # of silently taking the lane-wise fallback for the rest of the run.
    n_shards = mesh.n_sims_shards if mesh is not None else 1
    width = safe_lane_count(step, n_shards)
    validated = set()
    i = 0
    while i < n:
        if certifier is not None:
            rw = certifier.route_width(kind, width)
            if rw != width:
                step = max(1, min(step, rw))
                width = safe_lane_count(step, n_shards)
        if fft_n and width not in validated:
            validate_fft_lanes(fft_n, width, n_shards)
            validated.add(width)
        chunk = keys[i:i + step]
        c = chunk.shape[0]
        chunk = pad_lanes_to(chunk, width)
        if mesh is not None:
            chunk = mesh.shard_sims(chunk)
        yield chunk, c
        i += step


def _mk_certifier(comp, certify, problem, n_rem, max_batch, mesh):
    """Resolve the ``certify`` kwarg against the planned chunk width
    (solver/certify.py)."""
    from ..utils.fft_check import safe_lane_count
    from .certify import certify_enabled

    n_shards = mesh.n_sims_shards if mesh is not None else 1
    step = n_rem if max_batch is None else max_batch
    width0 = safe_lane_count(step, n_shards)
    return (comp.certifier
            if certify_enabled(certify, problem, width0, nz=comp.nz)
            else None)


def _certified_sim_chunk(comp, certifier, kind, call, chunk, c,
                         th_dev, atol_dev, warm):
    """Run one per-sim batched chunk (``call(keys)``), value-certified.

    When the certifier is active, 1-2 lanes of the chunk's MAP output
    are re-solved with the independently compiled B=1 program and
    compared (solver/certify.py); a failed verdict re-runs the chunk
    lane-by-lane with that B=1 program (per-sim chunks contain exactly
    one MAP per lane, so the B=1 instantiation IS the certified
    reference).  ``warm`` names the chunk's warm-start rule so the probe
    reconstructs lane inputs: "true_z" (get_J, src/muse.jl:511-512) or
    "guess" (get_H fiducial fits, src/muse.jl:417-423).
    """
    import jax

    w = chunk.shape[0]

    def lanewise():
        ch = jnp.asarray(jax.device_get(chunk))
        return certifier.rerun_lanewise(call, c,
                                        lambda j: (ch[j:j + 1],))

    if certifier is not None and certifier.is_bad(kind, w):
        return lanewise()
    out = call(chunk)
    if certifier is not None and certifier.should_probe(kind, w):
        ch = jnp.asarray(jax.device_get(chunk))
        cache = {}

        def xz(j):
            if j not in cache:
                x, z = certifier._sample1(ch[j], th_dev)
                z0 = (z if warm == "true_z"
                      else certifier._guess1(x, z, th_dev))
                cache[j] = (x, z0)
            return cache[j]

        lanes = certifier.probe_lane_set(kind, w, c)
        if not certifier.probe(kind, w, lanes, lambda j: xz(j)[0],
                               lambda j: xz(j)[1], out["Z"],
                               th_dev, atol_dev):
            return lanewise()
    return out


def _certified_h_fd_chunk(certifier, comp, chunk, c, th, step_now,
                          offsets, Zfid, atol, dtype, n_shards):
    """Value-certified finite-difference H chunk.

    The batched ``h_fd`` program fans each sims chunk out into
    nsims·nθ·stencil internal MAP lanes (compiled.py), so its probe maps
    internal lane ℓ back to (sim s, θ-column j, stencil offset k),
    reconstructs that lane's inputs — x sampled at the perturbed θ with
    the sim's key, warm start = the sim's fiducial fit — and re-solves
    at the FIDUCIAL θ with the B=1 program (src/muse.jl:426-433
    semantics).  The lane-wise fallback rebuilds every FD gradient with
    the B=1 solve + an independent ∇θ evaluator, reporting convergence
    from the TRUE gradient sup-norm.
    """
    import jax

    ntheta = th.shape[0]
    ns = len(offsets)
    th_dev = jnp.asarray(th, dtype)
    atol_dev = jnp.asarray(atol, dtype)
    w = chunk.shape[0]

    def pert(ell):
        s, j, k = (ell // (ntheta * ns), (ell // ns) % ntheta, ell % ns)
        th_p = np.array(th, np.float64)
        th_p[j] += offsets[k] * step_now[j]
        return s, th_p

    def lanewise():
        ch = jnp.asarray(jax.device_get(chunk))
        Zf = jnp.asarray(jax.device_get(Zfid))
        g = np.zeros((c, ntheta, ns, ntheta))
        conv = np.zeros((c, ntheta, ns), bool)
        fail = np.zeros((c, ntheta, ns), bool)
        for s in range(c):
            for j in range(ntheta):
                for k in range(ns):
                    _, th_p = pert((s * ntheta + j) * ns + k)
                    x, _ = certifier._sample1(
                        ch[s], jnp.asarray(th_p, dtype))
                    Z1 = certifier._solve1(x, Zf[s], th_dev, atol_dev)
                    f1, gsup = certifier._fg1(x, Z1, th_dev)
                    g[s, j, k] = np.asarray(
                        certifier._gradth1(x, Z1, th_dev), np.float64)
                    fail[s, j, k] = not np.isfinite(float(f1))
                    conv[s, j, k] = (not fail[s, j, k]
                                     and float(gsup) < float(atol))
        return {"g": g, "converged": conv, "failed": fail}

    if certifier is not None and certifier.is_bad("h_fd", w):
        return lanewise()
    out = comp.h_fd(chunk, th_dev, jnp.asarray(step_now, dtype), Zfid,
                    atol_dev, jnp.asarray(offsets, dtype),
                    n_shards=n_shards)
    if certifier is not None and certifier.should_probe("h_fd", w):
        ch = jnp.asarray(jax.device_get(chunk))
        Zf = jnp.asarray(jax.device_get(Zfid))
        lanes = certifier.probe_lane_set("h_fd", w, c * ntheta * ns)

        def x_of(ell):
            s, th_p = pert(ell)
            x, _ = certifier._sample1(ch[s], jnp.asarray(th_p, dtype))
            return x

        def z0_of(ell):
            return Zf[ell // (ntheta * ns)]

        if not certifier.probe("h_fd", w, lanes, x_of, z0_of,
                               out["Z"], th_dev, atol_dev):
            return lanewise()
    return out


def _certified_h_impl_chunk(certifier, call, chunk, c):
    """Value-certified implicit-diff H chunk: ``call(keys)`` is the
    vmapped per-sim H pipeline; the probe re-runs the first lane alone
    (a fresh B=1 XLA program) and compares the H matrices — 5% entrywise
    agreement is far looser than fp divergence and far tighter than the
    measured corruption family (solver/certify.py)."""
    import warnings

    import jax

    w = chunk.shape[0]

    def lanewise():
        ch = jnp.asarray(jax.device_get(chunk))
        parts = [call(ch[j:j + 1]) for j in range(c)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]))

    if certifier is not None and certifier.is_bad("h_implicit", w):
        return lanewise()
    Hs_c, resid_c = call(chunk)
    if certifier is not None and certifier.should_probe("h_implicit", w):
        ch = jnp.asarray(jax.device_get(chunk))
        H_ref = np.asarray(call(ch[:1])[0], np.float64)[0]
        H_b = np.asarray(Hs_c, np.float64)[0]
        scale = max(float(np.max(np.abs(H_ref))), 1e-30)
        if (not np.isfinite(H_b).all()
                or float(np.max(np.abs(H_b - H_ref))) >
                certifier.rtol * scale):
            certifier._bad.add(("h_implicit", w))
            certifier.events.append(
                {"kind": "h_implicit", "width": w, "lane": 0,
                 "H_batch_max": float(np.max(np.abs(H_b))),
                 "H_ref_max": float(np.max(np.abs(H_ref)))})
            warnings.warn(
                "VALUE-INTEGRITY CERTIFICATION FAILED for the compiled "
                f"implicit-diff H program at batch width {w}: lane 0 "
                f"re-run alone gives max|H| {np.max(np.abs(H_ref)):.6g} "
                f"but the batched program produced "
                f"{np.max(np.abs(H_b)):.6g}. Re-running the chunk "
                "lane-by-lane (see muse_tpu/solver/certify.py).")
            return lanewise()
    return Hs_c, resid_c


def _as_problem(problem, theta0, observed):
    """Direct-on-model overload shared by get_J/get_H: a bare PPL model
    function + ``observed={site: value}`` builds the problem on the fly
    (the ``get_J!(result, model, θ₀)`` analog, src/turing.jl:248-256,
    src/soss.jl:145-153)."""
    if callable(problem) and not isinstance(problem, MuseProblem):
        if observed is None:
            raise ValueError(
                "get_J/get_H on a model function needs observed={site: "
                "value} to condition the model (the `model | (;x)` analog)")
        if theta0 is None:
            raise ValueError("get_J/get_H on a model function needs θ₀ "
                             "(hyper sites are inferred from its keys)")
        from ..ppl import model_problem
        return model_problem(problem, theta0, observed=observed)
    if observed is not None:
        raise ValueError("observed= is only valid with a model function")
    return problem


def _setup(result: MuseResult, problem: MuseProblem, theta0, key, dtype,
           compiled: Optional[CompiledProblem]):
    theta_start = theta0 if theta0 is not None else result.theta
    if theta_start is None:
        raise ValueError("θ₀ must be given (or present in result)")
    from .muse import resolve_spec
    spec = resolve_spec(result, theta_start, dtype)
    th = np.asarray(spec.flatten(theta_start), np.float64)
    if result.theta is None:
        result.theta = th
    if result.theta_struct is None:
        result.theta_struct = spec.to_user(th)
    key = as_key(key) if key is not None else (
        result.key if result.key is not None else
        __import__("jax").random.PRNGKey(0))
    result.key = key
    comp = compiled or CompiledProblem(problem, spec, th, dtype=dtype)
    return spec, th, key, comp


def get_J(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    key=None,
    nsims: int = 100,
    grad_z_atol: float = 1e-2,
    skip_errors: bool = False,
    covariance_method=sample_covariance,
    max_batch=None,
    mesh=None,
    dtype=jnp.float32,
    compiled: Optional[CompiledProblem] = None,
    progress: bool = False,
    observed=None,
    warn_reuse: bool = True,
    checkpoint_file: Optional[str] = None,
    certify="auto",
) -> MuseResult:
    """Monte-Carlo covariance of MAP score gradients at θ₀ (``get_J!``).

    Incremental/resume semantics (src/muse.jl:499-506): scores already in
    ``result.gs`` — including the fit's own per-sim scores stored by
    ``muse_fit`` (src/muse.jl:231) — count toward ``nsims``; only the
    remainder is simulated.  An explicit call that reuses existing scores
    warns (the internal ``get_covariance`` flow, where this reuse is the
    reference's designed behavior, does not).

    Scores are appended to ``result.gs`` as each device chunk completes,
    and ``checkpoint_file`` (beyond-reference; the muse_fit checkpoint
    analog, src/muse.jl:234) saves the result after every chunk — a
    flagship-scale J killed mid-run resumes at chunk granularity via
    ``load_result`` + the same call.  CRN prefix identity makes the
    resume exact as long as no sims were dropped by ``skip_errors``.

    ``problem`` may also be a PPL model function with ``observed=``
    (src/turing.jl:248-256 overload analog)."""
    problem = _as_problem(problem, theta0, observed)
    spec, th, key, comp = _setup(result, problem, theta0, key, dtype,
                                 compiled)
    nsims_existing = len(result.gs)
    nsims_remaining = nsims - nsims_existing

    # reliability mask for reused fit scores (muse_fit stores the final
    # iteration's per-sim MAP convergence): an unconverged lane's score
    # is computed at a non-stationary ẑ and can inflate J by orders of
    # magnitude (measured: one straggler 256² lensing lane → J/H ≈ 38,
    # σ 7× the realization scatter).
    drop_reused = np.zeros(nsims_existing, bool)
    gs_mask = result.metadata.get("gs_converged")
    if gs_mask is not None and len(gs_mask) != nsims_existing:
        # a stale mask must not silently deactivate the guard (advisor
        # finding: pre-fix get_J appended scores without extending it)
        warnings.warn(
            f"get_J: metadata['gs_converged'] has {len(gs_mask)} entries "
            f"but result.gs holds {nsims_existing} scores — the "
            "reliability mask is stale; discarding it and treating the "
            "existing scores as converged (reference reuse semantics, "
            "src/muse.jl:499-506).")
        gs_mask = None
        result.metadata.pop("gs_converged", None)
    if nsims_existing and gs_mask is not None:
        bad = ~np.asarray(gs_mask, bool)
        if bad.any():
            if skip_errors:
                drop_reused = bad
                warnings.warn(
                    f"get_J: dropping {int(bad.sum())}/{nsims_existing} "
                    "reused fit scores whose MAP solves had not converged "
                    "(skip_errors=True; beyond-reference guard — the "
                    "reference reuses them silently, src/muse.jl:231).")
            else:
                warnings.warn(
                    f"get_J: {int(bad.sum())}/{nsims_existing} reused fit "
                    "scores come from MAP solves that did not converge — "
                    "J may be inflated. Pass skip_errors=True to drop "
                    "them, or clear result.gs for a fresh estimate.")

    if nsims_existing and warn_reuse:
        # the reference's resume semantics (src/muse.jl:231,499-506): a
        # result that went through muse!/muse_fit already carries the
        # fit's per-sim scores in result.gs, and only nsims_remaining
        # fresh sims are added.  Fit scores come from warm-started MAP
        # solves; on multi-basin latent landscapes (large lensing fields)
        # they select basins more consistently than fresh true-z-started
        # solves, which is the variance the θ̂ root actually sees — see
        # BENCHMARKS.md "Which J is the right one".  Surface the reuse so
        # it is never silent.
        warnings.warn(
            f"get_J: reusing {nsims_existing} existing per-sim scores "
            f"(fit or previous get_J); only {max(nsims_remaining, 0)} new "
            "sims will run. Clear result.gs or use a fresh MuseResult for "
            "an independent re-estimate (reference resume semantics, "
            "src/muse.jl:499-506).")
    drop_new = []
    if nsims_remaining > 0:
        keys = sim_keys(key, nsims)[nsims_existing:]
        n_dropped = n_nonconv = n_run = 0
        # keep the reliability mask aligned with result.gs as new scores
        # are appended, so the reused-score guard above still works on a
        # later resume (an absent mask for pre-existing scores means
        # "no convergence info" — recorded as converged, the reference's
        # silent-reuse semantics)
        mask_list = (list(np.asarray(gs_mask, bool))
                     if gs_mask is not None
                     else [True] * nsims_existing)
        certifier = _mk_certifier(comp, certify, problem, nsims_remaining,
                                  max_batch, mesh)
        th_dev = jnp.asarray(th, dtype)
        atol_dev = jnp.asarray(grad_z_atol, dtype)
        # per-sim progress ticks, one per completed device chunk (the
        # RemoteProgress analog, src/muse.jl:507); scores land in
        # result.gs per chunk so a mid-run kill loses at most one chunk
        pbar = ProgressReporter(nsims_remaining, "get_J", enabled=progress)
        try:
            for chunk, c in _key_chunks(keys, max_batch, mesh,
                                        getattr(problem, "fft_grid", None),
                                        certifier, "j_sims"):
                out = _certified_sim_chunk(
                    comp, certifier, "j_sims",
                    lambda k1: comp.j_sims(k1, th_dev, atol_dev),
                    chunk, c, th_dev, atol_dev, warm="true_z")
                g_c = np.asarray(out["g"], np.float64)[:c]
                failed_c = np.asarray(out["failed"])[:c]
                nonconv_c = np.zeros(c, bool)
                if "converged" in out:
                    # the reference emits this from inside every ẑ_at_θ
                    # call (src/interface.jl:168-171); aggregated below
                    nonconv_c = (~np.asarray(out["converged"])[:c]
                                 & ~failed_c)
                    n_nonconv += int(nonconv_c.sum())
                n_run += c
                if failed_c.any():
                    if not skip_errors:
                        raise RuntimeError(
                            f"get_J: {int(failed_c.sum())}/{c} MAP solves "
                            "failed; pass skip_errors=True to drop them.")
                    n_dropped += int(failed_c.sum())
                    g_c = g_c[~failed_c]
                    nonconv_c = nonconv_c[~failed_c]
                result.gs.extend(list(g_c))
                mask_list.extend(list(~nonconv_c))
                result.metadata["gs_converged"] = np.asarray(mask_list,
                                                             bool)
                # under skip_errors, unconverged scores are also excluded
                # from the J estimate (kept in result.gs for CRN-exact
                # resume) — same rationale as the reused-score guard above
                drop_new.extend(list(nonconv_c if skip_errors
                                     else np.zeros(len(g_c), bool)))
                if checkpoint_file is not None:
                    result.save(checkpoint_file)
                pbar.step(inc=c)
        finally:
            pbar.close()
        if n_nonconv:
            warnings.warn(
                f"get_J: {n_nonconv}/{n_run} MAP solves did not converge "
                "within tolerance; their scores feed J unconverged "
                "(reference semantics, src/interface.jl:168-171).")
        if n_dropped:
            warnings.warn(f"get_J: dropping {n_dropped} failed sims")

    gs = np.asarray(result.gs)
    drop = np.concatenate([drop_reused,
                           np.asarray(drop_new, bool)]) \
        if (drop_reused.any() or any(drop_new)) else None
    if drop is not None and len(drop) == len(gs):
        if (~drop).sum() < 2:
            raise RuntimeError(
                "get_J: fewer than 2 reliable per-sim scores remain after "
                "dropping unconverged/failed MAPs — rerun with a larger "
                "nsims or looser grad_z_atol.")
        gs = gs[~drop]
    result.J = (np.atleast_2d(np.var(gs, ddof=1)) if gs.shape[1] == 1
                and gs.ndim == 2 else covariance_method(gs))
    finalize_result(result, comp)
    return result


def get_H(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    key=None,
    nsims: int = 10,
    grad_z_atol: float = 1e-2,
    step=None,
    fd_order: int = 2,
    skip_errors: bool = False,
    implicit_diff: bool = False,
    implicit_diff_H1_is_zero: bool = False,
    implicit_diff_cg_maxiter: int = 100,
    implicit_diff_cg_tol: float = 1e-6,
    implicit_diff_precond=None,
    implicit_fit_atol: float = 1e-1,
    max_batch=None,
    mesh=None,
    dtype=jnp.float32,
    compiled: Optional[CompiledProblem] = None,
    progress: bool = False,
    observed=None,
    checkpoint_file: Optional[str] = None,
    certify="auto",
) -> MuseResult:
    """Mean Jacobian of the MAP score wrt the sim-generation θ (``get_H!``).

    In implicit-diff mode and fixed-step FD mode, per-sim Jacobians land
    in ``result.Hs`` as each device chunk completes, and
    ``checkpoint_file`` saves the result after every chunk (see
    ``get_J``) — resume at chunk granularity via ``load_result`` + the
    same call (``result.Hs`` counts toward ``nsims``,
    src/muse.jl:317-319).  With ``fd_order="adaptive"`` the step may be
    rebalanced and the stencil pass redone, so Hs finalize — and the
    checkpoint is written — only once, after the last round.

    ``problem`` may also be a PPL model function with ``observed=``
    (src/turing.jl:248-256 overload analog).

    ``fd_order=2`` is plain central differences; ``fd_order=4`` the
    5-point Richardson stencil; ``fd_order="adaptive"`` reproduces the
    ROLE of the reference's adaptive ``central_fdm(3,1)``
    (src/muse.jl:300): it runs the 4-offset stencil, estimates the
    truncation error from the ε-vs-2ε discrepancy and the roundoff floor
    from the score magnitude, rebalances the per-column step
    ε* = ε·(round/trunc)^{1/3}, and re-runs (≤2 extra batched passes)
    until the two error sources are within an order of magnitude; the
    final H uses the Richardson combination.  Per-round steps/estimates
    land in ``result.metadata["fd_adaptive"]``.  The implicit-diff mode
    remains exact and is the recommended mode here.

    ``implicit_diff_precond`` is the reference's ``Pl`` CG-preconditioner
    hook (``implicit_diff_cg_kwargs``, src/muse.jl:312,380-384): a callable
    ``(w, x, theta_flat) -> M⁻¹ w`` applied to flat z-space vectors inside
    the per-column CG solves (jax.scipy cg's ``M``).  For ill-conditioned
    z-Hessians (lensing, explicit-C GRF) this is the difference between H
    converging within ``implicit_diff_cg_maxiter`` or not.

    Tolerance note for NONLINEAR models: both modes assume converged
    MAPs — the implicit formula needs exact stationarity of ẑ, the FD
    mode a converged fiducial fit.  The reference-parity defaults
    (``implicit_fit_atol=1e-1``, ``grad_z_atol=1e-2``) are fine for
    near-Gaussian problems but bias H by 10-30% on the lensing
    benchmark (its nonconvex latent landscape has near-stationary
    points whose curvature differs from the MAP's); at 1e-3 the two
    estimators agree to 0.01%
    (see tests/test_lensing.py::test_implicit_H_with_model_preconditioner).
    """
    problem = _as_problem(problem, theta0, observed)
    spec, th, key, comp = _setup(result, problem, theta0, key, dtype,
                                 compiled)
    ntheta = th.shape[0]
    nsims_existing = len(result.Hs)
    nsims_remaining = nsims - nsims_existing
    if nsims_remaining <= 0:
        _reduce_H(result, comp)
        return result

    keys = sim_keys(key, nsims, salt=1)[nsims_existing:]
    certifier = _mk_certifier(comp, certify, problem, nsims_remaining,
                              max_batch, mesh)

    if implicit_diff:
        n_dropped = 0
        h_impl = comp.h_implicit_with(implicit_diff_precond)
        resid_store = result.metadata.setdefault(
            "implicit_diff_cg_resid", [])

        def h_impl_call(ch):
            return h_impl(ch, jnp.asarray(th, dtype),
                          jnp.asarray(implicit_fit_atol, dtype),
                          implicit_diff_cg_maxiter, implicit_diff_cg_tol,
                          implicit_diff_H1_is_zero)

        pbar = ProgressReporter(nsims_remaining, "get_H", enabled=progress)
        try:
            for chunk, c in _key_chunks(keys, max_batch, mesh,
                                        getattr(problem, "fft_grid", None),
                                        certifier, "h_implicit"):
                Hs_c, resid_c = _certified_h_impl_chunk(
                    certifier, h_impl_call, chunk, c)
                Hs_c = np.asarray(Hs_c, np.float64)[:c]
                resid_c = np.asarray(resid_c)[:c]
                bad = ~np.isfinite(Hs_c).all(axis=(1, 2))
                if bad.any():
                    if not skip_errors:
                        raise RuntimeError(
                            f"get_H: {int(bad.sum())}/{c} implicit-diff "
                            "sims produced non-finite H; pass "
                            "skip_errors=True.")
                    n_dropped += int(bad.sum())
                    Hs_c, resid_c = Hs_c[~bad], resid_c[~bad]
                result.Hs.extend(list(Hs_c))
                resid_store.extend(list(resid_c))
                if checkpoint_file is not None:
                    result.save(checkpoint_file)
                pbar.step(inc=c)
        finally:
            pbar.close()
        if n_dropped:
            warnings.warn(f"get_H: dropping {n_dropped} failed sims")
    else:
        # FD step ≈ 0.1σ from the J sims (src/muse.jl:411-414)
        if step is None:
            if not result.gs:
                raise ValueError(
                    "get_H: no `step` given and result.gs is empty — run "
                    "get_J first (the reference's recommendation, "
                    "src/muse.jl:284-286) or pass `step` explicitly.")
            step = 0.1 / np.std(np.asarray(result.gs), axis=0, ddof=1)
        step = np.array(np.broadcast_to(np.asarray(step, np.float64),
                                        (ntheta,)))

        # fiducial fits: warm starts for every FD evaluation
        # (src/muse.jl:417-423; the reference's rngs-shadowing quirk is
        # intentionally NOT replicated — each sim uses its own key)
        # central-difference stencil: order 2 → (±ε), order 4/adaptive →
        # (±ε, ±2ε)
        adaptive = fd_order == "adaptive"
        if fd_order == 2:
            offsets = np.array([1.0, -1.0])
            weights = np.array([0.5, -0.5])
        elif fd_order == 4 or adaptive:
            offsets = np.array([1.0, -1.0, 2.0, -2.0])
            weights = np.array([8.0, -8.0, -1.0, 1.0]) / 12.0
        else:
            raise ValueError("fd_order must be 2, 4, or 'adaptive'")

        n_shards = mesh.n_sims_shards if mesh is not None else 1
        fft_n = getattr(problem, "fft_grid", None)
        if fft_n:
            # the h_fd-internal flattened sims·nθ·stencil batch has its
            # own per-device width — validate it too
            from ..utils.fft_check import safe_lane_count, validate_fft_lanes
            w = safe_lane_count(nsims_remaining if max_batch is None
                                else max_batch, n_shards)
            validate_fft_lanes(
                fft_n, safe_lane_count(w * ntheta * len(offsets), n_shards),
                n_shards)

        # progress in the reference's units — nsims·(1+nθ·stencil) MAP
        # solves (src/muse.jl:325): 1 fiducial tick + nθ·S FD ticks per
        # sim; extra adaptive rounds grow the total as they start
        units_per_sim = 1 + ntheta * len(offsets)
        max_rounds = 3 if adaptive else 1
        pbar = ProgressReporter(nsims_remaining * units_per_sim,
                                "get_H", enabled=progress)

        # fiducial MAPs don't depend on the FD step, so adaptive
        # rebalancing rounds reuse the round-1 fits (the dominant cost
        # at field scale) instead of re-solving them.  Stored PER-SIM
        # (host array, filled as round 1 progresses) rather than
        # per-chunk: a failed certification verdict reroutes later
        # chunks to a smaller width, so chunk boundaries can differ
        # between rounds and a chunk-indexed cache would misalign.
        fid_store = {"Z": None, "filled": 0}

        def _to_Hs(g, failed, step_used):
            # stale-stencil guard: if the ±ε gradients are bitwise
            # IDENTICAL, the perturbed MAP re-solves never moved ẑ —
            # the fiducial warm start was already within grad_z_atol, so
            # every score row that depends on the data only through ẑ
            # collapses to an exactly-zero H entry (measured: the
            # adapter-parity model's H[θ,θ] = 0.0 at the default 1e-2;
            # at 1e-4 FD matches the implicit-diff H to 6 digits).
            stale = np.all(g[:, :, 0, :] == g[:, :, 1, :], axis=0)
            if stale.any() and g.shape[0] > 0:
                cols = sorted({int(j) for j, _ in np.argwhere(stale)})
                warnings.warn(
                    "get_H (FD mode): the ±ε stencil gradients are "
                    f"bitwise identical for θ_sim column(s) {cols} on "
                    f"{int(stale.sum())} (column, row) pairs — the "
                    "perturbed MAP re-solves did not move ẑ because the "
                    "fiducial warm start is already within grad_z_atol, "
                    "so H entries that flow only through ẑ are exactly "
                    "zero and σθ will be wrong. Tighten grad_z_atol "
                    "(e.g. 1e-4) or use implicit_diff=True (exact).")
            # H_sim[i,j] = d g_i / d θsim_j (columns = perturbed θ comp.)
            Hs = np.einsum("njsi,s->nji", g,
                           weights) / step_used[None, :, None]
            Hs = np.swapaxes(Hs, 1, 2)       # → (n, nθ rows, nθ cols)
            bad = failed | ~np.isfinite(Hs).all(axis=(1, 2))
            if bad.any() and not skip_errors:
                raise RuntimeError(
                    f"get_H: {int(bad.sum())}/{bad.size} FD sims failed; "
                    "pass skip_errors=True to drop them.")
            return Hs[~bad], int(bad.sum())

        def fd_pass(step_now, commit=None):
            """One full stencil pass; ``commit(g_c, failed_c)`` — when
            given — finalizes each chunk immediately (kill-resilient
            non-adaptive path); otherwise the whole pass is returned for
            the adaptive step-rebalance."""
            import jax

            from ..utils.fft_check import pad_lanes_to
            th_dev = jnp.asarray(th, dtype)
            atol_dev = jnp.asarray(grad_z_atol, dtype)
            g_parts, failed_parts = [], []
            pos = 0
            # route on BOTH kinds recorded inside this loop ("h_fiducial"
            # from the fiducial fits, "h_fd" from the stencil program):
            # a bad verdict under either must move later chunks to the
            # fallback width, not strand them on the lane-wise path
            for chunk, c in _key_chunks(keys, max_batch, mesh, fft_n,
                                        certifier, ("h_fd", "h_fiducial")):
                w = chunk.shape[0]
                if fid_store["filled"] < pos + c:
                    fid = _certified_sim_chunk(
                        comp, certifier, "h_fiducial",
                        lambda k1: comp.h_fiducial(k1, th_dev, atol_dev),
                        chunk, c, th_dev, atol_dev, warm="guess")
                    # a lane-wise fallback returns c (unpadded) lanes
                    Zc = np.asarray(jax.device_get(fid["Z"]))[:c]
                    if fid_store["Z"] is None:
                        fid_store["Z"] = np.zeros(
                            (len(keys),) + Zc.shape[1:], Zc.dtype)
                    fid_store["Z"][pos:pos + c] = Zc
                    fid_store["filled"] = pos + c
                    pbar.step(inc=c, msg="fiducial fits")
                Zfid_c = pad_lanes_to(
                    jnp.asarray(fid_store["Z"][pos:pos + c]), w)
                out = _certified_h_fd_chunk(
                    certifier, comp, chunk, c, th, step_now, offsets,
                    Zfid_c, grad_z_atol, dtype, n_shards)
                g_c = np.asarray(out["g"], np.float64)[:c]
                failed_c = np.asarray(out["failed"])[:c].any(axis=(1, 2))
                if commit is not None:
                    commit(g_c, failed_c)
                else:
                    g_parts.append(g_c)
                    failed_parts.append(failed_c)
                pbar.step(inc=c * ntheta * len(offsets), msg="FD columns")
                pos += c
            if commit is None:
                return np.concatenate(g_parts), np.concatenate(failed_parts)

        n_dropped = 0
        try:
            if not adaptive:
                # per-chunk commit + checkpoint, same kill-resilience as
                # the implicit path (fixed step → each chunk's Hs final)
                def commit(g_c, failed_c):
                    nonlocal n_dropped
                    Hs_c, dropped = _to_Hs(g_c, failed_c, step)
                    n_dropped += dropped
                    result.Hs.extend(list(Hs_c))
                    if checkpoint_file is not None:
                        result.save(checkpoint_file)

                fd_pass(step, commit=commit)
            else:
                rounds_meta = []
                for round_i in range(max_rounds):
                    if round_i:
                        pbar.grow(nsims_remaining * (units_per_sim - 1))
                    step_used = step.copy()
                    g, failed = fd_pass(step)  # g: (nsims, nθ, S, nθ)
                    # per-column error balance (central_fdm's adaptive
                    # role): truncation of the ε estimate ≈ |d_ε−d_2ε|/3,
                    # roundoff ≈ eps_f32·scale(g)/ε; balance c·ε² = δ/ε
                    # at ε* = ε·(round/trunc)^(1/3)
                    d_e = (g[:, :, 0, :] - g[:, :, 1, :]) / (
                        2 * step[None, :, None])
                    d_2e = (g[:, :, 2, :] - g[:, :, 3, :]) / (
                        4 * step[None, :, None])
                    trunc = np.sqrt(np.mean((d_e - d_2e) ** 2,
                                            axis=(0, 2))) / 3.0
                    g_scale = np.sqrt(np.mean(g ** 2, axis=(0, 2, 3)))
                    roundoff = np.finfo(np.float32).eps * g_scale / step
                    ratio = roundoff / np.maximum(trunc, 1e-300)
                    rounds_meta.append({"step": step.copy(), "trunc": trunc,
                                        "roundoff": roundoff})
                    if np.all((ratio > 0.1) & (ratio < 10.0)):
                        break                   # balanced within 10×
                    step = step * np.clip(ratio ** (1.0 / 3.0), 0.05, 20.0)
                result.metadata["fd_adaptive"] = rounds_meta
                Hs, n_dropped = _to_Hs(g, failed, step_used)
                result.Hs.extend(list(Hs))
                if checkpoint_file is not None:
                    result.save(checkpoint_file)
        finally:
            pbar.close()
        if n_dropped:
            warnings.warn(f"get_H: dropping {n_dropped} failed sims")

    _reduce_H(result, comp)
    return result


def _reduce_H(result: MuseResult, comp: CompiledProblem):
    if result.Hs:
        result.H = np.mean(np.asarray(result.Hs, np.float64), axis=0)
    finalize_result(result, comp)
