"""The MUSE solver — outer quasi-Newton root-finder on the MUSE score.

Port of ``muse``/``muse!`` (reference ``src/muse.jl:61-250``), re-designed
for batched accelerator execution: all per-simulation work for an
iteration is a single compiled device step (``CompiledProblem.muse_step``);
the remaining per-iteration math — score assembly, H⁻¹ estimation
(sims-variance or Broyden replay), damped Newton step, convergence test —
is tiny dense linear algebra over θ, done on the host in float64 exactly
as the reference does it on the master process.

Feature parity checklist vs ``muse!``:
  * α step size, constant or schedule ``i -> α``        (src/muse.jl:145-149)
  * warm-started MAP solves across iterations            (:151, :181)
  * common random numbers: fixed per-sim key array       (:169 + util.jl:87-92)
  * score in transformed space, sims-mean subtraction    (:183-185)
  * H⁻¹_like′ via sims variance / :broyden /
    :diagonal_broyden with ``broyden_memory``            (:188-205)
  * H⁻¹_post′ = inv(inv(H⁻¹_like′) + H_prior′)           (:207-208)
  * θ_rtol convergence in the H⁻¹_post′ metric           (:163-165)
  * per-iteration history diagnostics + save_maps        (:211-221)
  * regularize hook                                      (:226)
  * checkpoint after every iteration, resume from
    ``len(result.history)``                              (:234, :159)
  * get_covariance ⇒ get_J(nsims) + get_H(nsims//10)     (:244-247)
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import MuseProblem
from ..result import MuseResult
from ..theta import ThetaSpec
from ..utils.keys import as_key, sim_keys
from ..utils.progress import ProgressReporter
from .compiled import CompiledProblem

__all__ = ["muse", "muse_fit"]


def muse(problem, theta0, *, observed=None, **kwargs) -> MuseResult:
    """One-shot MUSE estimate (``muse`` wrapper, src/muse.jl:107).

    ``problem`` may also be a PPL model *function* — the direct-on-model
    overload (``muse!(result, model, θ₀)``, src/turing.jl:248-256): pass
    ``observed={site: value}`` and the hyper sites are inferred from the
    keys of ``theta0`` (``ppl.model_problem``)."""
    if callable(problem) and not isinstance(problem, MuseProblem):
        if observed is None:
            raise ValueError(
                "muse(model_fn, θ₀) needs observed={site: value} to "
                "condition the model (the `model | (;x)` analog)")
        from ..ppl import model_problem
        problem = model_problem(problem, theta0, observed=observed)
    elif observed is not None:
        raise ValueError("observed= is only valid with a model function")
    return muse_fit(MuseResult(), problem, theta0, **kwargs)


def resolve_spec(result: MuseResult, theta_start, dtype) -> ThetaSpec:
    """Rebuild/attach the θ structure spec: prefer the live spec, then the
    checkpointed user structure (so a loaded result resumes with the
    original θ pytree, not a flat vector), then the given θ₀."""
    if result._spec is not None:
        spec = result._spec
    elif result.theta_struct is not None:
        spec = ThetaSpec.from_example(result.theta_struct, dtype=dtype)
    else:
        spec = ThetaSpec.from_example(theta_start, dtype=dtype)
    result._spec = spec
    result.theta_names = spec.names
    return spec


def muse_fit(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    key=None,
    z0=None,
    maxsteps: int = 50,
    theta_rtol: float = 1e-1,
    grad_z_atol: float = 1e-2,
    nsims: int = 100,
    alpha: Union[float, Callable[[int], float]] = 0.7,
    progress: bool = False,
    regularize: Optional[Callable] = None,
    Hinv_like=None,
    Hinv_update: str = "sims",
    broyden_memory: float = math.inf,
    checkpoint_file: Optional[str] = None,
    get_covariance: bool = False,
    save_maps=False,
    max_batch: Optional[int] = None,
    mesh=None,
    dtype=jnp.float32,
    compiled: Optional[CompiledProblem] = None,
    profile_dir: Optional[str] = None,
    certify="auto",
    hoist_sampling: bool = True,
) -> MuseResult:
    """Run/resume the MUSE iteration on ``result`` (``muse!`` analog).

    Args mirror the reference's keywords (src/muse.jl:112-131):
      theta_rtol   — ``θ_rtol``.  The default (1e-1) is reference parity
                     (src/muse.jl:119), but it measures σ-scaled STEP
                     size, not closeness to the score root: the repo's
                     256² calibration study measured it freezing damped
                     marches mid-run, and every shipped demo overrides
                     to 3e-4 — prefer that for production fits (round-5
                     measurement: 3e-3 still froze some 256² lensing
                     realizations mid-march).  A stop
                     that looks mid-march (final |g_post| still at its
                     running max and above the MC noise floor) warns.
      grad_z_atol  — ``∇z_logLike_atol``;
      Hinv_update  — "sims" | "broyden" | "diagonal_broyden";
      mesh         — optional :class:`muse_tpu.parallel.SimsMesh` to shard
                     the sims axis across devices (the worker-``pool``
                     analog, src/muse.jl:124);
      certify      — "auto" (default) | True | False: runtime
                     value-integrity certification of each batched MAP
                     chunk against an independently compiled B=1 program
                     (solver/certify.py — the guard for the compiler
                     batch-width value-corruption family).  "auto" turns
                     it on for field models (``fft_grid`` declared) on
                     non-CPU backends.  On a failed verdict the chunk is
                     re-run lane-wise and future chunks are routed to a
                     smaller width, so results stay correct (slower);
                     the warning says which width failed.
      hoist_sampling — when the problem declares the CRN white split
                     (``sample_white``/``x_of_white``, problem.py), draw
                     the θ-independent randomness ONCE before the loop
                     and run the hoisted iteration step; under common
                     random numbers this is exactly the keyed path's
                     math with the RNG lifted out of the hot loop (the
                     reference re-samples every iteration,
                     src/muse.jl:169-170).  False forces per-iteration
                     sampling (the certification fallback always uses
                     the keyed B=1 program either way).
    """
    if Hinv_update not in ("sims", "broyden", "diagonal_broyden"):
        raise ValueError(f"invalid Hinv_update={Hinv_update!r}")

    # --- rng / θ bookkeeping (src/muse.jl:134-136) ---
    result.key = key = as_key(key) if key is not None else (
        result.key if result.key is not None else jax.random.PRNGKey(0))

    theta_start = result.theta if result.theta is not None else theta0
    if theta_start is None:
        raise ValueError("θ₀ must be given (or present in result)")
    spec = resolve_spec(result, theta_start, dtype)

    th = np.asarray(spec.flatten(theta_start), np.float64)
    result.theta_struct = spec.to_user(th)

    comp = compiled or CompiledProblem(problem, spec, th, dtype=dtype)
    th_t = np.asarray(comp.transform(jnp.asarray(th, dtype)), np.float64)
    th_unreg, th_t_unreg = th.copy(), th_t.copy()

    alpha_fn = alpha if callable(alpha) else (lambda i, a=alpha: a)
    save_sims_maps = save_maps is not False
    if save_maps is True:
        save_maps = lambda z: np.asarray(z)
    elif save_maps is False:
        save_maps = lambda z: None

    history = result.history

    # per-lane keys: lane 0 is the data lane (its sample is masked out in
    # favor of x_obs inside muse_step), lanes 1.. are the fixed CRN sims
    B = nsims + 1
    dummy = jax.random.fold_in(as_key(key), 2 ** 31 - 1)
    keys_all = jnp.concatenate([dummy[None], sim_keys(key, nsims)])

    # warm-start cache: (nsims+1, nz); lane 0 = data (src/muse.jl:151)
    if z0 is not None:
        z0_flat = jnp.asarray(spec_flatten_z(comp, z0), dtype)
    else:
        z0_flat = jnp.zeros((comp.nz,), dtype)

    # memory-bounded lane chunks: each chunk is padded to a uniform size
    # (one compiled shape) and carries its global lane ids so the data
    # lane is recognized wherever it falls.  The padded width keeps the
    # *per-device* lane count ODD — on the first accelerator many even
    # batch sizes hit a miscompiled fused batched-FFT (silent ~30% power
    # deficit; see muse_tpu/utils/fft_check.py).  With a mesh the
    # width is additionally a multiple of the sims-axis device count so
    # mesh.shard_sims adds no further (even-making) padding.
    from ..utils.fft_check import (pad_lanes_to, safe_lane_count,
                                   validate_fft_lanes)
    from .certify import certify_enabled
    step_sz = B if max_batch is None else min(max_batch, B)
    n_shards = mesh.n_sims_shards if mesh is not None else 1
    width = safe_lane_count(step_sz, n_shards)
    certifier = (comp.certifier
                 if certify_enabled(certify, problem, width, nz=comp.nz)
                 else None)

    def make_chunks(z_rows_fn):
        """(Re)build the lane chunking at the currently routed width.
        ``z_rows_fn(s0, e0)`` supplies warm-start rows for those lanes."""
        nonlocal step_sz, width
        if certifier is not None:
            rw = certifier.route_width("muse_step", width)
            if rw != width:
                step_sz = min(step_sz, rw)
                width = safe_lane_count(step_sz, n_shards)
        if getattr(problem, "fft_grid", None):
            # empirical fused-FFT integrity check at the actual
            # per-device width — fail loudly rather than trust the
            # odd-lane rule on an untested backend (utils/fft_check.py)
            validate_fft_lanes(problem.fft_grid, width, n_shards)
        bounds = [(s0, min(s0 + step_sz, B)) for s0 in range(0, B, step_sz)]
        ks, zs, ls = [], [], []
        for s0, e0 in bounds:
            kc = pad_lanes_to(keys_all[s0:e0], width)
            zc = pad_lanes_to(jnp.asarray(z_rows_fn(s0, e0), dtype), width)
            lc = pad_lanes_to(jnp.arange(s0, e0), width)
            if mesh is not None:
                kc = mesh.shard_sims(kc)
                zc = mesh.shard_sims(zc, field=True)
                lc = mesh.shard_sims(lc)
            ks.append(kc)
            zs.append(zc)
            ls.append(lc)
        return bounds, ks, zs, ls

    use_white = bool(hoist_sampling) and problem.x_of_white is not None

    def make_whites(ks):
        """Hoisted CRN draws per chunk (problem.sample_white batched);
        computed once per chunking — every outer iteration reuses them."""
        return [comp.sample_whites(kc) for kc in ks] if use_white else None

    bounds, keys_chunks, Z_chunks, lane_chunks = make_chunks(
        lambda s0, e0: jnp.broadcast_to(z0_flat, (e0 - s0, comp.nz)))
    W_chunks = make_whites(keys_chunks)

    pbar = ProgressReporter(maxsteps - len(history), "MUSE",
                            enabled=progress)

    # optional XLA-level profiling of the iteration loop (view with
    # tensorboard / xprof) — the framework's tracing hook; the reference
    # has no profiler (SURVEY §5)
    profile_ctx = (jax.profiler.trace(profile_dir) if profile_dir
                   else _nullcontext())

    def _lanewise_muse(th_dev, th_t_dev, kc, Zp, lc, c, atol_dev):
        """Certified fallback: re-run a chunk's true lanes one at a time
        with the B=1 program (the certifier's own reference program)."""
        kc, Zp, lc = (jnp.asarray(jax.device_get(a))
                      for a in (kc, Zp, lc))
        return certifier.rerun_lanewise(
            lambda k1, z1, l1: comp.muse_step(th_dev, th_t_dev, k1, z1,
                                              l1, atol_dev),
            c, lambda j: (kc[j:j + 1], Zp[j:j + 1], lc[j:j + 1]))

    rebuild = False
    try:
      with profile_ctx:
        for i in range(len(history) + 1, maxsteps + 1):
            t0 = _time.perf_counter()

            # convergence check (src/muse.jl:163-165)
            if i > 2 and _theta_converged(history, theta_rtol, i):
                _warn_midmarch_stop(history, theta_rtol, nsims)
                break

            if rebuild:
                # a certification failure rerouted the width: re-chunk
                # the per-lane warm-start state at the certified width
                Z_full = jnp.concatenate(
                    [Z_chunks[ci][:e0 - s0]
                     for ci, (s0, e0) in enumerate(bounds)])
                bounds, keys_chunks, Z_chunks, lane_chunks = make_chunks(
                    lambda s0, e0: Z_full[s0:e0])
                W_chunks = make_whites(keys_chunks)
                rebuild = False

            th_dev = jnp.asarray(th, dtype)
            th_t_dev = jnp.asarray(th_t, dtype)
            atol_dev = jnp.asarray(grad_z_atol, dtype)
            g_parts, g_t_parts, conv_parts, fail_parts, it_parts = \
                [], [], [], [], []
            zhat_dat = None
            zhat_sims_parts = []
            for ci, ((s0, e0), kc, lc) in enumerate(
                    zip(bounds, keys_chunks, lane_chunks)):
                c = e0 - s0
                Z_prev_c = Z_chunks[ci]
                if certifier is not None and certifier.is_bad(
                        "muse_step", width):
                    out = _lanewise_muse(th_dev, th_t_dev, kc, Z_prev_c,
                                         lc, c, atol_dev)
                    rebuild = True
                else:
                    if use_white:
                        out = comp.muse_step_white(th_dev, th_t_dev,
                                                   W_chunks[ci], Z_prev_c,
                                                   lc, atol_dev)
                    else:
                        out = comp.muse_step(th_dev, th_t_dev,
                                             kc, Z_prev_c, lc, atol_dev)
                    if (certifier is not None
                            and certifier.should_probe("muse_step", width)):
                        lanes = certifier.probe_lane_set("muse_step",
                                                         width, c)
                        kc_h = jnp.asarray(jax.device_get(kc))
                        lc_h = np.asarray(jax.device_get(lc))

                        def x_of(j):
                            if int(lc_h[j]) == 0:
                                return comp.x_obs
                            x, _ = certifier._sample1(kc_h[j], th_dev)
                            return x

                        if not certifier.probe(
                                "muse_step", width, lanes, x_of,
                                lambda j: Z_prev_c[j], out["Z"],
                                th_dev, atol_dev):
                            out = _lanewise_muse(th_dev, th_t_dev, kc,
                                                 Z_prev_c, lc, c, atol_dev)
                            rebuild = True
                Z_chunks[ci] = out["Z"]
                g_parts.append(np.asarray(out["g"], np.float64)[:c])
                g_t_parts.append(np.asarray(out["g_t"], np.float64)[:c])
                conv_parts.append(np.asarray(out["converged"])[:c])
                fail_parts.append(np.asarray(out["failed"])[:c])
                it = np.asarray(out.get("iterations", 0))
                # custom solvers may report no per-lane iterations —
                # broadcast the default to the chunk's true lane count so
                # history["map_iterations"] is always (nsims+1,)
                it_parts.append(it[:c] if it.ndim
                                else np.full(c, int(it)))
                if ci == 0:
                    zhat_dat = np.asarray(out["Z"][0])
                if save_sims_maps:
                    c0 = 1 if ci == 0 else 0   # skip the data lane
                    zhat_sims_parts.append(
                        np.asarray(out["Z"][c0:e0 - s0]))
            g = np.concatenate(g_parts)                 # (nsims+1, nθ)
            g_t = np.concatenate(g_t_parts)
            out = {"converged": np.concatenate(conv_parts),
                   "failed": np.concatenate(fail_parts),
                   "iterations": np.concatenate(it_parts)}
            g_dat, g_sims = g[0], g[1:]
            g_dat_t, g_sims_t = g_t[0], g_t[1:]

            # the MUSE score (src/muse.jl:183-185)
            g_like_t = g_dat_t - g_sims_t.mean(axis=0)
            g_prior_t = np.asarray(
                comp.prior_grad_t(jnp.asarray(th_t, dtype)), np.float64)
            g_post_t = g_like_t + g_prior_t

            # H⁻¹ via sims variance / Broyden replay (src/muse.jl:188-205)
            var_sims = g_sims_t.var(axis=0, ddof=1)
            if (var_sims <= 0).any() or not np.isfinite(var_sims).all():
                bad = [result.theta_names[k] if k < len(result.theta_names)
                       else str(k)
                       for k in np.where(~(var_sims > 0))[0]]
                raise RuntimeError(
                    f"MUSE iteration {i}: zero/non-finite score variance "
                    f"for θ component(s) {bad}. A hyper-parameter whose "
                    "score has no simulation scatter does not affect the "
                    "observed data and cannot be estimated by MUSE — check "
                    "the model structure.")
            Hinv_like_sims = np.diag(-1.0 / var_sims)
            if Hinv_like is None or Hinv_update == "sims":
                Hinv_like = Hinv_like_sims
            elif i > 2 and Hinv_update in ("broyden", "diagonal_broyden"):
                j0 = int(max(2, i - broyden_memory))
                Hinv_like = history[j0 - 2]["Hinv_like_sims_t"]
                for j in range(j0, i):
                    hj, hjm1 = history[j - 1], history[j - 2]
                    dth = hj["theta_t"] - hjm1["theta_t"]
                    dg = hj["g_like_t"] - hjm1["g_like_t"]
                    Hdg = Hinv_like @ dg
                    denom = dth @ Hdg
                    Hinv_like = Hinv_like + np.outer(
                        (dth - Hdg) / denom, dth @ Hinv_like)
                    if Hinv_update == "diagonal_broyden":
                        Hinv_like = np.diag(np.diag(Hinv_like))

            H_prior_t = np.atleast_2d(np.asarray(
                comp.prior_hess_t(jnp.asarray(th_t, dtype)), np.float64))
            Hinv_post = np.linalg.inv(
                np.linalg.inv(Hinv_like) + H_prior_t)

            t = _time.perf_counter() - t0
            history.append({
                "theta": th.copy(), "theta_unreg": th_unreg.copy(),
                "theta_t": th_t.copy(), "theta_t_unreg": th_t_unreg.copy(),
                "g_like_sims": g_sims, "g_like_dat_t": g_dat_t,
                "g_like_sims_t": g_sims_t, "g_like_t": g_like_t,
                "g_prior_t": g_prior_t, "g_post_t": g_post_t,
                "Hinv_post_t": Hinv_post, "H_prior_t": H_prior_t,
                "Hinv_like_t": Hinv_like,
                "Hinv_like_sims_t": Hinv_like_sims,
                "map_converged": out["converged"],
                "map_failed": out["failed"],
                "map_iterations": out["iterations"],
                "t": t,
                "zhat_dat": save_maps(zhat_dat),
                # per-sim MAPs (src/muse.jl:219 ẑ_sims = save_MAPs.(ẑ_sims))
                "zhat_sims": (save_maps(np.concatenate(zhat_sims_parts))
                              if save_sims_maps else None),
            })
            _warn_maps(out, i, B)

            # damped Newton step (src/muse.jl:223-227)
            a = alpha_fn(i)
            th_t_unreg = th_t - a * (Hinv_post @ g_post_t)
            th_unreg = np.asarray(
                comp.inv_transform(jnp.asarray(th_t_unreg, dtype)),
                np.float64)
            th_t = (np.asarray(regularize(th_t_unreg), np.float64)
                    if regularize is not None else th_t_unreg)
            th = np.asarray(
                comp.inv_transform(jnp.asarray(th_t, dtype)), np.float64)

            # running updates for early stop (src/muse.jl:230-232)
            result.theta = th_unreg
            result.gs = [gi for gi in g_sims]
            # per-sim reliability of the stored scores: get_J's reuse path
            # consults this so one straggler MAP in the final iteration
            # cannot silently inflate J (measured: a single unconverged
            # 256² lensing lane blew σ up 7× via J/H ≈ 38)
            result.metadata["gs_converged"] = (
                out["converged"][1:] & ~out["failed"][1:]).copy()
            result.time += t

            pbar.step(f"θ={_fmt(th_unreg)}  |g_post|={np.max(np.abs(g_post_t)):.3g}")

            if checkpoint_file is not None:
                result.save(checkpoint_file)
    finally:
        pbar.close()

    if get_covariance:
        from .jacobians import get_H, get_J
        get_J(result, problem, key=key, nsims=nsims,
              grad_z_atol=grad_z_atol, mesh=mesh, dtype=dtype,
              compiled=comp, progress=progress, warn_reuse=False,
              certify=certify)
        get_H(result, problem, key=key, nsims=max(1, nsims // 10),
              grad_z_atol=grad_z_atol, mesh=mesh, dtype=dtype,
              compiled=comp, progress=progress, certify=certify)
    return result


def _theta_converged(history, theta_rtol: float, i: int) -> bool:
    """The θ_rtol convergence test (src/muse.jl:163-165), doubly guarded.

    Guard 1 — sign: the reference's metric √(−Δθᵀ H⁻¹_post Δθ) assumes
    H⁻¹_post is negative definite.  The sims-variance H⁻¹ is ND by
    construction, but a Broyden replay from history
    (``Hinv_update="broyden"``) can drift off the cone — the raw formula
    then clamps a NEGATIVE metric to 0 and silently declares convergence
    on an arbitrary step.  When the quadratic form has the wrong sign for
    a nonzero step, warn and fall back to the magnitude |Δθᵀ H⁻¹ Δθ| — a
    scale-matched step measure that cannot manufacture a spurious 0.

    Guard 2 — consecutiveness (deliberate deviation from the reference's
    single-step test): the metric is a σ-scaled STEP size, so one small
    damped step far from the root passes it even while θ is still
    marching.  Measured on the reference's own canonical noisy funnel
    (D=512, θ₀=1): the single-step rule at the default θ_rtol=1e-1
    stopped at θ̂=+0.199 where the exact marginal MLE is −0.125 — a
    silent 2.5σ bias; the 256² lensing study stalled the same way at
    θ ≈ 0.08 against truth 0.3.  Requiring the LAST TWO steps to both
    pass costs at most one extra iteration in genuinely converged runs
    (near a root, consecutive damped steps shrink geometrically, so the
    previous step also passes) and eliminates the first-small-step
    artifact."""
    import warnings

    def step_metric(h_prev, h_curr):
        dth_t = h_curr["theta_t"] - h_prev["theta_t"]
        metric = float(-dth_t @ h_curr["Hinv_post_t"] @ dth_t)
        if metric <= 0.0 and float(dth_t @ dth_t) > 0.0:
            warnings.warn(
                f"MUSE iteration {i}: H⁻¹_post is not negative definite "
                f"along the last step (Δθᵀ H⁻¹ Δθ = {-metric:.3g} ≥ 0) — "
                "likely Broyden-replay drift. Using |Δθᵀ H⁻¹ Δθ| for the "
                "θ_rtol test instead of silently declaring convergence; "
                'consider Hinv_update="sims" or a smaller broyden_memory.')
            metric = abs(metric)
        return math.sqrt(metric)

    if step_metric(history[-2], history[-1]) >= theta_rtol:
        return False
    if len(history) < 3:
        return False       # one qualifying step is not convergence yet
    return step_metric(history[-3], history[-2]) < theta_rtol


def _warn_midmarch_stop(history, theta_rtol: float, nsims: int) -> None:
    """Warn when the θ_rtol stop fires mid-march.

    θ_rtol measures a σ-scaled STEP size, not closeness to the score
    root: an α-damped march can take small steps while |g_post| is still
    large.  Measured on the 256² lensing calibration study
    (BENCHMARKS.md): the σ-scaled stop at 3e-2 froze fits mid-march at
    θ ≈ 0.08 vs truth 0.3; the shipped demos all override to 3e-4
    (round-5: 3e-3 still froze some realizations).  The
    reference-parity default (1e-1, src/muse.jl:119) is kept, so when a
    stop looks mid-march — the final posterior score is (a) not clearly
    below its running maximum over the fit AND (b) above the Monte-Carlo
    noise floor std(g_sims)/√nsims that a true root would sit at — say
    so instead of returning silently."""
    import warnings

    g_norms = [float(np.max(np.abs(h["g_post_t"]))) for h in history
               if "g_post_t" in h]
    if len(g_norms) < 3:
        return
    g_last, g_max = g_norms[-1], max(g_norms)
    h = history[-1]
    if "g_like_sims_t" not in h or "g_post_t" not in h:
        return
    sd = np.std(np.asarray(h["g_like_sims_t"], np.float64), axis=0,
                ddof=1)
    floor = sd / math.sqrt(max(nsims, 2))
    z = np.abs(np.asarray(h["g_post_t"], np.float64)) / np.maximum(
        floor, 1e-300)
    if g_last > 0.5 * g_max and float(np.max(z)) > 3.0:
        warnings.warn(
            f"MUSE stopped by theta_rtol={theta_rtol:g} while the "
            f"posterior score is still {float(np.max(z)):.1f}× its "
            "Monte-Carlo noise floor and has not decreased from its "
            f"running maximum (max|g_post| {g_last:.3g} vs peak "
            f"{g_max:.3g}) — the σ-scaled step test can freeze a damped "
            "march far from the root (measured on the 256² lensing "
            "study). The fit is likely NOT converged: rerun with a "
            "smaller theta_rtol (the shipped demos use 3e-4) or more "
            "maxsteps.")


def spec_flatten_z(comp: CompiledProblem, z) -> np.ndarray:
    from jax.flatten_util import ravel_pytree
    zf, _ = ravel_pytree(z)
    return np.asarray(zf)


def _warn_maps(out, i, b=None):
    import warnings
    failed = np.asarray(out["failed"])[:b]
    if failed.any():
        warnings.warn(
            f"MUSE iteration {i}: {int(failed.sum())}/{failed.size} latent "
            "MAP solves failed (NaN or line-search stall); their lanes were "
            "frozen. Result may be affected — consider adjusting θ₀ or "
            "grad_z_atol.")
    conv = np.asarray(out["converged"])[:b]
    if not conv.all() and not failed.any():
        warnings.warn(
            f"MUSE iteration {i}: {int((~conv).sum())}/{conv.size} MAP "
            "solves did not converge within tolerance; result could be "
            "erroneous (same caveat as reference src/interface.jl:168-171).")


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fmt(th):
    th = np.atleast_1d(th)
    if th.size <= 4:
        return "[" + ", ".join(f"{v:.4g}" for v in th) + "]"
    return f"[{th[0]:.4g}, …×{th.size}]"
