"""CMB-lensing-style amplitude inference — the MUSE paper's flagship use.

Infers the lensing-potential log-amplitude θ = log A_φ from one observed
lensed map, marginalizing over the ~2n²-dimensional joint latent
(unlensed field + potential), then builds the full Gaussianized posterior
θ̂ ± σ via get_J + implicit-diff get_H with the model's ready-made
Fourier CG preconditioner.

This is the problem family the reference was built for (arXiv:2112.09354
§5) but ships no in-repo model of; here it is framework-native, solved by
batched variable projection + Newton-CG polish (see docs/models.md).

Run:  python examples/lensing_demo.py  [--n 128 --nsims 64 --theta-true 0.3]
(CPU-friendly at the default n=64; use n=256+ on a GPU.)
"""

import argparse
import os
import sys
import time

# allow running straight from a repo checkout: `python examples/<demo>.py`
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import numpy as np

from muse_tpu import MuseResult, get_H, get_J, muse_fit
from muse_tpu.models.lensing import lensing_problem
from muse_tpu.utils.compile_cache import enable_compile_cache


def fit_settings(n):
    """``muse_fit`` keywords of the shipped configuration at grid ``n``.

    alpha damps the Newton steps: with the crude iteration-1 H⁻¹ the
    default 0.7 overshoots θ into the strongly-lensed regime where
    large-n MAP solves grind at the f32 resolution floor (measured at
    512²: an overshoot to θ≈1.7 froze all 17 MAPs and the garbage score
    spuriously "converged").

    Flagship sizes (n ≥ 256) need the robust outer-loop configuration
    (measured at 512², truth 0.3): the sims-variance H⁻¹ underestimates
    the true score slope ~30× away from the root, so undamped steps
    limit-cycle against the clamp — Broyden secant updates
    (Hinv_update="broyden", reference src/muse.jl:192-205) learn the
    real slope; a ±0.3 step clamp (the regularize hook; trust-region
    practice for log-amplitude parameters) keeps θ out of the
    strongly-lensed regime where lockstep MAPs grind; and grad_z_atol
    3e-3 tightens the MAPs so per-sim basin hopping doesn't make the CRN
    score ragged in θ.  The 256² threshold is calibration-driven: across
    8 data realizations the plain (alpha=0.4, sims-H⁻¹, unclamped)
    branch diverged on its first draw (θ walked to 3.5 in two steps off
    a 30×-underestimated slope), while the robust branch recovers θ to
    within ~1σ (BENCHMARKS.md "Lensing σθ calibration at 256²").

    theta_rtol 3e-4, not the reference's 1e-1 default: the convergence
    metric is σ-scaled (√(−Δθᵀ H⁻¹_post Δθ) ≈ |Δθ|·σ_post), and with
    this family's damped+clamped steps the march has small-step episodes
    that fool even the two-step rule (BENCHMARKS.md "Round-5 full 8-rep
    study": 3e-3 still froze some realizations).  3e-4 costs ~2× the
    iterations of a 3e-3 stop and ends fits at genuine stationarity.

    max_batch bounds the lanes of one device program.  The 1024² width
    of 3 was chosen on the earlier accelerator, where widths 9 and 17 of
    this program were value-corrupted; ``chip_smoke.py`` certifies it
    and the unchunked width on the GPU.
    """
    big = n >= 256
    prev_th = {"v": np.zeros(1)}           # θ₀ of the fit

    def clamp_step(th_t):
        th_t = np.clip(th_t, prev_th["v"] - 0.3, prev_th["v"] + 0.3)
        prev_th["v"] = np.asarray(th_t)
        return th_t

    return dict(alpha=(0.4 if not big else 0.3),
                Hinv_update=("sims" if not big else "broyden"),
                regularize=(None if not big else clamp_step),
                grad_z_atol=(3e-3 if big else 1e-2),
                theta_rtol=(1e-1 if not big else 3e-4),
                maxsteps=(50 if not big else 30),
                max_batch=(None if n < 128 else
                           (33 if not big else (9 if n < 1024 else 3))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nsims", type=int, default=32)
    ap.add_argument("--theta-true", type=float, default=0.3)
    ap.add_argument("--progress", action="store_true")
    args = ap.parse_args()

    enable_compile_cache()
    prob = lensing_problem(n=args.n, theta_true=args.theta_true,
                           data_key=jax.random.PRNGKey(7))
    big = args.n >= 256
    kw = fit_settings(args.n)
    atol = kw["grad_z_atol"]
    t0 = time.perf_counter()
    res = MuseResult()
    muse_fit(res, prob, 0.0, nsims=args.nsims, z0=prob.suggested_z0,
             key=jax.random.PRNGKey(1), progress=args.progress, **kw)
    t_fit = time.perf_counter() - t0

    # score reuse from the fit is the intended design here (see
    # BENCHMARKS.md "Which J is the right one") — don't warn about it
    # skip_errors: a straggler MAP in the fit's final iteration would
    # otherwise feed an unconverged score into J (measured: one 256²
    # lane inflated σ 7×); the guard drops flagged scores with a warning
    mb = (3 if args.n >= 1024 else 9) if big else None
    get_J(res, prob, nsims=args.nsims, grad_z_atol=atol,
          max_batch=mb, warn_reuse=False,
          skip_errors=True, key=jax.random.PRNGKey(1),
          progress=args.progress)
    # >= 8 H-sims: with 4, the scalar H estimate swings by tens of
    # percent realization-to-realization (measured 138/108/79 on one
    # dataset) and sigma inherits the noise (J/H-ratio warnings).
    get_H(res, prob, nsims=max(8, args.nsims // 8), implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          implicit_fit_atol=(1e-2 if not big else 1e-3),
          max_batch=mb,
          key=jax.random.PRNGKey(1), progress=args.progress)
    t_total = time.perf_counter() - t0

    th, sig = float(res.theta[0]), float(res.sigma[0])
    z = (th - args.theta_true) / sig
    print(f"\nθ_true = {args.theta_true}")
    print(f"θ̂ ± σ  = {th:.4f} ± {sig:.4f}   (z-score {z:+.2f})")
    print(f"fit {t_fit:.1f}s, total incl. J+H {t_total:.1f}s "
          f"({len(res.history)} MUSE iterations, {args.nsims} sims, "
          f"{args.n}² × 2 latent)")
    assert abs(z) < 3, "recovery outside 3σ — investigate"


if __name__ == "__main__":
    main()
