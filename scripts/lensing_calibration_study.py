"""Frequentist σθ calibration of the SHIPPED flagship lensing config.

Runs the full pipeline (muse_fit with Wiener z0 warm start + Broyden
H⁻¹ + ±0.3 step clamp, then warm get_J + implicit get_H with the model
preconditioner — exactly examples/lensing_demo.py's n ≥ 256 branch) on
``--reps`` independent data realizations and reports per-realization
θ̂ ± σ with z-scores plus the coverage summary.

This is the study behind BENCHMARKS.md "Lensing σθ calibration": the
round-3 robust-branch study was run WITHOUT the Wiener z0 warm start
and saw 2/8 realizations walk into the strongly-lensed regime; this
script measures the warm-started configuration the demo actually ships.

Run:  python scripts/lensing_calibration_study.py --n 256 --nsims 16 --reps 8
"""

import argparse
import json
import os
import time

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from muse_tpu import MuseResult, get_H, get_J, muse_fit
from muse_tpu.models.lensing import lensing_problem
from muse_tpu.utils.compile_cache import enable_compile_cache


def run_one(rep, n, nsims, theta_true, theta_rtol=3e-4, maxsteps=30,
            grad_z_atol=3e-3):
    prob = lensing_problem(n=n, theta_true=theta_true,
                           data_key=jax.random.PRNGKey(100 + rep))
    prev = {"v": np.zeros(1)}

    def clamp_step(th_t):
        th_t = np.clip(th_t, prev["v"] - 0.3, prev["v"] + 0.3)
        prev["v"] = np.asarray(th_t)
        return th_t

    t0 = time.perf_counter()
    res = MuseResult()
    # theta_rtol (default 3e-4, --theta-rtol to override): the σ-scaled
    # metric with 3e-2 stopped these fits 2-4 iterations in, stalled at
    # θ ≈ 0.03-0.08 against truth 0.3 (round-4 study); the round-5
    # 64-sim study found 3e-3 STILL freezes some realizations mid-march
    # (rep 4: θ̂ 0.027 at 6 iters vs its true CRN root 0.109 at 20 —
    # the damped march has small-step episodes that fool even the
    # two-step rule), so the production prescription tightened to 3e-4.
    muse_fit(res, prob, 0.0, nsims=nsims, z0=prob.suggested_z0,
             alpha=0.3, Hinv_update="broyden", regularize=clamp_step,
             grad_z_atol=grad_z_atol, theta_rtol=theta_rtol,
             maxsteps=maxsteps,
             max_batch=9, key=jax.random.PRNGKey(1000 + rep))
    get_J(res, prob, nsims=nsims, grad_z_atol=grad_z_atol, max_batch=9,
          warn_reuse=False, skip_errors=True,
          key=jax.random.PRNGKey(1000 + rep))
    get_H(res, prob, nsims=max(8, nsims // 8), implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          implicit_fit_atol=1e-3, max_batch=9,
          key=jax.random.PRNGKey(1000 + rep))
    wall = time.perf_counter() - t0
    th, sig = float(res.theta[0]), float(res.sigma[0])
    return {"rep": rep, "theta_hat": th, "sigma": sig,
            "z": (th - theta_true) / sig, "iters": len(res.history),
            "wall_s": round(wall, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nsims", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--theta-true", type=float, default=0.3)
    ap.add_argument("--theta-rtol", type=float, default=3e-4)
    # --rep-start: run realizations [rep_start, rep_start+reps) — for
    # resuming an interrupted study or diagnosing one realization
    # (rep indexes the data_key, so rep k is the same dataset however
    # the study is partitioned)
    ap.add_argument("--rep-start", type=int, default=0)
    ap.add_argument("--maxsteps", type=int, default=30)
    # --grad-z-atol: MAP tightness discriminator — if the residual
    # low bias is driven by loose per-sim MAPs (score evaluated off
    # the true per-sim optimum), tightening this moves mean theta_hat
    ap.add_argument("--grad-z-atol", type=float, default=3e-3)
    args = ap.parse_args()
    enable_compile_cache()

    rows = []
    for rep in range(args.rep_start, args.rep_start + args.reps):
        row = run_one(rep, args.n, args.nsims, args.theta_true,
                      theta_rtol=args.theta_rtol, maxsteps=args.maxsteps,
                      grad_z_atol=args.grad_z_atol)
        rows.append(row)
        print(json.dumps(row), flush=True)

    th = np.array([r["theta_hat"] for r in rows])
    sig = np.array([r["sigma"] for r in rows])
    z = np.array([r["z"] for r in rows])
    cover = float(np.mean(np.abs(z) < 1.96))
    bias_se = float(np.mean(th - args.theta_true)
                    / (np.std(th, ddof=1) / np.sqrt(len(th))))
    print(json.dumps({
        "summary": True, "n": args.n, "nsims": args.nsims,
        "reps": args.reps, "theta_true": args.theta_true,
        "theta_rtol": args.theta_rtol, "grad_z_atol": args.grad_z_atol,
        "mean_theta": float(th.mean()), "std_theta": float(th.std(ddof=1)),
        "max_abs_z": float(np.abs(z).max()), "coverage_1.96": cover,
        "bias_over_se": bias_se,
        # σ calibration: reported σ vs the empirical scatter of θ̂ across
        # realizations — the ratio users actually rely on (≈1 is
        # calibrated; the round-4 16-sim config measured ~3× over-covered)
        "median_sigma": float(np.median(sig)),
        "sigma_over_scatter": float(np.median(sig) / th.std(ddof=1)),
        "diverged": int(np.sum(np.abs(th - args.theta_true) > 1.0)),
    }))


if __name__ == "__main__":
    main()
