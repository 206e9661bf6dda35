"""Headline benchmark: wall-clock per MUSE iteration, 100 sims, 1024² latent.

This is BASELINE.json's north-star metric.  The reference publishes no
benchmark numbers (SURVEY §6), so ``vs_baseline`` is measured directly on
the same hardware: the ratio of the reference's *execution model* (one
simulation MAP+gradient at a time, as a Distributed worker would run it,
src/muse.jl:169-176) to this framework's lockstep-batched step, with
identical math.

Runs on a GPU only.  Prints ONE JSON line naming the device:
  {"metric": "muse_iteration_wall_s_100sims_1024sq", "value": ...,
   "unit": "s", "vs_baseline": ..., "device": {"platform": "gpu",
   "kind": ..., "count": ..., "card": "<name>, <power limit>"}}

Flags: --grid N --nsims N (default 1024/100), --quick (128²/16 sims).
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

from chip_smoke import card_info, require_gpu
from muse_tpu.utils.compile_cache import enable_compile_cache


def build(n_grid, nsims, seed=0, model="grf", noise=None, nbands=12):
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec
    from muse_tpu.utils.keys import as_key, sim_keys

    if model == "grf":
        # the packed-spectral representation (grf_spectral_problem) is
        # the shipped flagship GRF path: same statistical model and same
        # batched-PCG MAP machinery, carried in the isometric Fourier
        # packing so a muse iteration runs 2 FFT-sized kernels instead
        # of 9 (tests pin end-to-end θ̂ parity with the pixel
        # representation at ~1e-8) — see BENCHMARKS.md stage table
        from muse_tpu.models.grf import grf_spectral_problem
        kw = {} if noise is None else {"noise": noise}
        prob = grf_spectral_problem(n=n_grid, solver="cg",
                                    data_key=jax.random.PRNGKey(42), **kw)
    elif model == "grf-pixel":
        from muse_tpu.models.grf import grf_problem
        prob = grf_problem(n=n_grid, solver="cg",
                           data_key=jax.random.PRNGKey(42))
    elif model == "lensing":
        from muse_tpu.models.lensing import lensing_problem
        prob = lensing_problem(n=n_grid, data_key=jax.random.PRNGKey(42))
    elif model == "bandpower":
        # many-band vector θ (nθ ≫ 1, the pmap_over=:jac regime the
        # reference special-cases at src/muse.jl:329-333): per-band
        # log-amplitudes of the packed-spectral GRF — a muse iteration
        # runs ZERO FFT-sized kernels at any nbands (models/bandpower.py)
        from muse_tpu.models.bandpower import bandpower_problem
        prob = bandpower_problem(n=n_grid, nbands=nbands,
                                 data_key=jax.random.PRNGKey(42))
        theta_example = jnp.zeros(nbands)
    elif model == "funnel":
        from muse_tpu.models.funnel import funnel_problem
        prob = funnel_problem(n_grid, data_key=jax.random.PRNGKey(42))
    elif model == "ppl":
        # hierarchical model through the PPL adapter (BASELINE config 3):
        # same funnel math, but every density/gradient flows through the
        # effect-handler tracing + bijector machinery — measures the
        # adapter's overhead over raw closures
        from muse_tpu import ppl
        from muse_tpu.distributions import Normal

        d = n_grid

        def _model():
            th = ppl.sample("theta", Normal(0.0, 3.0))
            z = ppl.sample("z", Normal(0.0, jnp.exp(th / 2)).expand((d,)))
            ppl.sample("x", Normal(z, 1.0))

        tmp = ppl.PPLMuseProblem(_model, observed={"x": jnp.zeros(d)})
        x_obs, _ = jax.jit(tmp.sample_x_z)(jax.random.PRNGKey(42),
                                           {"theta": 0.0})
        prob = ppl.model_problem(_model, {"theta": 0.0}, observed=x_obs)
        theta_example = {"theta": 0.0}
    else:
        raise ValueError(model)
    if model not in ("ppl", "bandpower"):
        theta_example = 0.0
    spec = ThetaSpec.from_example(theta_example)
    th0 = spec.flatten(theta_example if model == "bandpower" else 0.0)
    comp = CompiledProblem(prob, spec, th0)

    key = as_key(seed)
    dummy = jax.random.fold_in(key, 2 ** 31 - 1)
    keys_all = jnp.concatenate([dummy[None], sim_keys(key, nsims)])
    Z = jnp.zeros((nsims + 1, comp.nz), jnp.float32)
    lane_ids = jnp.arange(nsims + 1)
    th = jnp.asarray(th0, jnp.float32)
    atol = jnp.asarray(1e-2, jnp.float32)
    return comp, th, keys_all, Z, lane_ids, atol


def _pad_W(W_all, sl, w):
    """Slice+pad one chunk of the hoisted white draws (a pytree with a
    leading lane axis, problem.sample_white)."""
    from muse_tpu.utils.fft_check import pad_lanes_to
    return jax.tree.map(lambda a: pad_lanes_to(a[sl], w), W_all)


def time_step(comp, th, keys_all, Z, lane_ids, atol, reps=3,
              max_batch=None, W_all=None):
    """Median of per-call walls, every output blocked.

    Blocking the WHOLE output (not one leaf) and taking the median of
    individual calls guards against two measurement hazards: a timing
    that ends when the call is enqueued rather than when the program
    has run, and one-off hiccups.

    ``max_batch`` times the iteration as the solver would actually run
    it under that chunk width (muse_fit's chunking): lanes are split
    into width-``max_batch`` chunks (last one padded) and one
    "iteration" is the serial sum over chunks.  Used where batching
    LOSES to small widths (the FFT-saturated 1024² regime) or where a
    width is routed around by value-integrity certification
    (solver/certify.py).

    ``W_all`` (hoisted CRN white draws from ``comp.sample_whites``)
    switches the timed program to ``muse_step_white`` — the iteration
    muse_fit actually runs when the problem declares the white split
    (problem.py): the θ-independent RNG is drawn once per fit, so the
    steady-state per-iteration wall excludes it."""
    n = keys_all.shape[0]
    if max_batch is None or max_batch >= n:
        chunks = [(keys_all if W_all is None
                   else _pad_W(W_all, slice(0, n), n), Z, lane_ids)]
    else:
        from muse_tpu.utils.fft_check import pad_lanes_to
        w = max_batch
        chunks = [((pad_lanes_to(keys_all[i:i + w], w) if W_all is None
                    else _pad_W(W_all, slice(i, i + w), w)),
                   pad_lanes_to(Z[i:i + w], w),
                   pad_lanes_to(lane_ids[i:i + w], w))
                  for i in range(0, n, w)]
    step = comp.muse_step if W_all is None else comp.muse_step_white
    for kc, zc, lc in chunks:                       # compile + warm
        jax.block_until_ready(step(th, th, kc, zc, lc, atol))
    walls = []
    for _ in range(max(reps, 3)):
        t0 = time.perf_counter()
        for kc, zc, lc in chunks:
            out = step(th, th, kc, zc, lc, atol)
            jax.block_until_ready(out)
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2]


def certify_timed_step(comp, th, keys_all, Z, lane_ids, atol,
                       max_batch=None, W_all=None):
    """Value-certify the EXACT (program, width) being timed.

    The flagship bench models (spectral GRF, bandpower) declare
    ``fft_grid=None``, so the solver's ``certify="auto"`` does not probe
    them here — yet the accelerator this engine was first built on
    produced two distinct batch-width value-corruption families
    (solver/certify.py).  Before timing, re-solve rotated sample
    lanes of one chunk with the independently compiled B=1 program
    (solver/certify.py semantics) and compare objectives/norms; the
    verdict is stamped into the bench JSON so a timed number can never
    silently be garbage work.  Width 1 is the reference program itself.
    """
    import warnings

    from muse_tpu.utils.fft_check import pad_lanes_to

    n = keys_all.shape[0]
    w = n if max_batch is None or max_batch >= n else max_batch
    if w <= 1:
        return True
    kc = pad_lanes_to(keys_all[:w], w)
    zc = pad_lanes_to(Z[:w], w)
    lc = pad_lanes_to(lane_ids[:w], w)
    cert = comp.certifier
    if W_all is None:
        out = comp.muse_step(th, th, kc, zc, lc, atol)
    else:
        # certify the white-hoisted program (the one being timed): the
        # B=1 probe re-solves stay KEYED, so this also cross-checks the
        # problem.py white-split contract on real lanes
        out = comp.muse_step_white(th, th, _pad_W(W_all, slice(0, w), w),
                                   zc, lc, atol)
    cert.should_probe("muse_step", w)      # advance the rotation counter
    lanes = cert.probe_lane_set("muse_step", w, min(w, n))
    kc_h = jnp.asarray(jax.device_get(kc))
    lc_h = jax.device_get(lc)

    def x_of(j):
        if int(lc_h[j]) == 0:
            return comp.x_obs
        x, _ = cert._sample1(kc_h[j], th)
        return x

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ok = cert.probe("muse_step", w, lanes, x_of, lambda j: zc[j],
                        out["Z"], th, atol)
    return bool(ok)


def time_sequential_baseline(n_grid, model, nlanes=8, reps=3, nbands=12):
    """Reference execution model on the same chip: a genuine one-sim-at-a-
    time loop (the per-sim Distributed-worker schedule, src/muse.jl:169-176).

    Times ``nlanes`` distinct single-sim MUSE steps (distinct keys so no
    run is an artifact of one easy/hard sim), ``reps`` passes; returns
    (mean_per_sim_s, spread) where spread is (max−min)/mean across passes.
    Each step is a B=1 lane batch of the same compiled computation — the
    smallest schedulable unit, charged entirely to one sim.
    """
    comp, th, keys_all, Z, lane_ids, atol = build(n_grid, nlanes,
                                                  model=model,
                                                  nbands=nbands)
    # single-lane views: lane_id=1 so every run is a sim lane (not data)
    one = jnp.ones((1,), lane_ids.dtype)
    ks = [keys_all[i:i + 1] for i in range(1, nlanes + 1)]
    Z1 = Z[:1]
    comp.muse_step(th, th, ks[0], Z1, one, atol)  # compile once (B=1)
    for k in ks:                                  # untimed warm pass
        jax.block_until_ready(comp.muse_step(th, th, k, Z1, one, atol))
    pass_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for k in ks:
            # block the WHOLE output, not one leaf: the same enqueue
            # hazard time_step guards against
            out = comp.muse_step(th, th, k, Z1, one, atol)
            jax.block_until_ready(out)
        pass_times.append(time.perf_counter() - t0)
    per_sim = [t / nlanes for t in pass_times]
    mean = sum(per_sim) / len(per_sim)
    spread = (max(per_sim) - min(per_sim)) / mean
    return mean, spread


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--nsims", type=int, default=100)
    ap.add_argument("--model", default="grf",
                    choices=["grf", "grf-pixel", "lensing", "funnel",
                             "ppl", "bandpower"])
    ap.add_argument("--nbands", type=int, default=12,
                    help="θ components for --model bandpower")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="time the iteration chunked at this lane width "
                         "(the solver's max_batch execution model)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-hoist", action="store_true",
                    help="time the keyed muse_step even when the problem "
                         "declares the CRN white split (muse_fit's "
                         "hoist_sampling=False path)")
    ap.add_argument("--baseline-lanes", type=int, default=8,
                    help="distinct sims measured one-at-a-time for the "
                         "sequential baseline")
    args = ap.parse_args()
    dev = require_gpu()
    enable_compile_cache()
    if args.quick:
        args.grid, args.nsims = 128, 16

    if (args.model == "lensing" and args.grid >= 1024
            and args.max_batch is None):
        # the shipped lensing width at 1024² (examples/lensing_demo.py);
        # chip_smoke.py certifies it and the unchunked width on the GPU
        args.max_batch = 3
        print("# lensing at >=1024^2: defaulting --max-batch 3 "
              "(the shipped width)", file=sys.stderr, flush=True)

    comp, th, keys_all, Z, lane_ids, atol = build(args.grid, args.nsims,
                                                  model=args.model,
                                                  nbands=args.nbands)

    # hoisted CRN white draws (problem.sample_white): muse_fit's default
    # iteration program when the problem declares the split — drawn once
    # per fit, so the steady-state per-iteration wall excludes the RNG
    W_all = None
    if not args.no_hoist and comp.problem.x_of_white is not None:
        W_all = jax.block_until_ready(comp.sample_whites(keys_all))

    # value-certify the exact (program, width) about to be timed — a
    # bench row on a platform with measured batch-width miscompiles is
    # only honest if the timed program computes real values
    certified = certify_timed_step(comp, th, keys_all, Z, lane_ids, atol,
                                   max_batch=args.max_batch, W_all=W_all)
    if not certified:
        print(f"# WARNING: certification FAILED for model={args.model} "
              f"at the timed width — this row times corrupt work",
              file=sys.stderr, flush=True)

    batched_s = time_step(comp, th, keys_all, Z, lane_ids, atol,
                          max_batch=args.max_batch, W_all=W_all)

    # Honest sequential baseline: a real one-sim-at-a-time loop over
    # ≥8 distinct sims, ≥3 passes, spread recorded (VERDICT r1 item 10).
    seq_one, seq_spread = time_sequential_baseline(
        args.grid, args.model, nlanes=max(8, args.baseline_lanes),
        nbands=args.nbands)

    # physical floor: the batched step contains >= one sim's serial work,
    # so batched < per-sim wall means the measurement was an artifact
    # (dispatch-only timing / worker restart) — re-measure once, and if
    # the artifact persists, publish the floor itself with a flag rather
    # than a physically impossible speedup.  Under white-hoisting the
    # batched step legitimately does LESS work than the keyed B=1 step
    # (no RNG), so the floor must be a B=1 run of the SAME hoisted
    # program (a sim lane, not the data lane).
    if W_all is None:
        floor_one = seq_one
    else:
        floor_one = time_step(
            comp, th, keys_all[1:2], Z[1:2], lane_ids[1:2], atol,
            W_all=jax.tree.map(lambda a: a[1:2], W_all))
    baseline_artifact = False
    if W_all is not None and seq_one < floor_one:
        # the keyed B=1 baseline does strictly MORE work than the hoisted
        # B=1 step (it also runs the RNG), so a smaller wall means the
        # baseline measurement hit the dispatch artifact — re-measure
        # once, then flag and clamp rather than publish a fake speedup
        seq_one, seq_spread = time_sequential_baseline(
            args.grid, args.model, nlanes=max(8, args.baseline_lanes),
            nbands=args.nbands)
        if seq_one < floor_one:
            baseline_artifact = True
            seq_one = floor_one
    floor_violation = False
    if batched_s < floor_one:
        batched_s = time_step(comp, th, keys_all, Z, lane_ids, atol,
                              reps=5, max_batch=args.max_batch,
                              W_all=W_all)
        if batched_s < floor_one:
            floor_violation = True
            batched_s = floor_one
    seq_total = seq_one * (args.nsims + 1)

    suffix = ("" if args.model == "grf"
              else f"_{args.model.replace('-', '_')}")
    result = {
        "metric": f"muse_iteration_wall_s_{args.nsims}sims_"
                  f"{args.grid}sq{suffix}",
        "value": round(batched_s, 4),
        "unit": "s",
        "vs_baseline": round(seq_total / batched_s, 2),
        "baseline_per_sim_s": round(seq_one, 4),
        "baseline_spread": round(seq_spread, 3),
        "certified": certified,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card_info()},
    }
    if W_all is not None:
        result["hoisted_crn"] = True
    if args.max_batch is not None:
        result["max_batch"] = args.max_batch
    if args.model == "bandpower":
        result["nbands"] = args.nbands
    if floor_violation:
        result["floor_violation"] = True   # batched clamped to the floor
    if baseline_artifact:
        # baseline clamped UP to the hoisted B=1 floor: vs_baseline is a
        # lower bound, not a measurement
        result["baseline_artifact"] = True
    print(json.dumps(result))


if __name__ == "__main__":
    main()
