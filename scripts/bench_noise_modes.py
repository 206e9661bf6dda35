"""Time the spectral-GRF MUSE step with noise="direct" vs noise="fft".

Decides grf_spectral_problem's default noise mode on the GPU:
"direct" (indexed hermitian sampler, zero FFT ops per iteration) was
measured SLOWER than "fft" (2 rfft2 passes) on the CPU backend — the
roll/flip gather is cache-hostile there — while on an accelerator the
flip is one cheap gather and the FFT passes are bandwidth-bound.  Prints
one JSON line with both timings and the device; flip the default in
muse_tpu/models/grf.py if direct loses on the GPU too.

Reuses bench.py's build()/time_step() harness (same CRN key layout and
timing protocol as the headline bench) rather than re-implementing it.

Usage: python scripts/bench_noise_modes.py [--grid 1024] [--nsims 100]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (repo-root bench.py)
import jax  # noqa: E402

from muse_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def time_mode(noise, n_grid, nsims, reps=5):
    comp, th, keys_all, Z, lane_ids, atol = bench.build(
        n_grid, nsims, model="grf", noise=noise)
    return bench.time_step(comp, th, keys_all, Z, lane_ids, atol,
                           reps=reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--nsims", type=int, default=100)
    args = ap.parse_args()
    dev = bench.require_gpu()
    enable_compile_cache()
    t_direct = time_mode("direct", args.grid, args.nsims)
    t_fft = time_mode("fft", args.grid, args.nsims)
    print(json.dumps({
        "metric": f"spectral_grf_noise_mode_s_{args.nsims}sims_"
                  f"{args.grid}sq",
        "direct_s": round(t_direct, 4),
        "fft_s": round(t_fft, 4),
        "winner": "direct" if t_direct <= t_fft else "fft",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": bench.card_info()},
    }))


if __name__ == "__main__":
    main()
