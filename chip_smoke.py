"""Smoke run of the MUSE pipeline on one GPU, or on four with ``--multi``.

Drives ``muse`` → ``get_J`` → ``get_H`` through the public entry points at
full width (1024² fields, 512 sims for the north star) and checks every
result against the repo's exact oracles.  Each phase prints one line: its
wall time (every wall includes compilation), its gate values and the
device's ``peak_bytes_in_use`` so far.  A failed gate ends the run with a
non-zero exit code.  The last line is one JSON object naming the device.

Run:  python chip_smoke.py            # all single-card phases
      python chip_smoke.py --multi    # the four-card mesh phases only

One phase alone: ``python -c "import chip_smoke as c;
c.run_phase('lensing', c.lensing)"`` (on a GPU; sizes as keywords).

There is no CPU mode: without a GPU the script exits non-zero before any
phase runs.  The phase functions take their sizes as arguments, so the
CPU tests call them at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from muse_tpu.utils.compile_cache import enable_compile_cache


class GateFailed(RuntimeError):
    """A phase's result missed one of its gates."""


def require_gpu():
    """Raise unless JAX's default device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind})")
    return dev


def card_info():
    """``name, power.limit`` of every card, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def gate(value, ok, limit):
    return {"value": value, "ok": bool(ok), "limit": limit}


def _spec_comp(prob, theta):
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec
    spec = ThetaSpec.from_example(theta)
    return CompiledProblem(prob, spec, spec.flatten(theta))


def _probes(comp):
    """Certifier probe count and verdicts per (kind, width)."""
    cert = comp.__dict__.get("certifier")
    if cert is None:
        return {"probes": 0}
    tally = {}
    for kind, width, passed in cert.verdicts:
        key = f"{kind}@{width}"
        p, f = tally.get(key, (0, 0))
        tally[key] = (p + passed, f + (not passed))
    return {"probes": len(cert.verdicts),
            "verdicts": {k: f"{p} pass/{f} fail"
                         for k, (p, f) in tally.items()},
            "all_passed": all(v[2] for v in cert.verdicts)}


def _northstar_problem(n):
    """The north-star GRF data (examples/northstar_grf.py) and its exact
    marginal MLE and Fisher width."""
    from muse_tpu.models.grf import grf_marginal_mle, grf_spectral_problem

    prob = grf_spectral_problem(n=n, sigma_noise=0.01, solver="cg",
                                data_key=jax.random.PRNGKey(42))
    return (prob, *grf_marginal_mle(prob.x_real, prob.grf_config))


# ------------------------------------------------------------------ #
# phases: each returns (gates, info)
# ------------------------------------------------------------------ #

def grf_northstar(n=1024, nsims=512, max_batch=128):
    """512-sim 1024² spectral GRF: fit → J → implicit H vs the oracle."""
    from examples.northstar_grf import accuracy_target, northstar_pipeline

    prob, mle, fsig = _northstar_problem(n)
    comp = _spec_comp(prob, 0.0)
    res, walls = northstar_pipeline(prob, comp, nsims=nsims,
                                    max_batch=max_batch)
    th, sig = float(res.theta[0]), float(res.sigma[0])
    target = accuracy_target(fsig, nsims)
    gates = {"|theta-mle|": gate(abs(th - mle), abs(th - mle) < target,
                                 f"< {target:.3g}"),
             "sigma/sigma_F": gate(sig / fsig, 0.9 < sig / fsig < 1.1,
                                   "in (0.9, 1.1)")}
    info = {"theta": th, "mle": mle, "sigma_F": fsig,
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "iterations": len(res.history),
            "walls_s": {k: round(v, 3) for k, v in walls.items()},
            **_probes(comp)}
    return gates, info


def grf_pixel(n=1024, nsims=100, max_batch=128):
    """Pixel-space GRF fit: the FFT path (fused-FFT probe + CG with FFTs)."""
    from examples.northstar_grf import accuracy_target
    from muse_tpu import MuseResult, muse_fit
    from muse_tpu.models.grf import grf_marginal_mle, grf_problem

    prob = grf_problem(n=n, sigma_noise=0.01, solver="cg",
                       data_key=jax.random.PRNGKey(42))
    mle, fsig = grf_marginal_mle(prob.x, prob.grf_config)
    comp = _spec_comp(prob, 0.0)
    res = MuseResult()
    muse_fit(res, prob, 0.5, nsims=nsims, max_batch=max_batch,
             theta_rtol=1e-5, alpha=1.0, compiled=comp,
             key=jax.random.PRNGKey(1))
    th = float(res.theta[0])
    target = accuracy_target(fsig, nsims)
    gates = {"|theta-mle|": gate(abs(th - mle), abs(th - mle) < target,
                                 f"< {target:.3g}")}
    info = {"theta": th, "mle": mle, "sigma_F": fsig,
            "iterations": len(res.history),
            "fft_mode": prob.grf_config.fft_mode, **_probes(comp)}
    return gates, info


def lensing(n=1024, nsims=64, widths=(3, None), maxsteps=2):
    """Shipped lensing fit for ``maxsteps`` iterations, certified, at each
    lane width in ``widths`` (None = all nsims+1 lanes in one program)."""
    from examples.lensing_demo import fit_settings
    from muse_tpu import MuseResult, muse_fit
    from muse_tpu.models.lensing import lensing_problem

    prob = lensing_problem(n=n, theta_true=0.3,
                           data_key=jax.random.PRNGKey(7))
    comp = _spec_comp(prob, 0.0)
    gates, info = {}, {}
    for w in widths:
        kw = fit_settings(n)
        kw.update(maxsteps=maxsteps, max_batch=w, certify=True)
        res = MuseResult()
        seen = len(comp.certifier.verdicts)
        t0 = time.perf_counter()
        muse_fit(res, prob, 0.0, nsims=nsims, z0=prob.suggested_z0,
                 compiled=comp, key=jax.random.PRNGKey(1), **kw)
        wall = time.perf_counter() - t0
        tag = "unchunked" if w is None else f"w{w}"
        scores = np.concatenate([h["g_like_sims"].ravel()
                                 for h in res.history])
        mine = comp.certifier.verdicts[seen:]
        gates[f"{tag}:finite_scores"] = gate(
            int(np.isfinite(scores).sum()), np.isfinite(scores).all(),
            f"== {scores.size}")
        gates[f"{tag}:probes_passed"] = gate(
            sum(v[2] for v in mine), mine and all(v[2] for v in mine),
            f"== {len(mine)} > 0")
        info[tag] = {
            "theta": float(res.theta[0]), "iterations": len(res.history),
            "wall_s": round(wall, 3),
            "frozen_lanes": [int((~h["map_converged"]
                                  | h["map_failed"]).sum())
                             for h in res.history]}
    info.update(_probes(comp))
    return gates, info


def funnel_ppl(dim=512, nsims=100):
    """README quick-start funnel and its PPL twin vs the exact MLE."""
    from muse_tpu import check_self_consistency, muse, ppl
    from muse_tpu.distributions import Normal
    from muse_tpu.models.funnel import funnel_problem

    prob = funnel_problem(dim, data_key=jax.random.PRNGKey(42))
    x_obs = prob.x
    mle = float(np.log(np.sum(np.asarray(x_obs, np.float64) ** 2) / dim
                       - 1.0))
    res = muse(prob, 1.0, nsims=nsims, theta_rtol=1e-3,
               get_covariance=True)

    def funnel():
        theta = ppl.sample("theta", Normal(0.0, 3.0))
        z = ppl.sample("z", Normal(0.0, jnp.exp(theta / 2)).expand((dim,)))
        ppl.sample("x", Normal(z, 1.0))

    pprob = ppl.PPLMuseProblem(funnel, observed={"x": x_obs},
                               params=("theta",))
    rp = muse(pprob, {"theta": 1.0}, nsims=nsims, theta_rtol=1e-3,
              get_covariance=True)
    th = float(res.theta[0])
    thp = float(np.asarray(rp.theta).ravel()[0])
    gates = {"|theta-mle|": gate(abs(th - mle), abs(th - mle) < 0.05,
                                 "< 0.05"),
             "ppl |theta-mle|": gate(abs(thp - mle), abs(thp - mle) < 0.05,
                                     "< 0.05"),
             "self_consistency": gate(check_self_consistency(prob, 1.0),
                                      True, "True")}
    info = {"theta": th, "sigma": float(res.sigma[0]), "ppl_theta": thp,
            "mle": mle}
    return gates, info


def bandpower(n=256, nbands=12, nsims=100, sigma_noise=0.01):
    """Many-band GRF vs the exact decoupled MLE and Fisher widths, with
    tests/test_bandpower.py's gates scaled by nsims as it scales them.

    σ_noise = 0.01 keeps the outermost band's signal near the noise at
    256²; at 0.05 that band's exact MLE runs to the zero-amplitude
    boundary and the oracle has no answer."""
    from muse_tpu import muse
    from muse_tpu.models.bandpower import bandpower_mle, bandpower_problem

    prob = bandpower_problem(n=n, nbands=nbands, sigma_noise=sigma_noise,
                             data_key=jax.random.PRNGKey(7))
    mle, sig_f = bandpower_mle(prob.x_real, n, nbands,
                               sigma_noise=sigma_noise)
    sig_f = np.sqrt(np.diag(sig_f))
    res = muse(prob, jnp.zeros(nbands), nsims=nsims, maxsteps=30,
               theta_rtol=1e-3, get_covariance=True,
               key=jax.random.PRNGKey(1))
    z = float(np.max(np.abs((np.asarray(res.theta) - mle) / sig_f)))
    ratio = float(np.max(np.abs(np.asarray(res.sigma) / sig_f - 1.0)))
    zmax = 3 / math.sqrt(nsims) + 0.05
    gates = {"max|z|": gate(z, z < zmax, f"< {zmax:.3g}"),
             "max|sigma/sigma_F-1|": gate(ratio, ratio < 0.5, "< 0.5")}
    return gates, {"iterations": len(res.history)}


def fft_probe(n=1024, batches=(16, 17, 32, 33, 128, 129)):
    """Fused batched-FFT self-check verdicts (a finding, not a gate)."""
    from muse_tpu.utils.fft_check import fused_fft_ok
    return {}, {f"fused_fft_ok({n},{b})": fused_fft_ok(n, b)
                for b in batches}


def _device_seconds(fn, *args, calls=20):
    """Device seconds per call of ``fn``: the summed durations of the GPU
    stream events in a profiler trace of ``calls`` back-to-back calls.

    A host clock around asynchronous calls of ~50 µs each measures the
    dispatch as much as the kernels, so the kernels' own times are read
    from the trace instead."""
    import glob
    import tempfile

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        path, = glob.glob(f"{d}/**/*.xplane.pb", recursive=True)
        plane = jax.profiler.ProfileData.from_file(path) \
            .find_plane_with_name("/device:GPU:0")
    if plane is None:
        raise RuntimeError("the trace has no /device:GPU:0 plane")
    lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
    if not lines:
        raise RuntimeError(f"no stream lines in the GPU plane: "
                           f"{[ln.name for ln in plane.lines]}")
    ns = sum(ev.duration_ns for ln in lines for ev in ln.events)
    return ns / 1e9 / calls


def quadform_xla(B=16, n=1024):
    """Plain-XLA spectrum quadform value+z-gradient vs a copy of the
    same bytes: achieved GB/s and the share of the copy's rate, both
    from device time."""
    from muse_tpu.models.grf import spectrum_quadform_reference as quad

    m2 = 2 * (n // 2 + 1)
    z = jax.random.normal(jax.random.PRNGKey(0), (B, n, m2), jnp.float32)
    c = jax.random.uniform(jax.random.PRNGKey(1), (n, m2), jnp.float32,
                           0.5, 1.5)
    vg = jax.jit(lambda z, c: (quad(z, c), jax.grad(
        lambda zz: jnp.sum(quad(zz, c)))(z)))
    copy = jax.jit(jnp.copy)
    q, g = vg(z, c)
    z64, c64 = np.asarray(z, np.float64), np.asarray(c, np.float64)
    q_ref = np.einsum("bnm,nm->b", z64 * z64, c64)
    q_err = float(np.max(np.abs(np.asarray(q) - q_ref) / np.abs(q_ref)))
    g_err = float(np.max(np.abs(np.asarray(g) - 2 * z64 * c64))
                  / np.max(np.abs(2 * z64 * c64)))
    t_vg = _device_seconds(vg, z, c)
    t_copy = _device_seconds(copy, z)
    zb, cb = z.size * 4, c.size * 4
    gbs_vg = (2 * zb + cb) / t_vg / 1e9      # read z, c; write the grad
    gbs_copy = 2 * zb / t_copy / 1e9
    gates = {"value rel err": gate(q_err, q_err < 1e-5, "< 1e-5"),
             "grad rel err": gate(g_err, g_err < 1e-6, "< 1e-6")}
    info = {"t_value_grad_s": t_vg, "t_copy_s": t_copy,
            "value_grad_GBps": gbs_vg, "copy_GBps": gbs_copy,
            "share_of_copy": gbs_vg / gbs_copy}
    return gates, info


# ------------------------------------------------------------------ #
# four-card phases (--multi)
# ------------------------------------------------------------------ #

def multi_northstar(n=1024, nsims=512, max_batch=128):
    """North-star pipeline over a sims mesh of every device vs the same
    keys on one device, and both vs the oracle."""
    from examples.northstar_grf import accuracy_target, northstar_pipeline
    from muse_tpu.parallel import make_sims_mesh

    prob, mle, fsig = _northstar_problem(n)
    mesh = make_sims_mesh()
    r_mesh, w_mesh = northstar_pipeline(prob, _spec_comp(prob, 0.0),
                                        nsims=nsims, max_batch=max_batch,
                                        mesh=mesh)
    r_one, w_one = northstar_pipeline(prob, _spec_comp(prob, 0.0),
                                      nsims=nsims, max_batch=max_batch)
    th, sig = float(r_mesh.theta[0]), float(r_mesh.sigma[0])
    d = abs(th - float(r_one.theta[0]))
    target = accuracy_target(fsig, nsims)
    gates = {"|theta_mesh-theta_1dev|": gate(d, d <= 0.01 * fsig,
                                             f"<= {0.01 * fsig:.3g}"),
             "|theta-mle|": gate(abs(th - mle), abs(th - mle) < target,
                                 f"< {target:.3g}"),
             "sigma/sigma_F": gate(sig / fsig, 0.9 < sig / fsig < 1.1,
                                   "in (0.9, 1.1)")}
    info = {"mesh": dict(mesh.mesh.shape), "theta_mesh": th,
            "theta_1dev": float(r_one.theta[0]), "mle": mle,
            "walls_mesh_s": {k: round(v, 3) for k, v in w_mesh.items()},
            "walls_1dev_s": {k: round(v, 3) for k, v in w_one.items()}}
    return gates, info


def _mesh_vs_one(build, mesh, field):
    """One muse_step on ``mesh`` and on one device from the same inputs.
    Returns the mesh and one-device outputs (``g``, ``Z``) cut to the true
    lanes, both compiled problems and the one-device step arguments."""
    comp_m, (th, th_t, keys, Z, lanes, atol) = build(mesh)
    out_m = comp_m.muse_step(th, th_t, mesh.shard_sims(keys),
                             mesh.shard_sims(Z, field=field),
                             mesh.shard_sims(lanes), atol)
    comp_1, args = build(None)
    out_1 = comp_1.muse_step(*args)
    b = keys.shape[0]
    cut = lambda out: {k: np.asarray(out[k])[:b] for k in ("g", "Z")}
    return cut(out_m), cut(out_1), comp_m, comp_1, args


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def multi_pixel_step(n=1024, nsims=16):
    """Pixel GRF muse_step on a sims=2 × field=2 mesh vs one device."""
    from __graft_entry__ import _build
    from muse_tpu.parallel import make_sims_mesh

    mesh = make_sims_mesh(jax.devices()[:4], sims=2, field=2)
    o_m, o_1, comp, _, _ = _mesh_vs_one(
        lambda m: _build(n_grid=n, nsims=nsims, mesh=m), mesh, True)
    r = _rel(o_m["g"], o_1["g"])
    gates = {"finite": gate(bool(np.isfinite(o_m["g"]).all()),
                            np.isfinite(o_m["g"]).all(), "True"),
             "per-lane g rel": gate(r, r <= 1e-4, "<= 1e-4")}
    return gates, {"mesh": dict(mesh.mesh.shape),
                   "fft_mode": comp.problem.grf_config.fft_mode}


def multi_lensing_step(n=16, nsims=3):
    """The dry run's lensing step, data-parallel over every device, vs
    the same step on one device.

    The lensing MAP is nonconvex and stops at |∇z| < atol = 0.1, so two
    compilations of it (per-device batch 1 vs 4) can stop at different
    points, or in different basins, and their scores differ by more than
    roundoff.  The gate is the certifier's (solver/certify.py): per lane,
    the mesh solution's objective exceeds the one-device solution's by at
    most 5% and the latent norms agree within 50%."""
    from __graft_entry__ import _build
    from muse_tpu.models.lensing import lensing_problem
    from muse_tpu.parallel import make_sims_mesh

    mesh = make_sims_mesh()
    o_m, o_1, _, comp, (th, _, keys, _, lanes, _) = _mesh_vs_one(
        lambda m: _build(n_grid=n, nsims=nsims, seed=1, atol=1e-1,
                         problem=lensing_problem(
                             n=n, data_key=jax.random.PRNGKey(42))),
        mesh, False)
    cert = comp.certifier
    f_excess, norm_gap = [], []
    for j in range(keys.shape[0]):
        x = comp.x_obs if int(lanes[j]) == 0 else cert._sample1(keys[j],
                                                                th)[0]
        fm = float(cert._fg1(x, jnp.asarray(o_m["Z"][j]), th)[0])
        f1 = float(cert._fg1(x, jnp.asarray(o_1["Z"][j]), th)[0])
        f_excess.append((fm - f1) / max(abs(f1), 1.0))
        nm, n1 = (float(np.linalg.norm(o["Z"][j])) for o in (o_m, o_1))
        norm_gap.append(abs(nm - n1) / (n1 + 1.0))
    fx, ng = max(f_excess), max(norm_gap)
    gates = {"finite": gate(bool(np.isfinite(o_m["g"]).all()),
                            np.isfinite(o_m["g"]).all(), "True"),
             "objective excess": gate(fx, fx <= 0.05, "<= 0.05"),
             "norm gap": gate(ng, ng <= 0.5, "<= 0.5")}
    return gates, {"mesh": dict(mesh.mesh.shape),
                   "per-lane g rel": _rel(o_m["g"], o_1["g"])}


SINGLE = {"grf_northstar": grf_northstar, "grf_pixel": grf_pixel,
          "lensing": lensing, "funnel_ppl": funnel_ppl,
          "bandpower": bandpower, "fft_probe": fft_probe,
          "quadform_xla": quadform_xla}
MULTI = {"multi_northstar": multi_northstar,
         "multi_pixel_step": multi_pixel_step,
         "multi_lensing_step": multi_lensing_step}


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {_fmt(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    return str(v)


def run_phase(name, fn, **sizes):
    """Run one phase, print its line, raise :class:`GateFailed` on a miss."""
    t0 = time.perf_counter()
    gates, info = fn(**sizes)
    wall = time.perf_counter() - t0
    g = ", ".join(f"{k}={_fmt(v['value'])} ({v['limit']}) "
                  f"{'ok' if v['ok'] else 'FAIL'}" for k, v in gates.items())
    print(f"phase {name}: wall {wall:.3f} s (incl. compile) | gates: "
          f"{g or 'none'} | {_fmt(info)} | peak_bytes_in_use "
          f"{peak_bytes()}", flush=True)
    failed = [k for k, v in gates.items() if not v["ok"]]
    if failed:
        raise GateFailed(f"phase {name}: gate(s) {failed} failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    dev = require_gpu()
    print(f"card (name, power.limit): {card_info()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    table = MULTI if args.multi else SINGLE
    if args.multi and len(jax.devices()) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    for name, fn in table.items():
        run_phase(name, fn)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
