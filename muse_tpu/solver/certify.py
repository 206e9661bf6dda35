"""Runtime value-integrity certification for compiled MAP programs.

Why this exists: the reference gets value integrity for free from the
Julia runtime — when ``src/muse.jl:169-176`` gathers per-sim MAP results
it can trust the numbers.  An XLA backend need not give that: on the
accelerator this engine was first built on, XLA VALUE-CORRUPTED specific
compiled programs at specific batch widths (identical per-lane inputs
produced ‖ẑ‖ ~ 5×10⁵ vs 80 and objective 10¹¹ vs 5×10⁵ at lane counts
13/17 of the 1024² lensing VarPro while width 5 was exact; a separate
fused batched-FFT family silently biased θ̂ by ~50σ —
``muse_tpu/utils/fft_check.py``).  Structural probes cannot see this:
``fused_fft_ok(1024, 17)`` passed while the full while_loop program
corrupted, because the trigger was the compiled program's overall
structure, not any single op.  Whether the GPU needs the guard on by
default is open (ROADMAP D1(b)); ``chip_smoke.py`` prints its verdicts.

So the guard is *semantic*, not structural: after a batched MAP chunk
completes, re-solve 1–2 sampled lanes with an INDEPENDENTLY COMPILED
single-lane program (batch width 1 — a different XLA program by shape,
and exactly the per-sim execution model of the reference / the
sequential baseline, which has been correct at every width tested) from
the same inputs and warm starts, then compare

  * the true objective  f = −logLike(x, ẑ, θ)  recomputed by a third,
    tiny evaluator program at BOTH solutions, and
  * the latent norms ‖ẑ‖,

within loose tolerances.  Corruption of the measured family is ~10⁶×
off, so tolerances of a few percent detect it with no false positives
from legitimate trajectory divergence (the batched solvers are per-lane
masked — lanes do not interact — so the B=1 trajectory from the same
start matches up to roundoff).

On a failed verdict the solvers (a) warn loudly, (b) re-run the
affected chunk lane-by-lane with the certified B=1 program, and (c)
route future chunks to a smaller width (``fallback_width``), which is
itself certified as it is used — terminating at width 1, which is the
reference program itself.  Verdicts are cached per (program kind,
width) on the :class:`~muse_tpu.solver.compiled.CompiledProblem`, so
the muse/get_J/get_H flows of one fit share routing decisions.

Enabled by ``certify="auto"`` (the default on ``muse_fit``/``get_J``/
``get_H``): on for problems that declare ``fft_grid`` (the field models,
where the corruption families were seen) on non-CPU backends; ``True``
forces it anywhere (used by the injected-corruption tests), ``False``
disables.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ChunkCertifier", "certify_enabled", "CertificationError"]


class CertificationError(RuntimeError):
    """Raised only in ``strict`` mode when a chunk fails certification."""


# latent sizes at/above this are "field scale" — the regime where the
# measured batch-width corruption families live (256² and up)
FIELD_SCALE_NZ = 256 * 256


def certify_enabled(certify, problem, width: int, nz=None) -> bool:
    """Resolve the ``certify`` kwarg ("auto" | True | False).

    "auto" arms on non-CPU backends for problems in the measured-risk
    class: any problem declaring ``fft_grid`` (the original corruption
    family), and — round-5 widening — any problem with a custom batched
    latent solver (``custom_zhat``) at field-scale nz (≥ 256²): the
    spectral-GRF/bandpower flagship paths set ``fft_grid=None`` yet run
    exactly the kind of large compiled while_loop program the corruption
    family targets, so the headline bench paths must not go unprobed.
    """
    if certify is True:
        return True
    if certify is False or certify is None:
        return False
    if certify != "auto":
        raise ValueError(f"certify must be 'auto', True or False, "
                         f"got {certify!r}")
    if width <= 1 or jax.default_backend() == "cpu":
        return False
    if getattr(problem, "fft_grid", None) is not None:
        return True
    return (getattr(problem, "custom_zhat", None) is not None
            and nz is not None and nz >= FIELD_SCALE_NZ)


class ChunkCertifier:
    """Spot-verifies batched MAP chunks against a B=1 reference program.

    One instance lives on a :class:`CompiledProblem` (``comp.certifier``)
    so every solver entry point sharing the compiled problem also shares
    verdicts and width routing.

    ``rtol``       — objective tolerance: the batch lane's true objective
                     may exceed the B=1 re-solve's by at most
                     rtol·max(|f_ref|, 1).  (One-sided: a *lower* batch
                     objective is a legitimately better solution, not
                     corruption — the evaluator recomputing f is
                     independent of both solver programs.)
    ``norm_rtol``  — latent-norm tolerance: |‖ẑ_b‖ − ‖ẑ_ref‖| ≤
                     norm_rtol·(‖ẑ_ref‖ + 1).
    ``probe_lanes``— lanes re-solved per probed chunk.
    ``recheck_every`` — after the first two calls at a (kind, width),
                     re-probe every Nth chunk call (cheap insurance:
                     a probe costs ~probe_lanes/width of the chunk).
    """

    def __init__(self, comp, *, rtol: float = 0.05,
                 norm_rtol: float = 0.5, probe_lanes: int = 2,
                 recheck_every: int = 8, strict: bool = False):
        self.comp = comp
        self.rtol = float(rtol)
        self.norm_rtol = float(norm_rtol)
        self.probe_lanes = int(probe_lanes)
        self.recheck_every = int(recheck_every)
        self.strict = bool(strict)
        self._bad = set()          # {(kind, width)} failed certification
        self._calls = {}           # (kind, width) -> chunk-call count
        self.events = []           # audit log of failed probes
        self.verdicts = []         # (kind, width, passed) of every probe

    # ---------------- single-lane reference programs ---------------- #
    # Each is its own jit → its own XLA program, compiled independently
    # of the batched solvers it checks.

    @functools.cached_property
    def _sample1(self):
        return jax.jit(self.comp._sample_flat)

    @functools.cached_property
    def _guess1(self):
        return jax.jit(self.comp._zhat_guess_flat)

    @functools.cached_property
    def _fg1(self):
        comp = self.comp

        def fg(x, z, th):
            f, g = jax.value_and_grad(
                lambda zz: -comp._ll(x, zz, th))(z)
            return f, jnp.max(jnp.abs(g))
        return jax.jit(fg)

    @functools.cached_property
    def _gradth1(self):
        return jax.jit(self.comp._grad_th)

    @functools.cached_property
    def _solve1(self):
        comp = self.comp

        def run(x, z0, th, atol):
            xs = jax.tree.map(lambda v: v[None], x)
            Z, _aux = comp._solve_maps(xs, z0[None], th, atol)
            return Z[0]
        return jax.jit(run)

    # ---------------- verdict bookkeeping ---------------- #

    def is_bad(self, kind, width: int) -> bool:
        """``kind`` may be one kind or a tuple of kinds that share a chunk
        width (the get_H FD flow records verdicts under both "h_fiducial"
        and "h_fd" for the same sims-chunk width — routing must consult
        every kind that can mark the width bad)."""
        kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        return any((k, width) in self._bad for k in kinds)

    def route_width(self, kind, width: int) -> int:
        """Smallest-change reroute away from widths known bad."""
        while width > 1 and self.is_bad(kind, width):
            width = self.fallback_width(width)
        return width

    @staticmethod
    def fallback_width(width: int) -> int:
        """Next candidate width after a failure: roughly halve, keep odd
        (the empirically safer family for the fused-FFT bug), floor 1."""
        return max(1, (width // 2) | 1)

    def should_probe(self, kind: str, width: int) -> bool:
        if width <= 1:                     # B=1 IS the reference program
            return False
        k = (kind, width)
        if k in self._bad:
            return False                   # caller must re-run lane-wise
        n = self._calls.get(k, 0)
        self._calls[k] = n + 1
        return n < 2 or (self.recheck_every > 0
                         and n % self.recheck_every == 0)

    def probe_lane_set(self, kind: str, width: int, n_lanes: int):
        """Lanes to re-solve for this probe call.

        Deterministic rotation (reproducible, no RNG state): the first
        probe covers {first, middle}, later probes rotate through the
        lane positions, so a corruption confined to interior lanes or to
        specific positions is still sampled over the probe schedule —
        the measured corruption family is all-lane, but the lane choice
        costs nothing to vary.

        Trajectory-equivalence assumption (why ``rtol``/``norm_rtol``
        can be tight): the batched solvers are PER-LANE MASKED — lanes
        never interact — so a B=1 re-solve from the same inputs follows
        the same trajectory up to roundoff.  A future solver whose inner
        loop couples lanes (e.g. a global while_loop bound on a shared
        CG) can legitimately diverge from its B=1 instantiation and
        would need looser tolerances here.
        """
        n = max(1, int(n_lanes))
        r = max(0, self._calls.get((kind, width), 1) - 1)
        base = (0, n // 2, n - 1)
        lanes, i = [], 0
        while len(lanes) < min(self.probe_lanes, n):
            cand = (base[i % 3] + (i // 3) + r * 7919) % n
            if cand not in lanes:
                lanes.append(cand)
            i += 1
        return sorted(lanes)

    # ---------------- the probe ---------------- #

    def probe(self, kind: str, width: int, lanes, x_of, z0_of, Z_out,
              th, atol) -> bool:
        """Certify chunk output ``Z_out`` by re-solving ``lanes``.

        ``x_of(i)``/``z0_of(i)`` return lane i's observation and warm
        start (host-side reconstruction: data lane → x_obs, sim lanes →
        the jitted single-lane sampler with the lane's key).  Returns
        True when every probed lane certifies; on failure records the
        verdict, warns (or raises in strict mode) and returns False.
        """
        th = jnp.asarray(th)
        atol = jnp.asarray(atol)
        for i in lanes:
            x = x_of(i)
            zb = jnp.asarray(Z_out[i])
            fb, _gb = self._fg1(x, zb, th)
            fb = float(fb)
            z_ref = self._solve1(x, jnp.asarray(z0_of(i)), th, atol)
            fr, _gr = self._fg1(x, z_ref, th)
            fr = float(fr)
            nb = float(jnp.linalg.norm(zb))
            nr = float(jnp.linalg.norm(z_ref))
            scale = max(abs(fr), 1.0)
            bad = (not np.isfinite(fb)
                   or fb - fr > self.rtol * scale
                   or abs(nb - nr) > self.norm_rtol * (nr + 1.0))
            if bad:
                self.verdicts.append((kind, width, False))
                self._bad.add((kind, width))
                ev = {"kind": kind, "width": width, "lane": int(i),
                      "f_batch": fb, "f_ref": fr,
                      "z_norm_batch": nb, "z_norm_ref": nr}
                self.events.append(ev)
                msg = (
                    f"VALUE-INTEGRITY CERTIFICATION FAILED for the "
                    f"compiled {kind!r} program at batch width {width}: "
                    f"lane {i} re-solved with the independently compiled "
                    f"B=1 program gives objective {fr:.6g} / ‖ẑ‖ "
                    f"{nr:.6g}, but the batched program produced "
                    f"{fb:.6g} / {nb:.6g}. This is the compiler "
                    "batch-width value-corruption family (see "
                    "muse_tpu/solver/certify.py). The affected chunk is "
                    "re-run lane-by-lane with the certified program and "
                    "future chunks are routed to width "
                    f"{self.route_width(kind, self.fallback_width(width))}"
                    "; results remain correct but slower — consider "
                    "max_batch at a width that certifies.")
                if self.strict:
                    raise CertificationError(msg)
                warnings.warn(msg)
                return False
        self.verdicts.append((kind, width, True))
        return True

    # ---------------- lane-wise fallback runner ---------------- #

    def rerun_lanewise(self, call_fn, n_lanes: int, slice_args):
        """Re-run a chunk one lane at a time with the B=1 program.

        ``call_fn(*lane_args)`` invokes the batched entry point (its B=1
        instantiation is a fresh XLA program — the certified reference);
        ``slice_args(i)`` returns the per-lane argument tuple.  Outputs
        are host-concatenated into one dict shaped like the chunk's.
        """
        parts = []
        for i in range(n_lanes):
            parts.append(call_fn(*slice_args(i)))
        out = {}
        for k in parts[0]:
            vals = [p[k] for p in parts]
            out[k] = (jnp.concatenate([jnp.asarray(v) for v in vals])
                      if hasattr(vals[0], "ndim") and
                      jnp.asarray(vals[0]).ndim >= 1
                      else jnp.stack([jnp.asarray(v) for v in vals]))
        return out
