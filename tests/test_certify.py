"""Value-integrity certification tests (muse_tpu/solver/certify.py).

XLA was observed to value-corrupt specific compiled programs at specific
batch widths on the accelerator this engine was first built on (see
certify.py's module docstring) — a failure family the reference never
faces because Julia doesn't miscompile (its results at src/muse.jl:169-176 are trusted
implicitly).  These tests inject that failure mode deliberately: a
``custom_zhat`` that is exact at batch width 1 but corrupts its output
whenever the compiled batch width exceeds 1 (the trace-time analog of a
width-dependent miscompile), and assert that

  * every solver entry point (muse_fit / get_J / get_H-FD) DETECTS the
    corruption via the B=1 re-solve probe and warns loudly,
  * the lane-wise fallback + width rerouting make the final numbers
    IDENTICAL to an uncorrupted run, and
  * an honest solver (batched L-BFGS, and a clean custom solver) passes
    certification with bit-identical results to an uncertified run —
    no false positives, probes are observation-only.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muse_tpu.adapters.simple import SimpleMuseProblem
from muse_tpu.result import MuseResult
from muse_tpu.solver.certify import ChunkCertifier
from muse_tpu.solver.jacobians import get_H, get_J
from muse_tpu.solver.muse import muse_fit

D = 16


def _model_fns():
    """Linear-Gaussian model with a closed-form MAP:
    z ~ N(0, e^θ I), x = z + N(0, I)  ⇒  ẑ = x / (1 + e^{-θ})."""

    def sample_x_z(key, th):
        k1, k2 = jax.random.split(key)
        z = jnp.exp(th / 2) * jax.random.normal(k1, (D,))
        return z + jax.random.normal(k2, (D,)), z

    def log_like(x, z, th):
        return (-0.5 * jnp.sum((x - z) ** 2)
                - 0.5 * jnp.exp(-th) * jnp.sum(z ** 2) - 0.5 * D * th)

    def log_prior(th):
        return -th ** 2 / 18.0

    return sample_x_z, log_like, log_prior


def _problem(corrupt, custom=True, record=None):
    """``corrupt``: exact MAP at B=1, ×1000 garbage at any compiled
    batch width > 1 — the injected width-dependent value corruption.
    ``record`` (a list) logs every compiled batch width used."""
    sample_x_z, log_like, log_prior = _model_fns()

    def zhat(xs, Z0, th_flat, atol):
        B = Z0.shape[0]
        if record is not None:
            record.append(B)
        Z = xs / (1 + jnp.exp(-th_flat[0]))
        if corrupt and B > 1:
            Z = Z * 1000.0
        aux = {"converged": jnp.ones(B, bool),
               "failed": jnp.zeros(B, bool),
               "iterations": jnp.ones(B, jnp.int32)}
        return Z, aux

    x_obs, _ = jax.jit(sample_x_z)(jax.random.PRNGKey(1), 0.0)
    return SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=zhat if custom else None)


def _fit(problem, **kw):
    return muse_fit(MuseResult(), problem, 0.5, nsims=6, maxsteps=4,
                    key=jax.random.PRNGKey(0), **kw)


def test_muse_fit_detects_and_repairs_injected_corruption():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_bad = _fit(_problem(corrupt=True), certify=True)
    msgs = [str(x.message) for x in w]
    assert any("CERTIFICATION FAILED" in m and "muse_step" in m
               for m in msgs)
    r_clean = _fit(_problem(corrupt=False), certify=False)
    # lane-wise fallback runs the exact B=1 solver → identical trajectory
    np.testing.assert_allclose(r_bad.theta, r_clean.theta, rtol=1e-6)
    for hb, hc in zip(r_bad.history, r_clean.history):
        np.testing.assert_allclose(hb["g_like_t"], hc["g_like_t"],
                                   rtol=1e-5)


def test_width_rerouting_after_failure():
    """After a failed verdict the next iterations route to smaller
    widths (7 → 3 → 1), ending at the trusted B=1 program."""
    rec = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _fit(_problem(corrupt=True, record=rec), certify=True)
    # compiled batch widths seen: the initial 7 (B=nsims+1 padded odd),
    # the B=1 probe/fallback program, and intermediate reroutes — the
    # final iterations must run at width 1 (every other width corrupts
    # and gets marked bad)
    assert 1 in rec
    assert rec.count(7) <= 2          # initial chunk + at most one retry


def test_no_false_positive_on_honest_custom_solver():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_cert = _fit(_problem(corrupt=False), certify=True)
    assert not any("CERTIFICATION" in str(x.message) for x in w)
    r_plain = _fit(_problem(corrupt=False), certify=False)
    np.testing.assert_array_equal(r_cert.theta, r_plain.theta)


def test_no_false_positive_on_batched_lbfgs():
    """The generic batched L-BFGS path (no custom solver) certifies:
    per-lane masked lockstep trajectories match their B=1 runs."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r_cert = _fit(_problem(corrupt=False, custom=False), certify=True)
    assert not any("CERTIFICATION" in str(x.message) for x in w)
    r_plain = _fit(_problem(corrupt=False, custom=False), certify=False)
    np.testing.assert_array_equal(r_cert.theta, r_plain.theta)


def test_get_J_detects_and_repairs():
    pb, pc = _problem(corrupt=True), _problem(corrupt=False)
    rb, rc = MuseResult(), MuseResult()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_J(rb, pb, 0.1, key=jax.random.PRNGKey(3), nsims=5,
              certify=True)
    assert any("CERTIFICATION FAILED" in str(x.message) and
               "j_sims" in str(x.message) for x in w)
    get_J(rc, pc, 0.1, key=jax.random.PRNGKey(3), nsims=5, certify=False)
    np.testing.assert_allclose(np.asarray(rb.gs), np.asarray(rc.gs),
                               rtol=1e-6)
    np.testing.assert_allclose(rb.J, rc.J, rtol=1e-6)


def test_get_H_fd_detects_and_repairs():
    pb, pc = _problem(corrupt=True), _problem(corrupt=False)
    rb, rc = MuseResult(), MuseResult()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_H(rb, pb, 0.1, key=jax.random.PRNGKey(3), nsims=3,
              step=0.05, certify=True)
    msgs = [str(x.message) for x in w]
    assert any("CERTIFICATION FAILED" in m for m in msgs)
    get_H(rc, pc, 0.1, key=jax.random.PRNGKey(3), nsims=3, step=0.05,
          certify=False)
    np.testing.assert_allclose(rb.H, rc.H, rtol=1e-5)


def test_get_H_fd_reroutes_width_across_chunks():
    """Regression (round-5 advisor finding): the get_H FD flow records
    failed verdicts under kinds "h_fiducial"/"h_fd" but used to route
    chunk widths by an unrelated kind ("h_fd_sims") — so after a failed
    verdict every later chunk silently ran the slow lane-wise fallback
    at the SAME width instead of rerouting.  With the fix, a mid-pass
    failure moves the remaining chunks to the fallback width."""
    rec = []
    pb = _problem(corrupt=True, record=rec)
    rb = MuseResult()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        get_H(rb, pb, 0.1, key=jax.random.PRNGKey(3), nsims=8,
              step=0.05, max_batch=5, certify=True)
    # chunk 1 runs (and fails) at width 5; chunk 2 must be REROUTED to
    # the fallback width 3 (pre-fix: it stayed at 5 and went lane-wise,
    # so no intermediate width ever appeared in the compiled-width log)
    assert 3 in rec, rec
    # and the repaired numbers still match an uncorrupted run
    rc = MuseResult()
    get_H(rc, _problem(corrupt=False), 0.1, key=jax.random.PRNGKey(3),
          nsims=8, step=0.05, max_batch=5, certify=False)
    np.testing.assert_allclose(rb.H, rc.H, rtol=1e-5)


def test_probe_lane_rotation():
    """Probe lanes include an interior lane and rotate across probe
    calls (a corruption confined to interior lanes is sampled)."""
    cert = ChunkCertifier(comp=None)
    assert cert.probe_lane_set("k", 7, 2) == [0, 1]   # tiny chunk: all
    # simulate successive probed calls at (kind, width)
    seen = set()
    for _ in range(6):
        cert.should_probe("k", 9)
        lanes = cert.probe_lane_set("k", 9, 20)
        assert len(lanes) == 2 and all(0 <= l < 20 for l in lanes)
        seen.update(lanes)
    # first call covers {first, middle}; rotation reaches other lanes
    assert 10 in seen and 0 in seen and len(seen) > 3, sorted(seen)


def test_get_H_implicit_no_false_positive():
    p = _problem(corrupt=False, custom=False)
    r1, r2 = MuseResult(), MuseResult()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_H(r1, p, 0.1, key=jax.random.PRNGKey(3), nsims=3,
              implicit_diff=True, certify=True)
    assert not any("CERTIFICATION" in str(x.message) for x in w)
    get_H(r2, p, 0.1, key=jax.random.PRNGKey(3), nsims=3,
          implicit_diff=True, certify=False)
    np.testing.assert_allclose(r1.H, r2.H, rtol=1e-6)


def test_certify_auto_semantics(monkeypatch):
    """'auto' is off on CPU / for non-field problems — the corrupt
    problem with certify='auto' must NOT be repaired (proving the flag
    gates the machinery), while certify=True catches it anywhere."""
    from muse_tpu.solver import certify as ct
    p = _problem(corrupt=True)
    assert ct.certify_enabled("auto", p, 7) is False   # no fft_grid / CPU
    p.fft_grid = 16
    assert ct.certify_enabled("auto", p, 7) is False   # CPU backend
    assert ct.certify_enabled(True, p, 7) is True
    assert ct.certify_enabled(False, p, 7) is False
    with pytest.raises(ValueError):
        ct.certify_enabled("sometimes", p, 7)

    # round-5 widening: on a non-CPU backend, "auto" also arms for
    # field-scale custom_zhat problems that declare NO fft_grid (the
    # spectral-GRF/bandpower flagship bench paths) — and stays off for
    # small-latent custom solvers and for plain-L-BFGS problems
    monkeypatch.setattr(ct.jax, "default_backend", lambda: "gpu")
    p.fft_grid = None
    assert p.custom_zhat is not None
    assert ct.certify_enabled("auto", p, 7) is False              # no nz
    assert ct.certify_enabled("auto", p, 7, nz=512) is False      # small
    assert ct.certify_enabled("auto", p, 7,
                              nz=ct.FIELD_SCALE_NZ) is True       # field
    assert ct.certify_enabled("auto", p, 1, nz=ct.FIELD_SCALE_NZ) \
        is False                                                  # B=1
    p.fft_grid = 16
    assert ct.certify_enabled("auto", p, 7) is True               # fft
    p_plain = _problem(corrupt=False, custom=False)
    assert ct.certify_enabled("auto", p_plain, 7, nz=ct.FIELD_SCALE_NZ) \
        is False                                                  # no custom


def test_fallback_width_chain():
    assert ChunkCertifier.fallback_width(17) == 9
    assert ChunkCertifier.fallback_width(9) == 5
    assert ChunkCertifier.fallback_width(5) == 3
    assert ChunkCertifier.fallback_width(3) == 1
    assert ChunkCertifier.fallback_width(1) == 1
