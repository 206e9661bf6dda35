"""End-to-end statistical tests on the noisy funnel — the reference's test
strategy (test/runtests.jl: full muse+J+H pipeline, assert θ̂/σ < 2) plus
stronger analytic oracles the reference lacks (SURVEY §4 implication)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from muse_tpu import (MuseResult, check_self_consistency, get_H, get_J,
                      muse, muse_fit)
from muse_tpu.models import funnel_problem, vector_funnel_problem, \
    funnel_analytic_H

DIM = 128
NSIMS = 50


@pytest.fixture(scope="module")
def prob():
    return funnel_problem(DIM, theta_true=0.0,
                          data_key=jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def fitted(prob):
    return muse(prob, 1.0, nsims=NSIMS, maxsteps=30, get_covariance=True,
                key=jax.random.PRNGKey(1))


def test_self_consistency(prob):
    assert check_self_consistency(prob, 1.0)


def test_zscore_oracle(fitted):
    """The reference's entire correctness oracle (test/runtests.jl:31)."""
    z = abs(float(fitted.theta[0])) / float(fitted.sigma[0])
    assert z < 2.0


def test_result_fields_populated(fitted):
    assert fitted.H is not None and fitted.J is not None
    assert fitted.Sigma is not None and fitted.Sigma_inv is not None
    assert fitted.dist is not None
    assert len(fitted.history) >= 2
    assert len(fitted.gs) == NSIMS
    assert fitted.time > 0
    assert "theta=" in repr(fitted)


def test_H_matches_analytic(prob, fitted):
    """Analytic oracle: H(θ̂) within MC error of the closed form."""
    th = float(fitted.theta[0])
    expected = funnel_analytic_H(th, DIM)
    got = float(np.asarray(fitted.H)[0, 0])
    per_sim_std = np.std([h[0, 0] for h in fitted.Hs], ddof=1)
    mc_err = 4 * per_sim_std / np.sqrt(len(fitted.Hs)) + 0.05 * expected
    assert abs(got - expected) < mc_err


def test_implicit_and_fd_H_agree(prob):
    r1, r2 = MuseResult(), MuseResult()
    get_J(r1, prob, 0.0, nsims=30)
    r2.gs = [g.copy() for g in r1.gs]
    get_H(r1, prob, 0.0, nsims=5, grad_z_atol=1e-3)
    get_H(r2, prob, 0.0, nsims=5, implicit_diff=True)
    np.testing.assert_allclose(r1.H, r2.H, rtol=2e-2)


def test_resume_continues_iteration(prob):
    res = MuseResult()
    muse_fit(res, prob, 1.0, nsims=20, maxsteps=2, key=jax.random.PRNGKey(3))
    assert len(res.history) == 2
    theta_mid = res.theta.copy()
    muse_fit(res, prob, nsims=20, maxsteps=10)
    assert len(res.history) > 2
    # resumed run starts from where the first left off
    np.testing.assert_allclose(res.history[2]["theta_unreg"], theta_mid)


def test_checkpoint_roundtrip(prob, tmp_path):
    f = str(tmp_path / "ckpt.pkl")
    res = MuseResult()
    muse_fit(res, prob, 1.0, nsims=20, maxsteps=2,
             key=jax.random.PRNGKey(3), checkpoint_file=f)
    loaded = MuseResult.load(f)
    assert len(loaded.history) == 2
    np.testing.assert_allclose(loaded.theta, res.theta)
    # loaded result resumes
    muse_fit(loaded, prob, nsims=20, maxsteps=4)
    assert len(loaded.history) >= 2


def test_incremental_get_J(prob):
    """get_J resume: raising nsims adds only new sims, and the first batch
    is bit-identical to a fresh larger run's prefix (CRN key discipline,
    src/muse.jl:499-506)."""
    key = jax.random.PRNGKey(5)
    r1 = MuseResult()
    get_J(r1, prob, 0.0, key=key, nsims=10)
    assert len(r1.gs) == 10
    get_J(r1, prob, 0.0, nsims=20)
    assert len(r1.gs) == 20

    r2 = MuseResult()
    get_J(r2, prob, 0.0, key=key, nsims=20)
    np.testing.assert_allclose(np.asarray(r1.gs), np.asarray(r2.gs),
                               rtol=1e-5)


def test_get_H_incremental(prob):
    r = MuseResult()
    get_J(r, prob, 0.0, nsims=20)
    get_H(r, prob, 0.0, nsims=3)
    assert len(r.Hs) == 3
    H3 = np.asarray(r.H).copy()
    get_H(r, prob, 0.0, nsims=6)
    assert len(r.Hs) == 6
    assert not np.allclose(np.asarray(r.H), H3)  # mean updated


def test_alpha_schedule_and_regularize(prob):
    steps = []
    res = muse(prob, 1.0, nsims=10, maxsteps=3,
               alpha=lambda i: 0.5 if i == 1 else 0.9,
               regularize=lambda t: np.clip(t, -5, 5),
               key=jax.random.PRNGKey(7))
    assert len(res.history) >= 2


def test_broyden_update_runs(prob):
    res = muse(prob, 1.0, nsims=20, maxsteps=6, Hinv_update="broyden",
               theta_rtol=1e-3, key=jax.random.PRNGKey(8))
    assert len(res.history) >= 3
    res2 = muse(prob, 1.0, nsims=20, maxsteps=6,
                Hinv_update="diagonal_broyden", theta_rtol=1e-3,
                key=jax.random.PRNGKey(8))
    assert np.isfinite(res2.theta).all()


def test_vector_theta_pipeline():
    prob = vector_funnel_problem(dim=64, blocks=2,
                                 data_key=jax.random.PRNGKey(9))
    res = muse(prob, jnp.zeros(2) + 0.5, nsims=30, maxsteps=20,
               get_covariance=True, key=jax.random.PRNGKey(10))
    assert res.theta.shape == (2,)
    assert np.asarray(res.H).shape == (2, 2)
    assert np.asarray(res.J).shape == (2, 2)
    assert np.asarray(res.Sigma).shape == (2, 2)
    # each component within 3σ of truth (0)
    z = np.abs(res.theta) / res.sigma
    assert (z < 3).all()


def test_save_maps_stores_zhat(prob):
    res = muse(prob, 1.0, nsims=5, maxsteps=2, save_maps=True,
               key=jax.random.PRNGKey(11))
    assert res.history[0]["zhat_dat"] is not None
    assert res.history[0]["zhat_dat"].shape == (DIM,)


def test_max_batch_chunking_matches_unchunked(prob):
    """max_batch (BatchWorkerPool analog) must not change results."""
    key = jax.random.PRNGKey(6)
    r1, r2 = MuseResult(), MuseResult()
    get_J(r1, prob, 0.0, key=key, nsims=11)
    get_J(r2, prob, 0.0, key=key, nsims=11, max_batch=4)
    np.testing.assert_allclose(np.asarray(r1.gs), np.asarray(r2.gs),
                               rtol=1e-5)
    get_H(r1, prob, 0.0, nsims=3)
    get_H(r2, prob, 0.0, nsims=3, max_batch=2)
    np.testing.assert_allclose(np.asarray(r1.Hs), np.asarray(r2.Hs),
                               rtol=1e-4)


def test_muse_loop_max_batch_matches(prob):
    """Chunked muse-loop lanes (memory-bounded) are bit-identical."""
    key = jax.random.PRNGKey(12)
    r1 = muse(prob, 1.0, nsims=14, maxsteps=4, key=key)
    r2 = muse(prob, 1.0, nsims=14, maxsteps=4, key=key, max_batch=5)
    np.testing.assert_allclose(r1.theta, r2.theta, rtol=1e-6)
    assert len(r1.history) == len(r2.history)


def test_save_maps_stores_sims_too(prob):
    res = muse(prob, 1.0, nsims=5, maxsteps=2, save_maps=True,
               key=jax.random.PRNGKey(13))
    zs = res.history[0]["zhat_sims"]
    assert zs is not None and zs.shape == (5, DIM)


def test_progress_reporting_smoke(prob, capsys):
    res = muse(prob, 1.0, nsims=5, maxsteps=2, progress=True,
               key=jax.random.PRNGKey(14))
    assert len(res.history) == 2


def test_progress_get_J_get_H_smoke(prob):
    """progress=True must actually tick in get_J/get_H (VERDICT r1: the
    kwargs were dead parameters; reference shows progress for both,
    src/muse.jl:325,507)."""
    r = MuseResult()
    get_J(r, prob, 0.0, nsims=5, progress=True, key=jax.random.PRNGKey(15))
    get_H(r, prob, 0.0, nsims=2, progress=True)
    assert len(r.gs) == 5 and len(r.Hs) == 2
    r2 = MuseResult()
    get_J(r2, prob, 0.0, nsims=3, key=jax.random.PRNGKey(15))
    get_H(r2, prob, 0.0, nsims=2, implicit_diff=True, progress=True)
    assert len(r2.Hs) == 2


def test_loaded_result_dist_rebuilt(fitted, tmp_path):
    """Regression (ADVICE r1): save() used dataclasses.asdict, which
    deep-converted result.dist into a plain dict; after load() the dist
    must be a working distribution again."""
    f = str(tmp_path / "full.pkl")
    fitted.save(f)
    loaded = MuseResult.load(f)
    assert loaded.dist is not None
    draw = loaded.dist.sample(jax.random.PRNGKey(0))
    assert np.isfinite(float(loaded.dist.log_prob(draw)))
    np.testing.assert_allclose(float(loaded.dist.scale),
                               float(fitted.sigma[0]), rtol=1e-6)


def test_implicit_H_preconditioner():
    """The reference's Pl CG-preconditioner hook (src/muse.jl:312,380-384):
    with the exact Fourier-diagonal inverse of the whitened-GRF z-Hessian
    (I + C/σ²), budget-limited CG must leave far smaller residuals than
    unpreconditioned CG, and H must stay consistent."""
    from muse_tpu.models.grf import grf_problem
    n, s2 = 16, 0.1 ** 2
    gp = grf_problem(n=n, sigma_noise=0.1, solver="cg",
                     data_key=jax.random.PRNGKey(42))
    cfg = gp.grf_config

    def precond(w, x, th):
        C = cfg.spectrum(th[0])
        W = w.reshape(n, n)
        return jnp.fft.irfft2(jnp.fft.rfft2(W) / (1.0 + C / s2),
                              s=(n, n)).reshape(-1)

    key = jax.random.PRNGKey(16)
    r_plain, r_pre = MuseResult(), MuseResult()
    kw = dict(key=key, nsims=3, implicit_diff=True,
              implicit_diff_cg_maxiter=8, implicit_diff_cg_tol=1e-10)
    get_H(r_plain, gp, 0.0, **kw)
    get_H(r_pre, gp, 0.0, implicit_diff_precond=precond, **kw)
    res_plain = np.asarray(r_plain.metadata["implicit_diff_cg_resid"])
    res_pre = np.asarray(r_pre.metadata["implicit_diff_cg_resid"])
    assert res_pre.max() < 0.1 * res_plain.max()
    np.testing.assert_allclose(r_pre.H, r_plain.H, rtol=0.2)


def test_adaptive_fd_recovers_from_bad_step(prob):
    """fd_order='adaptive' (the central_fdm(3,1)-role analog,
    src/muse.jl:300): starting from a deliberately 100×-too-large step,
    the step-rebalancing rounds must bring H to the analytic value, where
    plain fd_order=4 at the same step is dominated by truncation error."""
    from muse_tpu import MuseResult, get_H

    key = jax.random.PRNGKey(13)
    expected = funnel_analytic_H(0.0, DIM)
    bad_step = 5.0

    r4, ra = MuseResult(), MuseResult()
    get_H(r4, prob, 0.0, key=key, nsims=4, step=bad_step, fd_order=4,
          grad_z_atol=1e-3)
    get_H(ra, prob, 0.0, key=key, nsims=4, step=bad_step,
          fd_order="adaptive", grad_z_atol=1e-3)
    err4 = abs(float(r4.H[0, 0]) - expected) / expected
    erra = abs(float(ra.H[0, 0]) - expected) / expected
    assert erra < 0.05, f"adaptive H off by {erra:.1%}"
    assert erra < err4, (erra, err4)
    meta = ra.metadata["fd_adaptive"]
    assert len(meta) >= 2              # at least one rebalancing round
    assert meta[-1]["step"][0] < bad_step


def test_get_J_reuse_semantics_and_warning(prob):
    """muse_fit stores its per-sim scores in result.gs (src/muse.jl:231);
    a subsequent explicit get_J reuses them (resume semantics,
    src/muse.jl:499-506) and must SAY so — silent full reuse at flagship
    scale is how a 1300× J discrepancy went unnoticed (BENCHMARKS.md
    "Which J is the right one").  The internal get_covariance flow, where
    the reuse is the reference's designed behavior, stays silent."""
    res = MuseResult()
    muse_fit(res, prob, 1.0, nsims=10, maxsteps=2, key=jax.random.PRNGKey(3))
    assert len(res.gs) == 10            # fit populated result.gs
    fit_gs = np.asarray(res.gs).copy()

    with pytest.warns(UserWarning, match="reusing 10 existing"):
        get_J(res, prob, nsims=10, key=jax.random.PRNGKey(5))
    # full reuse: no new sims ran, J is the covariance of the fit's scores
    np.testing.assert_array_equal(np.asarray(res.gs), fit_gs)

    # partial reuse warns too, and tops up to nsims
    with pytest.warns(UserWarning, match="reusing 10 existing"):
        get_J(res, prob, nsims=14, key=jax.random.PRNGKey(5))
    assert len(res.gs) == 14

    # a fresh result computes everything, no warning
    import warnings as _w
    r2 = MuseResult()
    with _w.catch_warnings():
        _w.simplefilter("error", UserWarning)
        get_J(r2, prob, 1.0, nsims=5, key=jax.random.PRNGKey(5))
    assert len(r2.gs) == 5


def test_adaptive_fd_reuses_fiducial_fits(prob):
    """Rebalancing rounds must NOT re-run the step-independent fiducial
    MAPs (at field scale they dominate FD get_H cost) and the progress
    total must grow per extra round rather than assume all of them."""
    from muse_tpu import MuseResult, get_H
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec

    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    calls = {"n": 0}
    real = comp.h_fiducial

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    comp.h_fiducial = counting     # overwrite the cached_property slot
    r = MuseResult()
    get_H(r, prob, 0.0, key=jax.random.PRNGKey(13), nsims=4, step=5.0,
          fd_order="adaptive", grad_z_atol=1e-3, compiled=comp)
    assert len(r.metadata["fd_adaptive"]) >= 2    # rebalancing happened
    assert calls["n"] == 1                         # single-chunk, one pass


def test_progress_reporter_grow():
    from muse_tpu.utils.progress import ProgressReporter
    p = ProgressReporter(10, "t", enabled=False)
    p.grow(5)
    assert p.total == 15
    p.grow(-3)                     # negative growth is ignored
    assert p.total == 15
    p.close()


def test_get_J_skip_errors_drops_failed_sims():
    """Reference fault-tolerance semantics (src/muse.jl:515-521): a failed
    per-sim MAP raises by default, and with skip_errors=True is dropped
    with a warning while the surviving sims still produce J."""
    from muse_tpu.adapters.simple import SimpleMuseProblem

    D = 16

    def sxz(key, th):
        k1, k2 = jax.random.split(key)
        z = jnp.exp(th / 2) * jax.random.normal(k1, (D,))
        return z + jax.random.normal(k2, (D,)), z

    def ll(x, z, th):
        base = -0.5 * (jnp.sum((x - z) ** 2)
                       + jnp.sum(z ** 2) / jnp.exp(th) + D * th)
        # poison a deterministic subset of sims (data-mean cut)
        return base + jnp.where(jnp.mean(x) > 0.15, jnp.nan, 0.0)

    x0 = jnp.zeros((D,))          # healthy observed data
    prob = SimpleMuseProblem(x0, sxz, ll, lambda t: -t ** 2 / 18)
    key, nsims = jax.random.PRNGKey(0), 24

    with pytest.raises(RuntimeError, match="skip_errors"):
        get_J(MuseResult(), prob, 0.0, key=key, nsims=nsims)

    r = MuseResult()
    with pytest.warns(UserWarning, match="dropping"):
        get_J(r, prob, 0.0, key=key, nsims=nsims, skip_errors=True)
    assert 0 < len(r.gs) < nsims
    assert np.isfinite(r.J).all()


def test_broyden_memory_bounded_replay(prob):
    """Hinv_update='broyden' with a small replay memory (the reference's
    broyden_memory, src/muse.jl:192-205) still converges on the funnel."""
    r = MuseResult()
    muse_fit(r, prob, 1.0, nsims=12, maxsteps=12, Hinv_update="broyden",
             broyden_memory=2, key=jax.random.PRNGKey(4))
    assert abs(float(r.theta[0])) < 1.0


def test_profile_dir_writes_trace(prob, tmp_path):
    """profile_dir routes the fit through jax.profiler.trace (the
    tracing/observability hook, SURVEY §5)."""
    d = tmp_path / "prof"
    r = MuseResult()
    muse_fit(r, prob, 1.0, nsims=6, maxsteps=2, profile_dir=str(d),
             key=jax.random.PRNGKey(5))
    assert d.exists() and any(d.rglob("*"))   # trace events were written


def test_get_J_chunk_checkpoint_resume(prob, tmp_path):
    """A flagship-scale J killed mid-run must resume from the per-chunk
    checkpoint and finish bit-identically to an uninterrupted run (CRN
    prefix identity)."""
    from muse_tpu.result import load_result
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec

    f = str(tmp_path / "j.pkl")
    key = jax.random.PRNGKey(9)

    r_ref = MuseResult()
    get_J(r_ref, prob, 0.0, key=key, nsims=12, max_batch=5)

    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    real, calls = comp.j_sims, {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated process kill")
        return real(*a, **k)

    comp.j_sims = dying
    r1 = MuseResult()
    with pytest.raises(RuntimeError, match="process kill"):
        get_J(r1, prob, 0.0, key=key, nsims=12, max_batch=5,
              compiled=comp, checkpoint_file=f)

    r2 = load_result(f)
    assert 0 < len(r2.gs) < 12          # first chunk survived the kill
    with pytest.warns(UserWarning, match="reusing"):
        get_J(r2, prob, 0.0, key=key, nsims=12, max_batch=5)
    np.testing.assert_array_equal(np.asarray(r2.gs), np.asarray(r_ref.gs))
    np.testing.assert_allclose(r2.J, r_ref.J)


def test_get_H_fd_chunk_checkpoint_resume(prob, tmp_path):
    """Fixed-step FD get_H commits per chunk like the implicit path: a
    kill mid-run loses at most one chunk, and the resumed run finishes
    bit-identically (CRN prefix identity, salt=1 keys)."""
    from muse_tpu.result import load_result
    from muse_tpu.solver.compiled import CompiledProblem
    from muse_tpu.theta import ThetaSpec

    f = str(tmp_path / "hfd.pkl")
    key = jax.random.PRNGKey(11)
    r_ref = MuseResult()
    get_H(r_ref, prob, 0.0, key=key, nsims=6, max_batch=3, step=0.05)

    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    real, calls = comp.h_fd, {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated process kill")
        return real(*a, **k)

    comp.h_fd = dying
    r1 = MuseResult()
    with pytest.raises(RuntimeError, match="process kill"):
        get_H(r1, prob, 0.0, key=key, nsims=6, max_batch=3, step=0.05,
              compiled=comp, checkpoint_file=f)
    r2 = load_result(f)
    assert 0 < len(r2.Hs) < 6           # first chunk survived the kill
    get_H(r2, prob, 0.0, key=key, nsims=6, max_batch=3, step=0.05)
    np.testing.assert_allclose(np.asarray(r2.Hs), np.asarray(r_ref.Hs))
    np.testing.assert_allclose(r2.H, r_ref.H)


def test_get_H_checkpoint_and_incremental_resume(prob, tmp_path):
    """get_H(checkpoint_file=...) persists per-chunk; reloading and
    re-calling with the same nsims is a pure no-op (Hs resume counting,
    src/muse.jl:317-319)."""
    from muse_tpu.result import load_result

    f = str(tmp_path / "h.pkl")
    key = jax.random.PRNGKey(10)
    r = MuseResult()
    get_H(r, prob, 0.0, key=key, nsims=5, max_batch=3, implicit_diff=True,
          checkpoint_file=f)
    r2 = load_result(f)
    assert len(r2.Hs) == 5
    get_H(r2, prob, 0.0, key=key, nsims=5, max_batch=3, implicit_diff=True)
    np.testing.assert_allclose(r2.H, r.H)


def test_convergence_guard_non_nd_hinv():
    """A Hinv_post that has lost negative-definiteness (possible under
    Broyden replay) must NOT silently declare convergence: the raw
    metric -ΔθᵀH⁻¹Δθ clamps negative values to 0 — the guard warns and
    falls back to the magnitude (VERDICT r3 weak #6).  Convergence also
    requires the last TWO steps to pass (the consecutiveness guard: one
    small damped step far from the root is not convergence — measured
    stopping at θ̂=+0.199 vs exact MLE −0.125 on the canonical funnel
    under the reference's single-step rule)."""
    import warnings

    from muse_tpu.solver.muse import _theta_converged

    dth = np.array([1.0, 0.0])
    hist = [
        {"theta_t": np.zeros(2)},
        {"theta_t": dth,
         # positive-definite Hinv_post: metric = -1 < 0 (ND lost)
         "Hinv_post_t": np.eye(2)},
    ]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        # |metric| = 1 ≥ rtol: must NOT converge (raw formula would)
        assert not _theta_converged(hist, 0.5, i=3)
        assert any("negative definite" in str(wi.message) for wi in w)

    # healthy ND Hinv_post, 3-entry history with two sub-tolerance steps:
    # the reference semantics (converged), no warning
    hist3 = [
        {"theta_t": np.zeros(2)},
        {"theta_t": dth, "Hinv_post_t": -np.eye(2)},
        {"theta_t": dth + np.array([0.9, 0.0]), "Hinv_post_t": -np.eye(2)},
    ]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert _theta_converged(hist3, 1.5, i=4)    # steps 1.0, 0.9 < 1.5
        assert not _theta_converged(hist3, 0.95, i=4)  # older step 1.0 fails
        assert not w

    # consecutiveness: a single small step after a big one must NOT stop
    hist3[-1]["theta_t"] = dth + np.array([0.1, 0.0])
    assert not _theta_converged(hist3, 0.5, i=4)    # steps 1.0, 0.1
    # ...and with only one (small) step on record, keep iterating
    assert not _theta_converged(hist3[1:], 0.5, i=3)

    # zero final step alone is not yet convergence under the two-step
    # rule (the next iteration repeats it and stops); two zero steps are
    hist0 = [
        {"theta_t": np.zeros(2)},
        {"theta_t": np.zeros(2), "Hinv_post_t": np.eye(2)},
        {"theta_t": np.zeros(2), "Hinv_post_t": np.eye(2)},
    ]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert _theta_converged(hist0, 0.5, i=4)
        assert not _theta_converged(hist0[1:], 0.5, i=3)
        assert not w


def test_midmarch_stop_warning():
    """The θ_rtol stop is a σ-scaled STEP test and can freeze a damped
    march far from the root (measured: 256² lensing stalled at θ≈0.08
    vs truth 0.3).  When the stop fires while |g_post| is still at its
    running max AND above the MC noise floor, the solver must warn; a
    genuinely converged stop (score at the noise floor) must not."""
    import warnings

    from muse_tpu.solver.muse import _warn_midmarch_stop

    def hist_entry(g_post, sims_sd=1.0, nsims_=100):
        rng = np.random.default_rng(0)
        return {"g_post_t": np.asarray(g_post, float),
                "g_like_sims_t": sims_sd * rng.standard_normal(
                    (nsims_, np.size(g_post)))}

    # mid-march: score stuck at 5.0 over the whole fit, noise floor
    # 1.0/sqrt(100) = 0.1 → z = 50 ≫ 3 and g_last == g_max
    hist = [hist_entry([5.0]) for _ in range(4)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _warn_midmarch_stop(hist, 1e-1, 100)
    assert any("NOT converged" in str(wi.message) for wi in w)

    # converged: score decayed 5.0 → 0.05, below 0.5·max and near floor
    hist = [hist_entry([5.0]), hist_entry([1.0]), hist_entry([0.05])]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _warn_midmarch_stop(hist, 1e-1, 100)
    assert not w

    # θ₀ already at the root: score at the noise floor from iteration 1
    # (g_last ≈ g_max but z ≤ 3) — must NOT warn
    hist = [hist_entry([0.11]), hist_entry([0.09]), hist_entry([0.10])]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _warn_midmarch_stop(hist, 1e-1, 100)
    assert not w


def test_get_j_drops_unconverged_reused_scores():
    """One straggler MAP in the fit's final iteration must not silently
    inflate J through get_J's score reuse (measured at 256² lensing:
    a single unconverged lane → J/H ≈ 38, σ 7× the realization
    scatter).  muse_fit stores a per-sim reliability mask; under
    skip_errors=True get_J excludes flagged scores from J (keeping them
    in result.gs for CRN-exact resume); without it, it warns."""
    import warnings

    from muse_tpu import MuseResult, get_J
    from muse_tpu.models.funnel import funnel_problem
    from muse_tpu.solver.muse import muse_fit

    prob = funnel_problem(64, data_key=jax.random.PRNGKey(5))
    key = jax.random.PRNGKey(3)
    res = MuseResult()
    muse_fit(res, prob, 0.5, nsims=12, maxsteps=4, key=key)
    assert len(res.metadata["gs_converged"]) == 12
    assert res.metadata["gs_converged"].all()

    # poison one stored score and flag its MAP as unconverged
    res.gs[-1] = res.gs[-1] + 1e4
    res.metadata["gs_converged"][-1] = False

    poisoned = MuseResult()
    poisoned.__dict__.update({k: v for k, v in res.__dict__.items()})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_J(poisoned, prob, nsims=12, key=key, warn_reuse=False)
        assert any("may be inflated" in str(wi.message) for wi in w)
    J_poisoned = float(np.asarray(poisoned.J).ravel()[0])

    clean = MuseResult()
    clean.__dict__.update({k: v for k, v in res.__dict__.items()})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_J(clean, prob, nsims=12, key=key, warn_reuse=False,
              skip_errors=True)
        assert any("dropping" in str(wi.message) for wi in w)
    J_clean = float(np.asarray(clean.J).ravel()[0])

    # the poisoned score dominates the naive variance; the guard removes it
    assert J_poisoned > 100 * J_clean, (J_poisoned, J_clean)
    assert len(clean.gs) == 12          # resume record untouched


def test_get_j_extends_convergence_mask_on_resume():
    """Regression (round-5 advisor finding): get_J used to append new
    scores to result.gs WITHOUT extending metadata["gs_converged"], so
    on the next incremental get_J the length check failed and the
    straggler-score guard silently deactivated — in exactly the resume
    flow it was built for.  The mask must stay aligned with result.gs
    across resumes, and a stale mask must warn, not vanish silently."""
    import warnings

    from muse_tpu import MuseResult, get_J
    from muse_tpu.models.funnel import funnel_problem
    from muse_tpu.solver.muse import muse_fit

    prob = funnel_problem(64, data_key=jax.random.PRNGKey(5))
    key = jax.random.PRNGKey(3)
    res = MuseResult()
    muse_fit(res, prob, 0.5, nsims=8, maxsteps=3, key=key)
    assert len(res.metadata["gs_converged"]) == 8

    # incremental get_J adds 4 sims → the mask must grow with result.gs
    get_J(res, prob, nsims=12, key=key, warn_reuse=False)
    assert len(res.gs) == 12
    assert len(res.metadata["gs_converged"]) == 12

    # poison one reused score: the guard must STILL fire on a further
    # resume (pre-fix, the stale 8-long mask was silently discarded)
    res.gs[2] = res.gs[2] + 1e4
    res.metadata["gs_converged"][2] = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_J(res, prob, nsims=16, key=key, warn_reuse=False,
              skip_errors=True)
    assert any("dropping" in str(wi.message) for wi in w), \
        [str(wi.message) for wi in w]
    assert len(res.metadata["gs_converged"]) == 16

    # a mask whose length disagrees with result.gs warns loudly
    res2 = MuseResult()
    res2.__dict__.update({k: v for k, v in res.__dict__.items()})
    res2.metadata = dict(res.metadata)
    res2.metadata["gs_converged"] = res2.metadata["gs_converged"][:5]
    res2.J = None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        get_J(res2, prob, nsims=16, key=key, warn_reuse=False)
    assert any("stale" in str(wi.message) for wi in w), \
        [str(wi.message) for wi in w]
