"""Executable documentation — the docs cannot rot.

The reference builds its Documenter site by RUNNING the index.md
MUSE-vs-NUTS example at doc-build time (/root/reference/docs/make.jl:15-30,
docs/src/index.md:80-104), so a quick-start that stops reproducing its
quoted output fails the build.  The analog here: pytest extracts the
```python fences from README.md / docs/index.md, executes them verbatim,
and pins the computed result against the θ̂±σ quoted IN the markdown —
so both code rot (block stops running / produces a different number) and
doc rot (someone edits the quoted number away from reality) fail CI.
The runnable examples are exercised end-to-end at small sizes.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python_fences(md_path):
    text = open(md_path, encoding="utf-8").read()
    return re.findall(r"```python\n(.*?)```", text, re.S)


def _quoted_result(code):
    """Parse the quoted ``MuseResult(theta=0.199±0.13)`` from a fence."""
    m = re.search(r"MuseResult\(theta=([\d.+-]+)±([\d.]+)\)", code)
    assert m, "quick-start fence no longer quotes its expected MuseResult"
    return float(m.group(1)), float(m.group(2))


def _exec_fences(fences, ns=None):
    ns = {} if ns is None else ns
    for code in fences:
        exec(compile(code, "<doc-fence>", "exec"), ns)
    return ns


def test_readme_quickstart_reproduces_quoted_result():
    fences = _python_fences(os.path.join(REPO, "README.md"))
    assert fences, "README.md lost its quick-start fence"
    th_doc, sig_doc = _quoted_result(fences[0])
    ns = _exec_fences(fences[:1])
    res = ns["result"]
    th, sig = float(res.theta[0]), float(res.sigma[0])
    # the quoted numbers are rounded to 3/2 decimals; anything further
    # off than a rounding step means the docs and the code diverged
    assert abs(th - th_doc) < 5e-3, (th, th_doc)
    assert abs(sig - sig_doc) < 5e-3, (sig, sig_doc)


def test_docs_index_quickstart_and_ppl_twin():
    """docs/index.md block 1 (SimpleMuseProblem) must reproduce its quoted
    number; block 2 (the PPL formulation of the SAME model, sharing
    x_obs) must land on the same posterior."""
    fences = _python_fences(os.path.join(REPO, "docs", "index.md"))
    assert len(fences) >= 2, "docs/index.md lost its quick-start fences"
    th_doc, sig_doc = _quoted_result(fences[0])
    ns = _exec_fences(fences[:1])
    res_qs = ns["result"]
    th = float(res_qs.theta[0])
    assert abs(th - th_doc) < 5e-3, (th, th_doc)
    assert abs(float(res_qs.sigma[0]) - sig_doc) < 5e-3

    ns = _exec_fences(fences[1:2], ns)          # PPL twin, reuses x_obs
    res_ppl = ns["result"]
    th_ppl = float(np.asarray(res_ppl.theta).ravel()[0])
    # same data, same model, independent machinery (PPL tracing + its own
    # sim keys): agreement within a combined posterior width
    assert abs(th_ppl - th) < 2.5 * sig_doc, (th_ppl, th)


@pytest.mark.parametrize("cmd,pattern,bound", [
    (["examples/muse_vs_hmc.py", "--dim", "64", "--nsims", "16",
      "--hmc-samples", "300"],
     r"MUSE − exact = ([+-][\d.]+)", 0.5),
    (["examples/lensing_demo.py", "--n", "16", "--nsims", "8"],
     r"z-score ([+-][\d.]+)", 3.5),
    (["examples/northstar_grf.py", "--n", "64", "--nsims", "16",
      "--max-batch", "16"],
     r"θ̂ − θ̂_MLE\(exact\)  = ([+-][\d.e-]+)", 2e-2),
])
def test_example_runs_quick(cmd, pattern, bound):
    """Each shipped example must run end-to-end at a small size and print
    an accuracy line inside loose-but-real bounds (z-score / MLE gap /
    MUSE-vs-HMC agreement)."""
    # PYTHONPATH=REPO only: the examples need nothing else on the path.
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, cmd[0], *cmd[1:]], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    m = re.search(pattern, out.stdout)
    assert m, (pattern, out.stdout[-2000:])
    assert abs(float(m.group(1))) < bound, out.stdout[-1500:]
