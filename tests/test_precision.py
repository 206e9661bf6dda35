"""Matrix products that must run in full f32 on any backend.

On a GPU the default matmul precision may be TF32 (about three
significant digits).  Each product below asks for HIGHEST explicitly;
the tests read the ``precision`` of the ``dot_general`` in the jaxpr.
"""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from muse_tpu.distributions import MvNormal
from muse_tpu.models import funnel_problem
from muse_tpu.ops.dft import plan_dft2
from muse_tpu.solver.compiled import CompiledProblem
from muse_tpu.theta import ThetaSpec


def _dot_generals(jaxpr):
    """Every dot_general equation in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    out += _dot_generals(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    out += _dot_generals(sub)
    return out


def _highest(eqn):
    p = eqn.params["precision"]
    return p is not None and all(
        q == jax.lax.Precision.HIGHEST for q in (p if isinstance(p, tuple)
                                                 else (p,)))


def _implicit_h_dots():
    """dot_generals of get_H's implicit-diff program that contract over
    the latent dimension (the H2 = −dFdθᵀ A⁻¹ dFdθ1 product and CG's
    inner products)."""
    prob = funnel_problem(16, data_key=jax.random.PRNGKey(0))
    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    fn = comp.h_implicit_with()
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    th = jnp.zeros(1)
    jaxpr = jax.make_jaxpr(lambda k, t: fn(
        k, t, jnp.float32(1e-3), cg_maxiter=5, cg_tol=1e-6,
        h1_is_zero=False))(keys, th)
    dots = []
    for e in _dot_generals(jaxpr.jaxpr):
        (lc, rc), _ = e.params["dimension_numbers"]
        if any(e.invars[0].aval.shape[d] == comp.nz for d in lc):
            dots.append(e)
    return dots


def _dft_dots():
    plan = plan_dft2(8)
    jaxpr = jax.make_jaxpr(lambda u: plan.irfft2(plan.rfft2(u)))(
        jnp.zeros((2, 8, 8)))
    return _dot_generals(jaxpr.jaxpr)


def _mvnormal_dots():
    d = MvNormal(jnp.zeros(3), jnp.eye(3) * 2.0)
    jaxpr = jax.make_jaxpr(lambda k: d.sample(k, (4, 3)))(
        jax.random.PRNGKey(0))
    return [e for e in _dot_generals(jaxpr.jaxpr)
            if e.invars[0].aval.shape[-1] == 3]


@pytest.mark.parametrize("dots", [_implicit_h_dots, _dft_dots,
                                  _mvnormal_dots],
                         ids=["get_H_implicit", "dft", "mvnormal_sample"])
def test_products_pin_highest_precision(dots):
    eqns = dots()
    assert eqns, "no dot_general found"
    assert all(_highest(e) for e in eqns), [
        (e.params["precision"], [v.aval.shape for v in e.invars])
        for e in eqns]
