"""muse_tpu — an accelerator MUSE (Marginal Unbiased Score Expansion) engine.

A from-scratch JAX/XLA re-design of the capabilities of
``marius311/MuseInference.jl`` (Millea & Seljak 2021, arXiv:2112.09354;
implicit-diff extension arXiv:2209.10512): approximate hierarchical
Bayesian inference P(x,z|θ)·P(θ) estimating hyper-parameters θ while
marginalizing a high-dimensional latent z, using only forward simulation
and joint log-likelihood gradients.

Architecture (vs the reference's Julia AD + Optim + Distributed stack):
  * per-sim latent MAP solves  → one batched ``lax.while_loop`` L-BFGS
    advancing all sims in lockstep (``muse_tpu.ops.lbfgs``);
  * AD backends (ForwardDiff/Zygote) → ``jax.grad`` / ``jax.jvp``;
  * Distributed worker pools → a device mesh sharding the sims axis
    (``muse_tpu.parallel``), cross-device reductions as XLA collectives;
  * Turing/Soss PPL adapters → a JAX effect-handler PPL adapter
    (``muse_tpu.adapters.ppl``) (+ numpyro adapter when available);
  * FFT Gaussian-random-field models whose likelihoods XLA fuses
    (``muse_tpu.models.grf``).

Public API parity with the reference exports (src/MuseInference.jl:30):
  SimpleMuseProblem, MuseResult, muse, muse_fit (muse!), get_J (get_J!),
  get_H (get_H!); plus MuseProblem, PPLMuseProblem, check_self_consistency.
"""

from .adapters.simple import SimpleMuseProblem
from .problem import MuseProblem, check_self_consistency
from .result import MuseResult, load_result
from .solver.jacobians import get_H, get_J
from .solver.muse import muse, muse_fit
from .theta import ThetaSpec
from . import distributions, ppl, transforms
from .ppl import PPLMuseProblem, model_problem

__all__ = [
    "MuseProblem", "SimpleMuseProblem", "PPLMuseProblem", "model_problem",
    "MuseResult", "load_result", "muse", "muse_fit", "get_J", "get_H",
    "check_self_consistency", "ThetaSpec", "distributions", "ppl",
    "transforms",
]

__version__ = "0.3.0"
