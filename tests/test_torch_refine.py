"""The PyTorch port's `FlowNetRefine` (the warm start's refinement stage)
against the JAX package's, with the same (converted) flax weights, every
pyramid level: the gated residual stage at width 0.25 with its gate at 0
and away from it, the direct stage (residual=False), a prior on another
grid than the finest head's (every level resized; each coarse level
shrinks, where `jax.image.resize` antialiases: F2), and a FlowNet-CS
tree's `refine` subtree loaded into `FlowNetRefine(residual=False)`.

Tolerances, each with its reason:
  - pyramid levels: atol 1e-4, rtol 1e-4, as for FlowNet-S/C/CS
    (`test_torch_models.py`, `test_torch_flownet2.py`): float32
    convolutions sum in another order; the prior's antialiased resize is
    within ~2e-7 of `jax.image.resize` (F2). Measured on an x86-64 CPU
    (largest difference, largest level entry): gate 0 3.0e-8 (1.2; the
    prior terms alone), gate 0.8 2.3e-6 (2.9), the prior off the head
    grid 1.9e-6 (3.2), the direct stage 2.2e-6 (3.5), the full-width
    FlowNet-CS stage 2.3e-6 (4.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.models.flownet2 import FlowNetRefine as JaxRefine
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.models.flownet2 import FlowNetRefine

HW = (64, 64)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _random_params(shapes, seed=0):
    """Normals scaled by 1/sqrt(fan-in) for kernels and 0.1 for biases
    (the gate, a scalar, gets a normal), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return np.asarray(rng.standard_normal(a.shape, dtype=np.float32)
                          * np.float32(scale))

    return jax.tree_util.tree_map(draw, shapes)


def _inputs(prior_hw, seed=1):
    rs = np.random.RandomState(seed)
    pair = rs.rand(2, *HW, 6).astype(np.float32) - 0.5
    prior = (rs.randn(2, *prior_hw, 2) * 3).astype(np.float32)
    return pair, prior


def _compare(jm, model, params, pair, prior):
    want = jm.apply({"params": params}, jnp.asarray(pair), jnp.asarray(prior))
    with torch.no_grad():
        got = model(_nchw(pair), _nchw(prior))
    assert len(got) == len(want) == 6
    for level, (g, w) in enumerate(zip(got, want)):
        g, w = g.permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape, level
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")
    return got


@pytest.mark.parametrize("residual,gate,prior_hw", [
    (True, 0.0, (32, 32)),    # the warm start's stage, untrained
    (True, 0.8, (32, 32)),    # the residual sum, not only the prior
    (True, 0.8, (48, 40)),    # a prior off the head grid: every level
    (False, None, (32, 32)),  # resized, each coarse one shrinks
])
def test_refine_matches_jax_every_level(residual, gate, prior_hw):
    jm = JaxRefine(width_mult=0.25, residual=residual)
    pair, prior = _inputs(prior_hw)
    params = _random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(pair),
        jnp.asarray(prior))["params"])
    if residual:
        params["gate"] = np.float32(gate)
    model = load_flax_params(
        FlowNetRefine(width_mult=0.25, residual=residual), params).eval()
    assert ("gate" in dict(model.named_parameters())) == residual
    got = _compare(jm, model, params, pair, prior)
    if residual and gate == 0.0:
        # the untrained stage follows its prior: the finest level is the
        # prior / 10 itself (F13: * 10 again need not give its bits)
        np.testing.assert_array_equal(got[0].numpy(),
                                      _nchw(prior).numpy() / np.float32(10))


def test_flownet_cs_refine_subtree_drops_into_the_direct_stage():
    """A FlowNet-CS tree's `refine` subtree, loaded into
    `FlowNetRefine(residual=False)` at full width, gives the JAX stage's
    pyramid for the same (pair, prior): the warm start of a flownet_cs
    engine."""
    cs = jax_build_model("flownet_cs", corr_max_disp=4, corr_stride=1)
    pair, prior = _inputs((32, 32), seed=2)
    shapes = jax.eval_shape(cs.init, jax.random.PRNGKey(0),
                            jnp.asarray(pair))["params"]
    refine = {"refine": _random_params({"refine": shapes["refine"]})[
        "refine"]}
    model = load_flax_params(FlowNetRefine(residual=False), refine).eval()
    _compare(JaxRefine(residual=False), model, refine, pair, prior)


def test_refine_refuses_a_prior_of_another_batch_or_channels():
    model = FlowNetRefine(width_mult=0.25, residual=True)
    pair = torch.zeros(2, 6, 64, 64)
    with pytest.raises(ValueError, match="prior flow"):
        model(pair, torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError, match="prior flow"):
        model(pair, torch.zeros(2, 3, 32, 32))
    with pytest.raises(ValueError, match="2-frame"):
        model(torch.zeros(2, 9, 64, 64), torch.zeros(2, 2, 32, 32))
