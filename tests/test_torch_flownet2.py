"""The PyTorch port's FlowNet-CS against the JAX package's: the stacked
refinement input, the x2 upsample of the base flow, the six-level
pyramid from the same (converted) flax init, and the training objective
and its gradient, which reaches the base stage through the warp.

FlowNet-CS is always full width (77 M parameters): the file draws one
flax parameter tree with numpy and traces one function (pyramid, loss
and gradient together) for all its cases, at 1x64x64 with max_disp 4,
stride 1.

Tolerances, each with its reason:
  - refinement input 1e-5: the warp and the error's square root in
    float32, in another order;
  - upsample 1e-6: jax.image.resize antialiases only when it shrinks,
    so an x2 bilinear resize is PyTorch's align_corners=False bilinear
    (F2) up to rounding;
  - pyramid 1e-4 (atol and rtol), as for FlowNet-S and FlowNet-C
    (test_torch_models.py): float32 convolutions sum in another order;
  - the default loss and its gradient: F6's limits (test_torch_train.py):
    the loss 1e-4 relative, the gradient norm 3e-3 relative, each
    tensor's gradient 2e-2 of its largest entry. The alpha_c = 0.25
    photometric gradient amplifies rounding. Measured on an x86-64
    CPU: 5.3e-7, 2.0e-4 and 7.6e-3 (base.decoder.pr6); the pyramid
    within 1.4e-6 of each level's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.models.flownet2 import refinement_inputs as jax_refinement
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import LossConfig
from deepof_tpu_torch.models import flownet2
from deepof_tpu_torch.models.flownet2 import (FlowNetCS, refinement_inputs,
                                              upsample_flow)
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.step import model_losses

GEOMETRY = {"corr_max_disp": 4, "corr_stride": 1}
HW = (64, 64)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_refinement_inputs_match_jax():
    rs = np.random.RandomState(0)
    img1, img2 = (rs.rand(2, 20, 24, 3).astype(np.float32) for _ in range(2))
    flow = (rs.randn(2, 20, 24, 2) * 3).astype(np.float32)
    want = np.asarray(jax_refinement(jnp.asarray(img1), jnp.asarray(img2),
                                     jnp.asarray(flow), jnp.float32))
    got = refinement_inputs(_nchw(img1), _nchw(img2), _nchw(flow))
    assert got.shape == (2, 12, 20, 24)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(8, 8), (5, 7), (16, 12)])
def test_upsample_matches_jax_image_resize(hw):
    rs = np.random.RandomState(1)
    flow = rs.randn(2, *hw, 2).astype(np.float32)
    out_hw = (2 * hw[0], 2 * hw[1])
    want = np.asarray(jax.image.resize(jnp.asarray(flow),
                                       (2, *out_hw, 2), "bilinear")) * 2.0
    got = upsample_flow(_nchw(flow), out_hw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_two_frame_only():
    with pytest.raises(ValueError, match="2-frame"):
        FlowNetCS(flow_channels=4)
    with pytest.raises(ValueError, match="2-frame"):
        build_model("flownet_cs", flow_channels=4, device="cpu")


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.uniform(0, 255, (1, *HW, 3)).astype(np.float32)
    # the target: the source shifted by a few pixels, plus noise
    tgt = np.roll(src, (2, -3), (1, 2)) + rs.randn(1, *HW, 3).astype(
        np.float32)
    return {"source": src, "target": tgt}


def _random_params(shapes, seed=0):
    """Normals scaled by 1/sqrt(fan-in) for kernels and 0.1 for biases,
    drawn with numpy for the flax tree of `shapes` (cheaper than the
    traced flax init of 77 M parameters, and a missing kernel flip shows,
    which the bilinear deconv init would hide)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return rng.standard_normal(a.shape, dtype=np.float32) * np.float32(
            scale)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(scope="module")
def jax_run():
    """One flax parameter tree of FlowNetCS and one traced function: its
    pyramid on a random pair, and the default loss and its gradient on a
    batch."""
    jm = jax_build_model("flownet_cs", **GEOMETRY)
    rs = np.random.RandomState(2)
    x = rs.randn(1, *HW, 6).astype(np.float32)
    params = _random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    batch = _batch()

    @jax.jit
    def run(p, x, batch):
        def objective(p):
            return jax_model_losses(jm, p, batch, (0.0, 0.0, 0.0),
                                    JaxLossConfig())[0]

        total, grads = jax.value_and_grad(objective)(p)
        return (jm.apply({"params": p}, x), total, optax.global_norm(grads),
                grads)

    flows, total, gnorm, grads = jax.tree_util.tree_map(
        np.asarray, run(params, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in batch.items()}))
    return {"params": params, "x": x,
            "batch": batch, "flows": flows, "total": float(total),
            "grad_norm": float(gnorm), "grads": state_dict_from_flax(grads)}


def _port_model(params):
    model = build_model("flownet_cs", device="cpu", **GEOMETRY)
    load_flax_params(model, params)
    return model


def test_flownet_cs_loads_the_flax_tree_and_matches_its_pyramid(jax_run):
    model = _port_model(jax_run["params"])
    assert {k.split(".")[0] for k in model.state_dict()} == {"base", "refine"}
    assert model.refine.conv1.conv.weight.shape[1] == 12
    with torch.no_grad():
        got = model(_nchw(jax_run["x"]))
    assert len(got) == len(jax_run["flows"]) == 6
    for level, (g, w) in enumerate(zip(got, jax_run["flows"])):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, level
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")


def _port_loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    total, _ = model_losses(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        (0.0, 0.0, 0.0), LossConfig())
    total.backward()
    return total.item(), {k: p.grad for k, p in model.named_parameters()}


def test_flownet_cs_gradient_reaches_base_through_the_warp(jax_run,
                                                           monkeypatch):
    model = _port_model(jax_run["params"])
    total, grads = _port_loss_and_grads(model, jax_run["batch"])
    np.testing.assert_allclose(total, jax_run["total"], rtol=1e-4)
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    np.testing.assert_allclose(norm, jax_run["grad_norm"], rtol=3e-3)
    for name, w in jax_run["grads"].items():
        scale = float(w.abs().max())
        torch.testing.assert_close(grads[name], w, atol=2e-2 * scale, rtol=0,
                                   msg=name)
    base = [k for k in grads if k.startswith("base.")]
    assert base and all(float(grads[k].abs().max()) > 0 for k in base
                        if k.endswith("weight"))
    # the warp's flow gradient is part of what reaches the base: without
    # it (the flow detached at the warp), every base weight's gradient
    # moves by more than the tolerance above (by 0.41 of its largest
    # entry or more, measured)
    warp = flownet2.backward_warp_nchw
    monkeypatch.setattr(flownet2, "backward_warp_nchw",
                        lambda image, flow: warp(image, flow.detach()))
    _, cut = _port_loss_and_grads(model, jax_run["batch"])
    gaps = [float((cut[k] - grads[k]).abs().max()
                  / jax_run["grads"][k].abs().max()) for k in base
            if k.endswith("weight")]
    assert min(gaps) > 2e-2, gaps
