"""The PyTorch port's models in bf16 compute (`dtype=torch.bfloat16`, what
`train.compute_dtype="bfloat16"` builds) against the flax models with
`dtype=jnp.bfloat16`, from the same float32 parameters carried over by
`convert.py`; and the settings that select bf16.

Each model gets a bf16 input pair (the train step casts it so) and the
JAX side runs under `jax.jit` on the CPU, where its cost volume is the
XLA sweep. Forward hooks check that every conv and deconv block
(`ConvELU`, `Deconv`) returns bf16 and the cost volume is bf16, and every
parameter stays float32. Neither these checks nor the tolerance below
(JAX's own bf16 vs float32 gap is of its size) fail blocks that compute
in float32 and round only their output; the zero-bias block test of
test_torch_bf16_ops.py does.

Tolerance: each pyramid level within 3e-2 of its largest entry. Each
conv rounds its result to bf16 (flax rounds once more where it adds the
bias, test_torch_bf16_ops.py), the XLA sweep rounds each product (H2),
and the differences add up through ~25 layers. Measured on an x86-64
CPU, port vs JAX bf16 (JAX's own bf16 vs float32 gap beside it): FlowNet-S
(width 0.125, 2 x 64 x 96) at most 8.7e-3 (9.2e-3); FlowNet-C (width
0.125, 4 / 1, 2 x 64 x 96) 9.3e-3 (8.7e-3); FlowNet-CS (full width, 4 /
1, 1 x 64 x 64) 1.2e-2 (1.8e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import (ExperimentConfig, LossConfig,
                                          TrainConfig, check_trainable)
from deepof_tpu_torch.models import flownet_c
from deepof_tpu_torch.models.common import ConvELU, Deconv
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.serve.engine import build_serve_model

PYRAMID_TOL = 3e-2
# model -> (model keyword arguments, (B, H, W))
CASES = {
    "flownet_s": ({"width_mult": 0.125}, (2, 64, 96)),
    "flownet_c": ({"width_mult": 0.125, "corr_max_disp": 4,
                   "corr_stride": 1}, (2, 64, 96)),
    "flownet_cs": ({"corr_max_disp": 4, "corr_stride": 1}, (1, 64, 64)),
    "inception_v3": ({"width_mult": 0.125}, (2, 64, 96)),
}
#: the models with a cost volume
CORR_MODELS = ("flownet_c", "flownet_cs")


def _random_params(shapes, seed=0):
    """Normals scaled by 1/sqrt(fan-in) for kernels and 0.1 for biases,
    drawn with numpy for the flax tree of `shapes`."""
    rng = np.random.default_rng(seed)

    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return rng.standard_normal(a.shape, dtype=np.float32) * np.float32(
            scale)

    return jax.tree_util.tree_map(draw, shapes)


def _record_dtypes(model, monkeypatch):
    """Forward hooks on every ConvELU and Deconv and a wrapper of the
    model's cost volume; returns the list of (what, dtype) they fill."""
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, (ConvELU, Deconv)):
            m.register_forward_hook(
                lambda m, args, out, name=name: seen.append((name,
                                                             out.dtype)))
    corr = flownet_c.correlation_nchw

    def recorded(*args):
        out = corr(*args)
        seen.append(("cost volume", out.dtype))
        return out

    monkeypatch.setattr(flownet_c, "correlation_nchw", recorded)
    return seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_pyramid_matches_jax(name, monkeypatch):
    kw, (b, h, w) = CASES[name]
    x = jnp.asarray(np.random.RandomState(1).randn(b, h, w, 6)
                    .astype(np.float32), jnp.bfloat16)
    jm = jax_build_model(name, dtype=jnp.bfloat16, **kw)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           x)["params"])
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x)

    model = build_model(name, device="cpu", dtype=torch.bfloat16, **kw)
    load_flax_params(model, params)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = _record_dtypes(model, monkeypatch)
    pair = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got = model(pair.permute(0, 3, 1, 2).contiguous())

    blocks = sum(isinstance(m, (ConvELU, Deconv)) for m in model.modules())
    assert len(seen) >= blocks
    assert {dt for _, dt in seen} == {torch.bfloat16}, seen
    assert (("cost volume", torch.bfloat16) in seen) == (name in CORR_MODELS)
    assert len(got) == len(want) == 6
    for level, (g, wl) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and wl.dtype == jnp.bfloat16
        g = g.float().permute(0, 2, 3, 1).numpy()
        wl = np.asarray(wl.astype(jnp.float32))
        assert g.shape == wl.shape, level
        np.testing.assert_allclose(g, wl, rtol=0,
                                   atol=PYRAMID_TOL * np.abs(wl).max(),
                                   err_msg=f"{name} level {level}")


@pytest.mark.parametrize("model", sorted(CASES))
def test_bf16_compute_is_trainable(model):
    check_trainable(ExperimentConfig(
        model=model, train=TrainConfig(compute_dtype="bfloat16")))


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        check_trainable(ExperimentConfig(
            train=TrainConfig(compute_dtype="float16")))


def test_bf16_gather_still_raises_naming_the_next_slice():
    # a loss option, queued with the loss variants (ROADMAP Queue A
    # item 9, F11): the warp kernels take float32 only
    with pytest.raises(NotImplementedError,
                       match=r"gather_dtype='bfloat16'.*9 \(loss variants\)"):
        check_trainable(ExperimentConfig(
            loss=LossConfig(gather_dtype="bfloat16")))


def test_serving_builds_a_float32_model_whatever_compute_dtype_says():
    """`build_serve_model` builds the model without a dtype, as the JAX
    package's does (`serve/engine.py:175-185`): serving computes in
    float32 even for a bf16-trained config."""
    cfg = ExperimentConfig(model="flownet_c", width_mult=0.125,
                           corr_max_disp=4, corr_stride=1)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    model = build_serve_model(cfg, device="cpu")
    dtypes = {m.dtype for m in model.modules()
              if isinstance(m, (ConvELU, Deconv))}
    assert model.dtype == torch.float32 and dtypes == {torch.float32}
    with torch.no_grad():
        flows = model(torch.zeros(1, 6, 64, 64))
    assert {f.dtype for f in flows} == {torch.float32}
