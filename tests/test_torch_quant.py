"""The PyTorch port's precision tiers (`serve/quant.py`) against the JAX
package's (`deepof_tpu/serve/quant.py`): the tier vocabulary, the int8
quantization of every conv and deconv weight, bit for bit after the
layout change (F12: the output channel is dim 0 of a torch conv weight,
dim 1 of a deconv weight, and last in flax), the weight bytes, and each
tier's forward against the JAX tier's on the same rows.

FlowNet-C at width 0.25, max_disp 4, stride 1, a 64x128 bucket, from a
numpy-drawn flax tree carried across with `convert.load_flax_params`.

Tolerances, each with its reason:
  - q, scale: none (bitwise). The same float32 amax, division and
    round-half-to-even on the same values, in another layout.
  - the round trip: at most 0.5 of a channel's scale plus 1e-4 (the
    JAX package's contract, `tests/test_quant.py`), and within 1e-6 of
    the JAX tier's figure; measured 0.5000016 (float32 rounding of
    w / scale), the same as JAX's.
  - the tiers' forwards: atol 1e-4, rtol 1e-4, the float32 serving
    tolerance of `tests/test_torch_serve.py` (float32 convolutions sum in
    another order in XLA and in PyTorch; each tier computes in float32
    from its rounded or dequantized weights). Measured on an x86-64 CPU:
    within 2e-6 of flows up to ~6 in every tier.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.serve import quant as jq
from deepof_tpu.serve.engine import make_raw_forward as jax_raw_forward
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import ExperimentConfig, ServeConfig
from deepof_tpu_torch.models.common import ConvELU, Deconv
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.serve.engine import make_raw_forward
from deepof_tpu_torch.serve.quant import (PRECISIONS, Int8Layer,
                                          int8_roundtrip_max_error,
                                          params_nbytes, quantize_model,
                                          resolve_precisions)

BUCKET = (64, 128)
GEOMETRY = {"width_mult": 0.25, "corr_max_disp": 4, "corr_stride": 1}


def _flax_tree(rs, tree):
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if a.ndim == 1 else
                   1.0 / np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def flownet_c():
    """(JAX model, flax params, torch model with those weights)."""
    jm = jax_build_model("flownet_c", **GEOMETRY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *BUCKET, 6))))["params"]
    params = _flax_tree(np.random.RandomState(0), shapes)
    model = build_model("flownet_c", device="cpu", **GEOMETRY)
    return jm, params, load_flax_params(model, params).eval()


def _cfgs(precisions):
    return (JaxConfig().replace(serve=dataclasses.replace(
        JaxConfig().serve, precisions=precisions)),
        ExperimentConfig(serve=ServeConfig(precisions=precisions)))


@pytest.mark.parametrize("precisions", [("f32",), ("int8", "f32"),
                                        ("bf16", "int8", "f32"), ()])
def test_resolve_precisions_keeps_the_order_as_jax(precisions):
    jcfg, cfg = _cfgs(precisions)
    assert resolve_precisions(cfg) == jq.resolve_precisions(jcfg)
    assert PRECISIONS == jq.PRECISIONS


@pytest.mark.parametrize("precisions,match", [(("f32", "fp4"), "fp4"),
                                              (("f32", "f32"), "twice")])
def test_resolve_precisions_refuses_as_jax(precisions, match):
    jcfg, cfg = _cfgs(precisions)
    with pytest.raises(ValueError, match=match):
        jq.resolve_precisions(jcfg)
    with pytest.raises(ValueError, match=match):
        resolve_precisions(cfg)


def _int8_layers(model):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Int8Layer)}


def _jax_int8_in_torch_layout(params):
    """JAX int8 tier of `params` -> ({torch layer name: q as float32 in
    the torch layout}, {torch layer name: scale})."""
    q_tree = jq.quantize_params(params, "int8")

    def split(node, pick):
        if jq._is_quantized_leaf(node):
            return np.asarray(node[pick], np.float32)
        if isinstance(node, dict):
            return {k: split(v, pick) for k, v in node.items()}
        return np.asarray(node, np.float32)

    qs = state_dict_from_flax(split(q_tree, "q"))
    scales = {}

    def walk(node, path):
        for k, v in node.items():
            if jq._is_quantized_leaf(v):
                layer = {"Conv_0": "conv", "ConvTranspose_0": "deconv"}[
                    path[-1]]
                scales[".".join([*path[:-1], layer])] = np.asarray(
                    v["scale"])
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(q_tree, [])
    return ({k[:-len(".weight")]: v for k, v in qs.items()
             if k.endswith(".weight")}, scales)


def _assert_int8_equals_jax(model, params):
    got = _int8_layers(quantize_model(model, "int8"))
    want_q, want_scale = _jax_int8_in_torch_layout(params)
    assert sorted(got) == sorted(want_q) == sorted(want_scale)
    for name, layer in got.items():
        assert layer.q.dtype == torch.int8
        assert np.array_equal(layer.scale.numpy(), want_scale[name]), name
        assert np.array_equal(layer.q.numpy().astype(np.float32),
                              want_q[name]), name


def test_int8_q_and_scale_are_jax_bits_for_flownet_c(flownet_c):
    _, params, model = flownet_c
    _assert_int8_equals_jax(model, params)


class _ConvDeconv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = ConvELU(3, 6)
        self.b = Deconv(6, 4)

    def forward(self, x):
        return self.b(self.a(x))


def test_int8_per_output_channel_on_a_deconv_with_ranges_1e3_apart():
    """A conv and a deconv whose output channels differ in range by 1e3,
    each with an all-zero output channel (scale 1.0, q 0): per-input-
    channel scales would differ from the JAX tier's here."""
    rs = np.random.RandomState(1)
    ranges_conv = np.array([1e-3, 1e-2, 1.0, 0.0, 0.5, 1.0], np.float32)
    ranges_deconv = np.array([1.0, 1e-3, 0.0, 0.3], np.float32)
    params = {
        "a": {"Conv_0": {
            "kernel": (rs.randn(3, 3, 3, 6) * ranges_conv).astype(np.float32),
            "bias": rs.randn(6).astype(np.float32)}},
        "b": {"ConvTranspose_0": {
            "kernel": (rs.randn(4, 4, 6, 4)
                       * ranges_deconv).astype(np.float32),
            "bias": rs.randn(4).astype(np.float32)}}}
    model = load_flax_params(_ConvDeconv(), params)
    _assert_int8_equals_jax(model, params)
    layers = _int8_layers(quantize_model(model, "int8"))
    assert layers["b.deconv"].scale[2].item() == 1.0
    assert not layers["b.deconv"].q[:, 2].any()
    assert layers["a.conv"].scale[3].item() == 1.0
    # the deconv's scales are per output channel: dim 1 of (I, O, kh, kw)
    assert layers["b.deconv"].scale.shape == (4,)


def test_int8_roundtrip_error_and_no_float_weight(flownet_c):
    _, params, model = flownet_c
    err = int8_roundtrip_max_error(model)
    assert err <= 0.5 + 1e-4
    assert err == pytest.approx(jq.int8_roundtrip_max_error(params),
                                abs=1e-6)
    tier = quantize_model(model, "int8")
    # the tier holds the int8 weight and no float32 copy of it
    floats = [n for n, p in (*tier.named_parameters(), *tier.named_buffers())
              if p.is_floating_point() and p.dim() > 1]
    assert floats == []
    # the served model is left as it was
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("tier", PRECISIONS)
def test_params_nbytes_equals_jax(flownet_c, tier):
    _, params, model = flownet_c
    assert params_nbytes(quantize_model(model, tier)) == jq.params_nbytes(
        jq.quantize_params(params, tier))


@pytest.mark.parametrize("tier", PRECISIONS)
def test_tier_forward_matches_jax_tier(flownet_c, tier):
    jm, params, model = flownet_c
    rs = np.random.RandomState(2)
    x = rs.rand(2, *BUCKET, 6).astype(np.float32) - 0.5
    want = np.asarray(jax.jit(jax_raw_forward(jm))(
        jq.quantize_params(params, tier), jnp.asarray(x)))
    tier_model = quantize_model(model, tier)
    got = make_raw_forward(tier_model)(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    if tier == "bf16":
        assert all(p.dtype == torch.bfloat16
                   for p in tier_model.parameters())
    # a second call gives the same bits
    assert np.array_equal(make_raw_forward(tier_model)(x), got)
