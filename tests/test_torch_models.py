"""The PyTorch port's FlowNet-S, FlowNet-C and Inception-v3 against the
flax models, through the weight converter, and FlowNet-CS's parameter
count.

Every flax parameter is replaced with RandomState normals first: the
bilinear deconv init is symmetric and would hide a missing kernel flip.
Pyramids agree at atol/rtol 1e-4: float32 convolutions sum in another
order in XLA and in PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.models.common import count_params
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.models.common import bilinear_upsample_kernel
from deepof_tpu_torch.models.registry import build_model

SMALL = {"flownet_s": {}, "flownet_c": {"corr_max_disp": 4, "corr_stride": 1},
         "inception_v3": {}}


def _random_params(params, rs):
    """Normals scaled by 1/sqrt(fan-in) for kernels (keeps activations
    O(1) through 20 layers) and 0.1 for biases."""
    def draw(a):
        shape = a.shape
        scale = 0.1 if len(shape) == 1 else 1.0 / np.sqrt(
            np.prod(shape[:-1]))
        return (rs.randn(*shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_pyramid_matches_flax(name):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 128, 6).astype(np.float32)
    jm = jax_build_model(name, width_mult=0.25, **SMALL[name])
    # the tree's shapes only: every value is drawn below
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))["params"]
    params = _random_params(params, rs)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, jnp.asarray(x))

    model = build_model(name, width_mult=0.25, device="cpu", **SMALL[name])
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    for level, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, level
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} level {level}")


# FlowNet-CS is full width only (no width_mult); its pyramid is compared
# in test_torch_flownet2.py
@pytest.mark.parametrize("name", [*sorted(SMALL), "flownet_cs"])
def test_full_width_param_count_matches_flax(name):
    jm = jax_build_model(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 384, 512, 6)))["params"]
    model = build_model(name, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == count_params(shapes)
    # every flax leaf maps to one torch tensor
    assert len(jax.tree_util.tree_leaves(shapes)) == len(model.state_dict())


def test_init_matches_jax_scheme():
    """Seeded init: zero biases, bilinear identity deconvs, glorot
    bounds on conv weights; the same seed gives the same weights."""
    a = build_model("flownet_s", width_mult=0.25, seed=3, device="cpu")
    b = build_model("flownet_s", width_mult=0.25, seed=3, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.conv1.conv.weight
    o, i, kh, kw = w.shape
    assert w.abs().max() <= np.sqrt(6.0 / (i * kh * kw + o * kh * kw))
    assert torch.count_nonzero(a.conv1.conv.bias) == 0
    up = a.decoder.upconv5.deconv.weight  # (in, out, kh, kw)
    np.testing.assert_array_equal(up[0, 0].detach().numpy(),
                                  bilinear_upsample_kernel(4, 4))
    assert torch.count_nonzero(up[0, 1]) == 0


def test_inception_init_matches_flax_layer_by_layer():
    """F25. The thin Inception-v3's seeded init against the flax init,
    through the converter, tensor by tensor: the biases and the bilinear
    deconvs equal (the scale-1 deconvs' (2, 2) kernel is not symmetric,
    so an unflipped one would compute another function), and every conv
    kernel is glorot-uniform with flax's fans in both draws: its std
    within 5 sigma of the formula's (a uniform's sample std has relative
    sd 0.447/sqrt(n)), its bound reached and not passed, its mean near
    0, and the port's std ratios unbiased over all layers together."""
    jm = jax_build_model("inception_v3", width_mult=0.25)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 64, 64, 6)))["params"]
    want = state_dict_from_flax(jax.device_get(params))
    got = build_model("inception_v3", width_mult=0.25, seed=0,
                      device="cpu").state_dict()
    assert got.keys() == want.keys()
    deconvs = [k for k in got if ".deconv." in k]
    assert len(deconvs) == 20
    zs = []
    for name, g in got.items():
        g, w = g.numpy(), want[name].numpy()
        assert g.shape == w.shape, name
        if g.ndim == 1 or name in deconvs:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        o, i, kh, kw = g.shape
        bound = np.sqrt(6.0 / ((i + o) * kh * kw))
        sd = 0.447 / np.sqrt(g.size)
        for a in (g, w):
            assert abs(a.std() / (bound / np.sqrt(3.0)) - 1) < 5 * sd, name
            assert 0.9 * bound < np.abs(a).max() <= bound, name
            assert abs(a.mean()) < 5 * bound / np.sqrt(3.0 * g.size), name
        zs.append((g.std() / (bound / np.sqrt(3.0)) - 1) / sd)
    assert len(zs) == 100
    assert abs(np.sum(zs) / np.sqrt(len(zs))) < 5


def test_converter_rejects_extra_key_and_wrong_shape():
    rs = np.random.RandomState(0)
    jm = jax_build_model("flownet_s", width_mult=0.25)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 128, 6)))["params"])
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    extra = dict(params, conv9={"Conv_0": {"kernel": rs.randn(3, 3, 8, 8),
                                           "bias": rs.randn(8)}})
    with pytest.raises(ValueError, match="conv9.conv.weight"):
        load_flax_params(model, extra)
    bad = dict(params, conv2={"Conv_0": {
        "kernel": np.zeros((3, 3, 16, 32), np.float32),
        "bias": params["conv2"]["Conv_0"]["bias"]}})
    with pytest.raises(ValueError, match="conv2.conv.weight"):
        load_flax_params(model, bad)
    missing = {k: v for k, v in params.items() if k != "conv3_1"}
    with pytest.raises(ValueError, match="conv3_1"):
        load_flax_params(model, missing)
    with pytest.raises(ValueError, match="Dense_0"):
        state_dict_from_flax({"head": {"Dense_0": {"kernel": np.zeros(2)}}})


def test_converter_flips_transpose_kernels():
    k = np.arange(2 * 2 * 4 * 4, dtype=np.float32).reshape(4, 4, 2, 2)
    sd = state_dict_from_flax({"up": {"ConvTranspose_0": {
        "kernel": k, "bias": np.zeros(2, np.float32)}}})
    w = sd["up.deconv.weight"].numpy()
    assert w.shape == (2, 2, 4, 4)
    np.testing.assert_array_equal(w[1, 0], k[::-1, ::-1, 1, 0])


def test_unported_models_name_their_queue():
    # every model of the JAX registry is ported: the two-stream models
    # build (item 9.4), an unknown name is a KeyError naming them all,
    # and a knob a model does not take still raises
    model = build_model("st_baseline", device="cpu", image_size=(64, 64))
    assert model.has_action_head and len(model.flow_scales) == 6
    with pytest.raises(KeyError, match="ucf101_spatial"):
        build_model("st_triple", device="cpu")
    with pytest.raises(ValueError, match="corr_max_disp"):
        build_model("flownet_s", corr_max_disp=4, device="cpu")
    with pytest.raises(ValueError, match="width_mult"):
        build_model("st_single", width_mult=0.5, device="cpu")
