"""The port's UCF-101 action models (`models/two_stream.py`) against the
JAX package's flax modules, through the weight converter.

  - each model's output at train=False (ucf101_spatial's logits, the
    two-stream models' flows and logits) at an input size that is a
    multiple of 64 and at an odd one (70 x 100: flax's SAME 2x2 max-pool
    pads the high side with -inf at the odd levels, and STBaseline's
    fusion pools and concatenates pool5 with Tconv5_2 at 3 x 4), from
    random flax parameters (normals over sqrt(fan-in), biases 0.1), the
    JAX side under `jax.jit` on the CPU, at atol/rtol 1e-4 as the VGG
    tests (float32 convolutions sum in another order in XLA and in
    PyTorch). The models have fixed widths (a 4096-wide head): only the
    image size is small;
  - F20: fc6 reads pool5 flattened in flax's (h, w, c) order, shown at a
    pool5 of 2 x 3, where the NCHW order gives other logits;
  - dropout's apply, bit for bit flax's `nn.Dropout` on the mask read off
    its output (nonzero input), and the masks' draw: keep 0.9, a pure
    function of (seed, step);
  - F21: the init's statistics against flax's initializers (jax's
    truncated normal 0.01 with no correction: std 0.8796 x 0.01, values
    within +-0.02; glorot for the ELU head);
  - `load_vgg16_npz` into the three trunk paths (st_single's `encoder`,
    6 channels, conv1_1 tiled; ucf101_spatial's `encoder` and
    st_baseline's `spatial`, 3 channels, bare convs) against the JAX
    loader on a random npz with the public file's names and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from deepof_tpu.models.common import load_vgg16_npz as jax_load_vgg16_npz
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.models.two_stream import _FCHead
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.models.common import load_vgg16_npz
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.models.two_stream import (FC_WIDTH, KEEP_PROB, FCHead,
                                                STBaseline, STSingle,
                                                UCF101Spatial, apply_dropout,
                                                dropout_masks)
from deepof_tpu_torch.models.vgg16_flow import VGG_CONVS

MODELS = ("ucf101_spatial", "st_single", "st_baseline")


def _channels(name):
    return 3 if name == "ucf101_spatial" else 6


def _random_params(shapes, rng):
    """float32 normals from `rng` (a numpy Generator) over sqrt(fan-in)
    for kernels, of 0.1 for biases."""
    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return rng.standard_normal(a.shape, np.float32) * np.float32(scale)

    return jax.tree_util.tree_map(draw, shapes)


def _flax(name, hw, seed):
    jm = jax_build_model(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, _channels(name))))["params"]
    return jm, _random_params(shapes, np.random.default_rng(seed))


@pytest.mark.parametrize("hw", [(64, 96), (70, 100)])
@pytest.mark.parametrize("name", MODELS)
def test_outputs_match_flax(name, hw):
    x = np.random.RandomState(1).randn(2, *hw, _channels(name)).astype(
        np.float32)
    jm, params = _flax(name, hw, hw[1])
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, jnp.asarray(x))
    model = build_model(name, device="cpu", image_size=hw)
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    if name == "ucf101_spatial":  # logits only
        got, want = ([], got), ([], want)
    else:
        assert len(got[0]) == len(want[0]) == len(model.flow_scales)
    flows, logits = got
    assert logits.shape == (2, 101)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want[1]),
                               atol=1e-4, rtol=1e-4, err_msg="logits")
    for level, (g, w) in enumerate(zip(flows, want[0])):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (2, -(-hw[0] // 2 ** (level + 1)),
                                      -(-hw[1] // 2 ** (level + 1)), 2)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} level {level}")


def test_fc6_reads_pool5_in_flax_order():
    """F20 at a pool5 of 2 x 3: the port's head equals flax's; the same
    weights on pool5 flattened channel-major do not."""
    rs = np.random.RandomState(2)
    pool5 = rs.randn(2, 2, 3, 512).astype(np.float32)  # NHWC
    head = _FCHead(101, act="elu")
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0),
                            jnp.asarray(pool5))["params"]
    params = _random_params(shapes, np.random.default_rng(2))
    want = np.asarray(head.apply({"params": params}, jnp.asarray(pool5)))
    port = FCHead(2 * 3 * 512, act="elu")
    port.load_state_dict(state_dict_from_flax(params))
    nchw = torch.from_numpy(pool5).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(nchw).numpy()
        wrong = port.fc8(port.act(port.fc7(port.act(port.fc6(
            nchw.reshape(2, -1)))))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(wrong - want).max() > 100 * np.abs(got - want).max()


def test_dropout_apply_is_flax_bit_for_bit():
    rs = np.random.RandomState(3)
    x = (rs.rand(8, FC_WIDTH).astype(np.float32) + 0.5) * np.where(
        rs.rand(8, FC_WIDTH) < 0.5, -1, 1).astype(np.float32)
    drop = fnn.Dropout(1.0 - KEEP_PROB, deterministic=False)
    want = np.asarray(drop.apply({}, jnp.asarray(x),
                                 rngs={"dropout": jax.random.PRNGKey(4)}))
    keep = want != 0  # nonzero input: a zero is a dropped unit
    assert 0.85 < keep.mean() < 0.95
    got = apply_dropout(torch.from_numpy(x), torch.from_numpy(keep))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_dropout_masks_are_a_function_of_seed_and_step():
    a = dropout_masks(4, seed=0, step=7)
    b = dropout_masks(4, seed=0, step=7, generator=torch.Generator())
    c = dropout_masks(4, seed=0, step=8)
    d = dropout_masks(4, seed=1, step=7)
    assert [m.shape for m in a] == [(4, FC_WIDTH)] * 2
    assert all(m.dtype == torch.bool for m in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    keep = torch.stack([*a, *c, *d]).float().mean().item()
    assert abs(keep - KEEP_PROB) < 0.01


def test_init_statistics_match_flax():
    """F21. The port's draws are torch's; their distribution is flax's:
    the ReLU head and the bare convs truncated normal 0.01 (jax's, no
    correction), the ELU head glorot-uniform, biases zero."""
    key = jax.random.PRNGKey(5)
    spatial = build_model("ucf101_spatial", device="cpu",
                          image_size=(32, 32), seed=5)
    single = build_model("st_single", device="cpu", image_size=(32, 32),
                         seed=5)
    trunc = np.asarray(fnn.initializers.truncated_normal(0.01)(
        key, (FC_WIDTH, FC_WIDTH)))
    glorot = np.asarray(fnn.initializers.glorot_uniform()(
        key, (FC_WIDTH, FC_WIDTH)))
    for w, want in ((spatial.head.fc7.weight, trunc),
                    (spatial.encoder.conv5_1.weight, trunc),
                    (single.head.fc7.weight, glorot)):
        w = w.detach().numpy()
        np.testing.assert_allclose(w.std(), want.std(), rtol=2e-2)
        np.testing.assert_allclose(np.abs(w).max(), np.abs(want).max(),
                                   rtol=2e-2)
        assert abs(w.mean()) < 0.05 * want.std()
    assert np.abs(spatial.head.fc6.weight.detach().numpy()).max() <= 0.02
    np.testing.assert_allclose(trunc.std(), 0.01 * 0.87962566, rtol=1e-2)
    for m in (spatial, single):
        for n, p in m.named_parameters():
            if n.endswith("bias"):
                assert not p.detach().any(), n


def test_fc6_width_follows_the_input_size():
    with torch.device("meta"):
        assert STSingle().head.fc6.in_features == 10 * 12 * 512
        assert STBaseline(image_size=(70, 100)).head.fc6.in_features == \
            2 * 2 * 512
        assert UCF101Spatial(image_size=(70, 100)).head.fc6.in_features == \
            3 * 4 * 512
    assert STSingle.has_action_head and STBaseline.has_action_head
    assert UCF101Spatial.classifier_only
    assert STSingle.flow_scales == (10.0, 5.0, 2.5, 1.25, 0.625)
    assert len(STBaseline.flow_scales) == 6
    assert (STSingle.max_downsample, STBaseline.max_downsample,
            UCF101Spatial.max_downsample) == (32, 64, 32)


def write_npz(path, rs):
    """The public `vgg16_weights.npz`'s conv names and shapes (fc layers
    as small stand-ins: both loaders skip them)."""
    arrays, cin = {}, 3
    for name in VGG_CONVS:
        cout = {"1": 64, "2": 128, "3": 256, "4": 512, "5": 512}[name[4]]
        arrays[f"{name}_W"] = (rs.randn(3, 3, cin, cout) * 0.05).astype(
            np.float32)
        arrays[f"{name}_b"] = rs.randn(cout).astype(np.float32)
        cin = cout
    for k in ("fc6", "fc7", "fc8"):
        arrays[f"{k}_W"] = np.zeros((4, 3), np.float32)
        arrays[f"{k}_b"] = np.zeros(3, np.float32)
    np.savez(path, **arrays)
    return arrays


@pytest.mark.parametrize("name,trunk", [("st_single", "encoder"),
                                        ("ucf101_spatial", "encoder"),
                                        ("st_baseline", "spatial")])
def test_load_vgg16_npz_into_each_trunk_matches_jax(tmp_path, name, trunk):
    path = str(tmp_path / "vgg16_weights.npz")
    arrays = write_npz(path, np.random.RandomState(6))
    _, params = _flax(name, (32, 32), 7)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_load_vgg16_npz(params, path, trunk_path=(trunk,))))
    model = build_model(name, device="cpu", image_size=(32, 32))
    load_flax_params(model, params)
    assert load_vgg16_npz(model, path, trunk_path=(trunk,)) is model
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    conv = "conv.weight" if name == "st_single" else "weight"
    w11 = got[f"{trunk}.conv1_1.{conv}"]
    w = torch.from_numpy(arrays["conv1_1_W"].transpose(3, 2, 0, 1))
    assert torch.equal(w11, torch.cat([w, w], 1) if name == "st_single"
                       else w)
    assert torch.equal(got["head.fc6.weight"],
                       torch.from_numpy(np.asarray(
                           params["head"]["fc6"]["kernel"]).T))
