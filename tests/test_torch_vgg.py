"""The port's VGG16 flow model (`models/vgg16_flow.py`) and its trunk
loader (`models/common.py::load_vgg16_npz`) against the JAX package's.

The model: the pyramid at an input size that is a multiple of 32 and at
an odd one (70 x 100: flax's SAME 2x2 max-pool pads the high side with
-inf at every odd level, and the stride-2 deconvs overshoot and are
cropped), and the parameter gradients of a linear function of the
pyramid, through the weight converter from random flax parameters
(normals over sqrt(fan-in), biases 0.1), the JAX side under `jax.jit` on
the CPU. VGG16 has no width knob, so its convs are full width at a small
spatial size. Pyramid and gradients agree at atol/rtol 1e-4 of each
tensor's largest entry, as in test_torch_inception.py: float32
convolutions sum in another order in XLA and in PyTorch.

The loader: one npz with the public `vgg16_weights.npz`'s conv names and
shapes (HWIO `_W`, `_b`; the fc layers at small stand-in shapes, since
both loaders skip them) read by both packages: the trunks equal after
conversion, conv1_1 tiled twice along its input channels, a mismatch
raising and naming the layer; the Trainer applies it on a fresh start
only. Last, the `flyingchairs_vgg` preset from the command line (train,
eval, predict) and the `bench` step on VGG16, small, on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.models.common import load_vgg16_npz as jax_load_vgg16_npz
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          TrainConfig)
from deepof_tpu_torch.models.common import load_vgg16_npz
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.models.vgg16_flow import VGG_CONVS, VGG16Flow

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

VGG_WIDTHS = {"conv1": (3, 64), "conv2": (64, 128), "conv3": (128, 256),
              "conv4": (256, 512), "conv5": (512, 512)}


def _random_params(shapes, rs):
    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return (rs.randn(*a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _flax(hw, seed):
    jm = jax_build_model("vgg16")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 6)))["params"]
    return jm, _random_params(shapes, np.random.RandomState(seed))


@pytest.mark.parametrize("hw,levels", [
    ((64, 96), [(32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]),
    # odd at every level below the first: -inf pads and crops
    ((70, 100), [(35, 50), (18, 25), (9, 13), (5, 7), (3, 4)])])
def test_pyramid_matches_flax(hw, levels):
    x = np.random.RandomState(1).randn(2, *hw, 6).astype(np.float32)
    jm, params = _flax(hw, hw[1])
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params,
                                                           jnp.asarray(x))
    model = build_model("vgg16", device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == (2, *levels[level], 2)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")


def test_gradients_match_flax():
    """Parameter gradients of sum_k <flow_k, r_k> for fixed normals r_k."""
    hw = (64, 96)
    rs = np.random.RandomState(3)
    x = rs.randn(2, *hw, 6).astype(np.float32)
    jm, params = _flax(hw, 4)
    sizes = [(2, hw[0] >> k, hw[1] >> k, 2) for k in range(1, 6)]
    r = [rs.randn(*s).astype(np.float32) for s in sizes]

    def objective(p):
        flows = jm.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(f * jnp.asarray(w)) for f, w in zip(flows, r))

    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(objective))(params)))
    model = build_model("vgg16", device="cpu")
    load_flax_params(model, params)
    flows = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((f.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
        for f, w in zip(flows, r)).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_model_constants():
    model = VGG16Flow()
    assert model.flow_scales == (10.0, 5.0, 2.5, 1.25, 0.625)
    assert model.max_downsample == 32
    assert model.encoder.widths == [64, 128, 256, 512, 512]
    assert len(VGG_CONVS) == 13
    assert sum(p.numel() for p in model.parameters()) == 18_921_154


def write_npz(path, rs, bad=None):
    """An npz with the public file's conv names and shapes; `bad` =
    (layer, shape) writes that layer's kernel at another shape."""
    arrays = {}
    for name in VGG_CONVS:
        cin, cout = VGG_WIDTHS[name[:5]]
        if not name.endswith("_1"):
            cin = cout
        shape = (3, 3, cin, cout)
        if bad is not None and bad[0] == name:
            shape = bad[1]
        arrays[f"{name}_W"] = (rs.randn(*shape) * 0.05).astype(np.float32)
        arrays[f"{name}_b"] = rs.randn(cout).astype(np.float32)
    # both loaders skip the fc layers: small stand-ins for the public
    # (25088, 4096), (4096, 4096), (4096, 1000) arrays
    for k in ("fc6", "fc7", "fc8"):
        arrays[f"{k}_W"] = np.zeros((4, 3), np.float32)
        arrays[f"{k}_b"] = np.zeros(3, np.float32)
    np.savez(path, **arrays)
    return arrays


def test_load_vgg16_npz_matches_jax(tmp_path):
    path = str(tmp_path / "vgg16_weights.npz")
    arrays = write_npz(path, np.random.RandomState(5))
    jm, params = _flax((64, 64), 6)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_load_vgg16_npz(params, path)))
    model = build_model("vgg16", device="cpu")
    load_flax_params(model, params)
    decoder = {k: v.clone() for k, v in model.state_dict().items()
               if k.startswith("decoder.")}
    assert load_vgg16_npz(model, path) is model
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    # conv1_1 tiled twice along its input channels; the decoder untouched
    w11 = got["encoder.conv1_1.conv.weight"]
    assert w11.shape == (64, 6, 3, 3)
    assert torch.equal(w11[:, :3], w11[:, 3:])
    np.testing.assert_array_equal(
        w11[:, :3].numpy(), arrays["conv1_1_W"].transpose(3, 2, 0, 1))
    for k, v in decoder.items():
        assert torch.equal(got[k], v), k


def test_load_vgg16_npz_without_tiling_or_with_a_bad_layer_raises(tmp_path):
    path = str(tmp_path / "v.npz")
    write_npz(path, np.random.RandomState(7))
    with pytest.raises(ValueError, match="conv1_1"):
        load_vgg16_npz(build_model("vgg16", device="cpu"), path,
                       duplicate_input=False)
    bad = str(tmp_path / "bad.npz")
    write_npz(bad, np.random.RandomState(8), bad=("conv3_2", (3, 3, 256, 128)))
    with pytest.raises(ValueError, match="conv3_2"):
        load_vgg16_npz(build_model("vgg16", device="cpu"), bad)
    # the JAX loader refuses the same file, by assertion
    _, params = _flax((64, 64), 9)
    with pytest.raises(AssertionError, match="conv3_2"):
        jax_load_vgg16_npz(params, bad)


def test_trainer_applies_the_npz_on_a_fresh_start_only(tmp_path):
    from deepof_tpu_torch.train.loop import Trainer

    path = str(tmp_path / "v.npz")
    arrays = write_npz(path, np.random.RandomState(10))
    cfg = ExperimentConfig(
        model="vgg16",
        data=DataConfig(dataset="synthetic", image_size=(32, 32),
                        gt_size=(32, 32), batch_size=1),
        train=TrainConfig(log_dir=str(tmp_path / "run"), vgg16_npz=path,
                          eval_every=0, log_every=1))
    t = Trainer(cfg, device="cpu")
    w = t.model.encoder.conv2_1.conv.weight.detach().clone()
    np.testing.assert_array_equal(w.numpy(),
                                  arrays["conv2_1_W"].transpose(3, 2, 0, 1))
    log = tmp_path / "run" / "metrics.jsonl"

    def messages():
        return [json.loads(ln).get("message", "")
                for ln in log.read_text().splitlines()]

    assert f"VGG16 trunk init from {path}" in messages()
    t.fit(max_steps=1)
    after = t.model.encoder.conv2_1.conv.weight.detach().clone()
    assert not torch.equal(after, w)
    # a checkpoint to resume from wins over the npz
    n = len(messages())
    t2 = Trainer(dataclasses.replace(cfg), device="cpu")
    assert torch.equal(t2.model.encoder.conv2_1.conv.weight, after)
    assert f"VGG16 trunk init from {path}" not in messages()[n:]


def test_flyingchairs_vgg_preset_from_the_command_line(tmp_path, capsys):
    """`train --preset flyingchairs_vgg` (augmentation, depthwise
    smoothness, the trunk from an npz) on a FlyingChairs tree at 64x96,
    batch 2, then `eval` of the run at the preset's 384x512 ground truth
    and `predict` of a pair at its native size; and the `bench` verb's
    step on VGG16 (`bench.bench`, tiny)."""
    import chip_smoke
    from deepof_tpu_torch import bench, cli
    from deepof_tpu_torch.io.flo import read_flo

    data, log_dir = str(tmp_path / "data"), str(tmp_path / "run")
    chip_smoke.write_chairs(data)
    npz = str(tmp_path / "v.npz")
    write_npz(npz, np.random.RandomState(11))
    argv = ["--preset", "flyingchairs_vgg", "--device", "cpu",
            "--data-path", data, "--set", "data.image_size=[64,96]",
            "--set", "data.batch_size=2", "--set", "train.eval_batch_size=2",
            "--log-dir", log_dir]
    assert cli.main(["train", *argv, "--steps", "2", "--set",
                     "train.log_every=1", "--set",
                     f"train.vgg16_npz={npz}"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["phase_augment_s"] > 0
    records = [json.loads(ln) for ln in open(f"{log_dir}/metrics.jsonl")]
    train = [r for r in records if r["kind"] == "train"]
    assert [len(r["loss_total_by_scale"]) for r in train] == [5, 5]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert any(r.get("message") == f"VGG16 trunk init from {npz}"
               for r in records)
    assert cli.main(["eval", *argv]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss"))
    rs = np.random.RandomState(12)
    pair = [str(tmp_path / f"{k}.npy") for k in "ab"]
    for p in pair:
        np.save(p, rs.randint(0, 256, (60, 90, 3), np.uint8))
    assert cli.main(["predict", *argv, "--out", str(tmp_path / "f"),
                     "--pairs", ":".join(pair)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    flows = [read_flo(p) for p in out["written"] if p.endswith(".flo")]
    assert [f.shape for f in flows] == [(60, 90, 2)]
    line = bench.bench("vgg16", batch=2, image_size=(64, 64), steps=2,
                       warmup=1, windows=1, device="cpu", steps_per_call=2)
    assert line["model"] == "vgg16" and np.isfinite(line["pairs_per_sec"])
