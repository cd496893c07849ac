"""The port's augmentation (`data/augmentation.py`) against the JAX
package's, and its determinism in the train loop.

The port draws with `torch.Generator`, not `jax.random`'s threefry (F18),
so what is held to JAX is *apply* given the same parameters and noise:
  - `apply_geo` under parameters drawn by JAX's `sample_geo_params`
    (identity, a flip, a translation, random draws with scales up to
    2.0): the displacement field is the same arithmetic in float32, but
    `cos`/`sin` and the affine may round apart by an ulp, and the warp is
    continuous in the flow, so the frames are held to 2e-3 of the 0-255
    range (measured: equal on these inputs);
  - `apply_photo` against JAX's `photometric_augment`, with the
    parameters and the noise rebuilt from JAX's key by its split order
    (`augmentation.py:105-121`, `fold_in(kn2, i)` for frame i's noise):
    to 1e-3 (measured at most 3.1e-5; `pow` rounds apart).
*Sample* is held to the JAX module's ranges and to determinism: one seed
gives one batch, and the train loop's augmented batches are the same for
`data.num_workers` 1 and 3, `data.prefetch` 0 and 2, and
`train.steps_per_call` 1 and 2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.data import augmentation as jaug
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          TrainConfig)
from deepof_tpu_torch.data import augmentation as aug

B, H, W = 4, 48, 64


def _frames(seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(B, H, W, 3).astype(np.float32) * 255 for _ in range(2)]


def _jax_params(kind):
    if kind == "identity":
        return jaug.identity_geo_params(B)
    p = dict(jaug.identity_geo_params(B))
    if kind == "flip":
        p["flip"] = jnp.asarray([True, False, True, True])
    elif kind == "translation":
        p["tx"] = jnp.asarray([0.2, -0.13, 0.05, -0.2])
        p["ty"] = jnp.asarray([-0.2, 0.07, 0.2, 0.0])
    else:
        p = jaug.sample_geo_params(jax.random.PRNGKey(3), B)
        p = dict(p, scale=p["scale"].at[0].set(2.0))
    return p


@pytest.mark.parametrize("kind", ["identity", "flip", "translation",
                                  "random"])
def test_apply_geo_matches_jax(kind):
    frames = _frames(1)
    p = _jax_params(kind)
    want = [np.asarray(jaug.apply_geo(jnp.asarray(f), p)) for f in frames]
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    got = aug.apply_geo([torch.from_numpy(f) for f in frames], tp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-3)
    if kind == "identity":
        np.testing.assert_allclose(got[0].numpy(), frames[0], atol=2e-3)


def test_apply_photo_matches_jax():
    frames = _frames(2)
    key = jax.random.PRNGKey(7)
    want = jaug.photometric_augment(key, *(jnp.asarray(f) for f in frames))
    # JAX's draws, rebuilt from the key in its split order
    kc, kb, kcol, kg, kn1, kn2 = jax.random.split(key, 6)
    params = {
        "contrast": jax.random.uniform(kc, (B, 1, 1, 1),
                                       minval=jaug.CONTRAST[0],
                                       maxval=jaug.CONTRAST[1]),
        "brightness": jax.random.normal(kb, (B, 1, 1, 1))
        * jaug.BRIGHTNESS_SIGMA,
        "color": jax.random.uniform(kcol, (B, 1, 1, 3),
                                    minval=jaug.COLOR_RANGE[0],
                                    maxval=jaug.COLOR_RANGE[1]),
        "gamma": jax.random.uniform(kg, (B, 1, 1, 1),
                                    minval=jaug.GAMMA_RANGE[0],
                                    maxval=jaug.GAMMA_RANGE[1]),
        "sigma": jax.random.uniform(kn1, (B, 1, 1, 1),
                                    maxval=jaug.NOISE_SIGMA_MAX)}
    noises = [jax.random.normal(jax.random.fold_in(kn2, i), f.shape)
              for i, f in enumerate(frames)]
    got = aug.apply_photo(
        [torch.from_numpy(f) for f in frames],
        {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
        [torch.from_numpy(np.asarray(n)) for n in noises])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)


def test_sampled_parameters_stay_in_the_jax_ranges():
    assert (aug.TRANSLATION, aug.ROTATION_DEG, aug.SCALE_RANGE,
            aug.CONTRAST, aug.BRIGHTNESS_SIGMA, aug.COLOR_RANGE,
            aug.GAMMA_RANGE, aug.NOISE_SIGMA_MAX) == (
        jaug.TRANSLATION, jaug.ROTATION_DEG, jaug.SCALE_RANGE,
        jaug.CONTRAST, jaug.BRIGHTNESS_SIGMA, jaug.COLOR_RANGE,
        jaug.GAMMA_RANGE, jaug.NOISE_SIGMA_MAX)
    n = 4096
    geo = aug.sample_geo_params(aug.generator(1, 0, "cpu"), n)
    rot = math.radians(aug.ROTATION_DEG)
    assert -rot <= geo["angle"].min() and geo["angle"].max() <= rot
    assert geo["angle"].abs().max() > 0.95 * rot
    assert aug.SCALE_RANGE[0] <= geo["scale"].min()
    assert geo["scale"].max() <= aug.SCALE_RANGE[1]
    for k in ("tx", "ty"):
        assert geo[k].abs().max() <= aug.TRANSLATION
    assert 0.45 < geo["flip"].float().mean() < 0.55
    assert not aug.sample_geo_params(aug.generator(1, 0, "cpu"), n,
                                     rotation=False)["angle"].any()
    photo = aug.sample_photo_params(aug.generator(1, 1, "cpu"), n)
    for k, (lo, hi) in (("contrast", aug.CONTRAST),
                        ("color", aug.COLOR_RANGE),
                        ("gamma", aug.GAMMA_RANGE),
                        ("sigma", (0.0, aug.NOISE_SIGMA_MAX))):
        assert lo <= photo[k].min() and photo[k].max() <= hi, k
    assert abs(photo["brightness"].std().item()
               - aug.BRIGHTNESS_SIGMA) < 0.02
    assert photo["color"].shape == (n, 1, 1, 3)


def test_one_seed_gives_one_batch():
    batch = {k: torch.from_numpy(f)
             for k, f in zip(("source", "target"), _frames(3))}
    a = aug.augment_batch(batch, 11)
    b = aug.augment_batch(batch, 11)
    c = aug.augment_batch(batch, 12)
    for k in ("source", "target", "net_source", "net_target"):
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
    # the photometric draws do not depend on the geometric family
    photo = aug.augment_batch(batch, 11, geo=False)
    assert torch.equal(photo["source"], batch["source"])
    g = aug.generator(11, 1, "cpu")
    params = aug.sample_photo_params(g, B)
    noises = [torch.randn((B, H, W, 3), generator=g) for _ in range(2)]
    want = aug.apply_photo([batch["source"], batch["target"]], params,
                           noises)
    assert torch.equal(photo["net_source"], want[0])
    assert torch.equal(photo["net_target"], want[1])
    geo = aug.augment_batch(batch, 11, photo=False)
    assert "net_source" not in geo
    assert torch.equal(geo["source"], a["source"])
    # K stacked micro-batches: each as it would be alone
    stacked = {k: torch.stack([v, v.flip(0)]) for k, v in batch.items()}
    s = aug.augment_batch(stacked, [11, 12])
    for k in ("source", "net_target"):
        assert torch.equal(s[k][0], a[k])
        assert torch.equal(s[k][1], aug.augment_batch(
            {q: v.flip(0) for q, v in batch.items()}, 12)[k])
    with pytest.raises(ValueError, match="seeds"):
        aug.augment_batch(stacked, 11)


def _fit_batches(tmp_path, name, **data_kw):
    """The batches the train step of a thin FlowNet-S fit sees (4
    micro-steps, augmentation on), as a list of one dict a micro-step."""
    from deepof_tpu_torch.train.loop import Trainer

    k = data_kw.pop("k", 1)
    cfg = ExperimentConfig(
        model="flownet_s", width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(32, 48),
                        gt_size=(32, 48), batch_size=2, augment_geo=True,
                        augment_photo=True, **data_kw),
        train=TrainConfig(log_dir=str(tmp_path / name), eval_every=0,
                          log_every=100, nan_guard=False,
                          steps_per_call=k))
    t = Trainer(cfg, device="cpu")
    seen, step = [], t.train_step

    def recording(state, batch):
        keys = ("source", "target", "net_source", "net_target")
        if k == 1:
            seen.append({q: batch[q].clone() for q in keys})
        else:
            seen.extend({q: batch[q][i].clone() for q in keys}
                        for i in range(k))
        return step(state, batch)

    t.train_step = recording
    summary = t.fit(max_steps=4)
    assert summary["phase_augment_s"] > 0
    return seen


def test_the_loop_augments_the_same_batches_for_any_workers_prefetch_k(
        tmp_path):
    base = _fit_batches(tmp_path, "base")
    assert len(base) == 4
    assert not torch.equal(base[0]["source"], base[0]["net_source"])
    for name, kw in (("w1", {"num_workers": 1}), ("w3", {"num_workers": 3}),
                     ("p0", {"prefetch": 0}), ("p2w3", {"prefetch": 2,
                                                        "num_workers": 3}),
                     ("k2", {"k": 2})):
        got = _fit_batches(tmp_path, name, **kw)
        assert len(got) == 4, name
        for i, (g, w) in enumerate(zip(got, base)):
            for q in w:
                assert torch.equal(g[q], w[q]), (name, i, q)


def test_flyingchairs_vgg_train_step_matches_jax():
    """One train step of the flyingchairs_vgg preset (VGG16Flow at full
    width, depthwise smoothness, weights 16/8/4/2/1) at 64x96, batch 2,
    on a batch augmented by JAX's `augment_batch` (geometric and
    photometric) given to both packages, from the same flax weights:
    the loss and its per-level components 1e-5 relative, the global
    gradient norm 1e-4 relative and each tensor's gradient 5e-3 of its
    largest entry, as test_torch_inception_train.py holds its step and
    for its reasons (convolutions summed in another order, amplified by
    the Charbonnier gradient where recon and input nearly cancel).
    Measured at 1 and at 3 torch threads: the loss 1.0e-7, the
    components at most 7.2e-7, the norm 5.7e-5 / 7.5e-5, the largest
    tensor gap 3.75e-3 (encoder.conv3_3's weight; the next 1.3e-3)."""
    from deepof_tpu.core.config import LossConfig as JaxLossConfig
    from deepof_tpu.models.registry import build_model as jax_build_model
    from deepof_tpu.train.step import model_losses as jax_model_losses
    from deepof_tpu_torch.convert import load_flax_params, \
        state_dict_from_flax
    from deepof_tpu_torch.core.config import LossConfig, get_config
    from deepof_tpu_torch.data.datasets import DATASET_MEANS
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.step import SCALE_KEYS, model_losses

    preset = get_config("flyingchairs_vgg")
    lc = preset.loss
    kw = {k: getattr(lc, k) for k in ("epsilon", "alpha_c", "alpha_s",
                                      "lambda_smooth", "weights",
                                      "smoothness")}
    mean = DATASET_MEANS["flyingchairs"]
    rs = np.random.RandomState(20)
    h, w = 64, 96
    base = rs.rand(2, h + 8, w + 8, 3).astype(np.float32) * 200 + 20
    raw = {"source": jnp.asarray(base[:, 4:4 + h, 4:4 + w]),
           "target": jnp.asarray(base[:, 5:5 + h, 6:6 + w])}
    batch = {k: np.asarray(v) for k, v in jaug.augment_batch(
        raw, jax.random.PRNGKey(21), geo=True, photo=True).items()}
    assert sorted(batch) == ["net_source", "net_target", "source", "target"]
    jm = jax_build_model("vgg16")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, h, w, 6)))["params"]
    prs = np.random.RandomState(22)
    params = jax.tree_util.tree_map(
        lambda a: (prs.randn(*a.shape) * (0.1 if len(a.shape) == 1 else
                   1.0 / np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        shapes)

    @jax.jit
    def objective(p):
        def f(p):
            return jax_model_losses(jm, p, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                                    mean, JaxLossConfig(**kw))
        (total, aux), grads = jax.value_and_grad(f, has_aux=True)(p)
        return total, {k: jnp.stack([d[k] for d in aux["losses"]])
                       for k in SCALE_KEYS}, grads

    jtot, jscales, jgrads = objective(params)
    model = build_model("vgg16", device="cpu")
    load_flax_params(model, params)
    total, aux = model_losses(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                              mean, LossConfig(**kw))
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtot), rtol=1e-5)
    for k in SCALE_KEYS:
        got = [d[k].item() for d in aux["losses"]]
        assert len(got) == 5
        np.testing.assert_allclose(got, np.asarray(jscales[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    want_norm = float(torch.sqrt(sum(g.square().sum()
                                     for g in want.values())))
    np.testing.assert_allclose(norm, want_norm, rtol=1e-4)
    for name, wt in want.items():
        scale = float(wt.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), wt.numpy(), rtol=0,
                                   atol=5e-3 * scale, err_msg=name)
