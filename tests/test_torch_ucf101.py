"""The port's UCF-101 data path and command line against the JAX
package, on a fixture tree with UCF-101's layout written in a temporary
directory (PNG frames through `io/png.py`; cv2 reads them on the JAX
side; the card's machine decodes PPM only, so `chip_smoke.py` writes PPM):

  - `UCF101Data`: classes, the group split (`_gNN_`, above 7 train; no
    group is 99, train; a one-frame clip skipped), and the draws: the
    clip, frame pair and label of every row (the decoded paths) exactly,
    with replacement when the batch outnumbers the classes, the val
    batches one class each; pixels bit for bit where neither side
    resizes and on the streaming route (the same C++ on both sides),
    and within 0.78 grey levels on the cached route when resized (cv2
    rounds its uint8 resize, the port's PyTorch resize stays float32:
    the note in ROADMAP.md);
  - `evaluate_ucf101` on both sides with the same logits (a stub eval
    fn), on the tree and on the synthetic dataset;
  - `predict_action` (prepare_frame for the classifier, prepare_pair for
    a two-stream model) against the JAX `predict_action` from the same
    weights: the same classes in the same order, probabilities within
    1e-5, the same actions.json layout;
  - the command line: `train --preset ucf101` (st_single, a short fit),
    `eval` and `predict --action` with `--labels`; `ucf101_spatial` a
    step; `bench --data-only --dataset ucf101`;
  - the label staged with its batch by the prefetcher (int64, [K, B]
    under steps_per_call), and serving refusing an action model.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.data.datasets import UCF101Data as JaxUCF101
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.predict import predict_action as jax_predict_action
from deepof_tpu.train.evaluate import evaluate_ucf101 as jax_evaluate
from deepof_tpu_torch import cli
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          TrainConfig, check_servable)
from deepof_tpu_torch.data.datasets import (SyntheticData, UCF101Data,
                                            build_dataset)
from deepof_tpu_torch.data.prefetch import Prefetcher
from deepof_tpu_torch.io.png import write_png
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.predict import predict_action
from deepof_tpu_torch.train.evaluate import evaluate_ucf101

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_native import jax_native, jax_native_loaded  # noqa: E402

CLASSES = 5
NATIVE_HW = (36, 60)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Five classes, a group-8 and a group-1 clip of 4 frames each; the
    first class also a clip without a group (train) and a one-frame clip
    (skipped)."""
    root = str(tmp_path_factory.mktemp("ucf101"))
    chip_smoke.write_ucf101(root, classes=CLASSES, frames=4, hw=NATIVE_HW,
                            fmt="png", seed=3)
    cls = chip_smoke.UCF101_CLASSES[0]
    rs = np.random.RandomState(4)
    for clip, n in ((f"v_{cls}_c02", 3), (f"v_{cls}_g09_c03", 1)):
        os.makedirs(os.path.join(root, "frames", cls, clip))
        for t in range(n):
            write_png(os.path.join(root, "frames", cls, clip,
                                   f"frame_{t + 1:04d}.png"),
                      rs.randint(0, 256, (*NATIVE_HW, 3), np.uint8))
    return root


@pytest.fixture(scope="module")
def jax_decoder():
    """The JAX package's native library loaded in this process (a fresh
    tree's first build may be in flight in another xdist worker:
    `tests/_jax_native.py`)."""
    return jax_native_loaded()


def _pair(root, **kw):
    return (UCF101Data(DataConfig(dataset="ucf101", data_path=root, **kw)),
            JaxUCF101(JaxDataConfig(dataset="ucf101", data_path=root, **kw)))


def test_split_matches_jax(tree):
    port, jax_ = _pair(tree)
    assert port.classes == jax_.classes == sorted(
        chip_smoke.UCF101_CLASSES[:CLASSES])
    assert port.train_clips == jax_.train_clips
    assert port.val_clips == jax_.val_clips
    assert (port.num_train, port.num_val) == (jax_.num_train,
                                              jax_.num_val) == (6, 5)
    assert sorted(port.train_clips) == sorted(port.val_clips) == list(
        range(CLASSES))
    assert isinstance(build_dataset(DataConfig(dataset="ucf101",
                                               data_path=tree)), UCF101Data)


def _draws(ds, seed):
    rs = np.random.RandomState(seed)
    out = [ds.sample_train(3, rng=rs), ds.sample_train(7, rng=rs)]
    out += [ds.sample_val(2, b) for b in range(CLASSES + 1)]
    return out, rs.randint(0, 1 << 30)


def _paths(ds, monkeypatch):
    """Record the paths each batch decodes."""
    seen, real = [], ds._decode_many

    def record(paths):
        seen.append(list(paths))
        return real(paths)

    monkeypatch.setattr(ds, "_decode_many", record)
    return seen


# (cache, image size, pixel tolerance in grey levels)
@pytest.mark.parametrize("cache,size,atol", [
    (True, NATIVE_HW, 0.0), (True, (24, 40), 0.78),
    (False, NATIVE_HW, 0.0), (False, (24, 40), 0.0)])
def test_draws_match_jax(tree, jax_decoder, monkeypatch, cache, size,
                         atol):
    # the streaming route is the same C++ on both sides; without the JAX
    # library the JAX dataset decodes with cv2, off by its rounding
    assert jax_decoder and jax_native.available(), \
        "deepof_tpu.native.available() is False: JAX would decode with cv2"
    port, jax_ = _pair(tree, image_size=size, cache_decoded=cache)
    paths = [_paths(ds, monkeypatch) for ds in (port, jax_)]
    (got, g_next), (want, w_next) = _draws(port, 7), _draws(jax_, 7)
    assert g_next == w_next and paths[0] == paths[1]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"source", "target", "label"}
        assert g["label"].dtype == w["label"].dtype == np.int32
        np.testing.assert_array_equal(g["label"], w["label"])
        for k in ("source", "target"):
            assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol)
    assert len(set(got[0]["label"])) == 3  # no replacement at 3 of 5
    assert got[1]["label"].shape == (7,)  # with replacement at 7
    for b, val in enumerate(got[2:]):  # one class a val batch, in turn
        assert list(val["label"]) == [b % CLASSES] * 2
    assert got[0]["source"].shape == (3, *size, 3)


class _StubEval:
    """Logits that pick the label for even-indexed rows and another
    class for odd ones; the total is a function of the batch."""

    def __call__(self, _params, batch):
        label = np.asarray(batch["label"])
        pick = np.where(np.arange(len(label)) % 2 == 0, label,
                        (label + 1) % 101)
        logits = np.eye(101, dtype=np.float32)[pick]
        return {"logits": logits, "total": float(label.sum() + 1)}


@pytest.mark.parametrize("data", ["tree", "synthetic"])
def test_evaluate_ucf101_matches_jax(tree, data):
    if data == "tree":
        port, jax_ = _pair(tree, image_size=(24, 40))
    else:  # 16 val rows at batch 3: the last batch's wrapped rows unscored
        kw = dict(dataset="synthetic", image_size=(16, 16))
        port = SyntheticData(DataConfig(**kw), num_val=16)
        jax_ = JaxSynthetic(JaxDataConfig(**kw), num_val=16)
    cfg = ExperimentConfig(train=TrainConfig(eval_batch_size=3))
    got = evaluate_ucf101(_StubEval(), None, port, cfg)
    want = jax_evaluate(_StubEval(), None, jax_,
                        JaxConfig(train=JaxTrainConfig(eval_batch_size=3)))
    assert got == want
    assert set(got) == {"accuracy", "val_loss"} and 0.5 <= got[
        "accuracy"] < 0.7


@pytest.mark.parametrize("name", ["ucf101_spatial", "st_single"])
def test_predict_action_matches_jax(tree, tmp_path, name):
    hw = (32, 32)
    jm = jax_build_model(name)
    channels = 3 if name == "ucf101_spatial" else 6
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, channels)))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape, np.float32) * np.float32(
            0.1 if len(a.shape) == 1 else 1 / np.sqrt(np.prod(a.shape[:-1]))),
        shapes)
    model = build_model(name, device="cpu", image_size=hw)
    load_flax_params(model, params)
    frames = os.path.join(tree, "frames")
    pairs = []
    for cls in sorted(os.listdir(frames))[:3]:
        clip = os.path.join(frames, cls, f"v_{cls}_g01_c01")
        pairs.append((os.path.join(clip, "frame_0001.png"),
                      os.path.join(clip, "frame_0002.png")))
    labels = [f"class{i}" for i in range(101)]
    data = dict(dataset="ucf101", image_size=hw)
    got = predict_action(ExperimentConfig(model=name,
                                          data=DataConfig(**data)),
                         pairs, str(tmp_path / "port"), model=model,
                         labels=labels)
    want = jax_predict_action(JaxConfig(model=name,
                                        data=JaxDataConfig(**data)),
                              pairs, str(tmp_path / "jax"),
                              model_params=(jm, params), labels=labels)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"source", "target", "class", "label",
                                    "prob", "top"}
        assert [t["class"] for t in g["top"]] == [t["class"]
                                                  for t in w["top"]]
        assert g["label"] == w["label"] == labels[g["class"]]
        np.testing.assert_allclose([t["prob"] for t in g["top"]],
                                   [t["prob"] for t in w["top"]], atol=1e-5)
    with open(tmp_path / "port" / "actions.json") as f:
        assert json.load(f) == got


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_command_line_on_the_tree(tree, tmp_path, capsys):
    """`train --preset ucf101` (st_single at 32x48, batch 2: a short
    Trainer.fit with a record a step, an eval and a checkpoint at its
    end), `eval`, `predict --action --labels`; a step of ucf101_spatial,
    whose records carry no flow levels (st_baseline's are st_single's,
    and `chip_smoke.py` runs it); and `bench --data-only --dataset
    ucf101`. One checkpoint a run (nan_guard off: no step-0 save), each
    run's directory removed after use: a checkpoint of the fixed-width
    models with Adam's moments is ~0.4 GB even at this size."""
    log_dir = str(tmp_path / "run")
    argv = ["--preset", "ucf101", "--device", "cpu", "--data-path", tree,
            "--set", "data.image_size=[32,48]", "--set", "data.batch_size=2",
            "--set", "train.eval_batch_size=2",
            "--set", "train.nan_guard=false"]
    assert cli.main(["train", *argv, "--steps", "2", "--log-dir", log_dir,
                     "--set", "train.log_every=1",
                     "--set", "train.eval_every=2"]) == 0
    summary = _last_json(capsys)
    records = [json.loads(ln) for ln in open(f"{log_dir}/metrics.jsonl")]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        assert all(np.isfinite(r[k]) for k in ("loss", "action_loss",
                                               "accuracy"))
        assert len(r["loss_total_by_scale"]) == 5
    evals = [r for r in records if r["kind"] == "eval"]
    assert [r["step"] for r in evals] == [2]
    assert 0.0 <= summary["accuracy"] <= 1.0 and np.isfinite(
        summary["val_loss"])
    assert cli.main(["eval", *argv, "--log-dir", log_dir]) == 0
    ev = _last_json(capsys)
    assert set(ev) == {"accuracy", "val_loss"}
    np.testing.assert_allclose(ev["val_loss"], evals[0]["val_loss"],
                               rtol=1e-6)
    names = tmp_path / "classes.txt"
    names.write_text("\n".join(sorted(chip_smoke.UCF101_CLASSES[:CLASSES])))
    clip = os.path.join(tree, "frames", chip_smoke.UCF101_CLASSES[2],
                        f"v_{chip_smoke.UCF101_CLASSES[2]}_g01_c01")
    out_dir = str(tmp_path / "act")
    assert cli.main(["predict", *argv, "--log-dir", log_dir, "--action",
                     "--labels", str(names), "--out", out_dir,
                     "--ckpt-dir", os.path.join(log_dir, "ckpt"), "--pairs",
                     f"{clip}/frame_0001.png:{clip}/frame_0002.png"]) == 0
    out = _last_json(capsys)
    assert out["written"] == [os.path.join(out_dir, "actions.json")]
    (row,) = out["actions"]
    assert len(row["top"]) == 5 and row["class"] == row["top"][0]["class"]
    assert abs(sum(t["prob"] for t in row["top"])) <= 1.0 + 1e-6
    if row["class"] < CLASSES:
        assert row["label"] == sorted(chip_smoke.UCF101_CLASSES)[row["class"]]
    shutil.rmtree(log_dir)
    run = str(tmp_path / "spatial")
    assert cli.main(["train", *argv, "--model", "ucf101_spatial", "--steps",
                     "1", "--log-dir", run, "--set", "train.log_every=1",
                     "--set", "train.eval_every=0"]) == 0
    _last_json(capsys)
    (rec,) = [json.loads(ln) for ln in open(f"{run}/metrics.jsonl")
              if json.loads(ln)["kind"] == "train"]
    assert np.isfinite(rec["loss"]) and rec["loss"] == rec["action_loss"]
    assert "accuracy" not in rec and "loss_total_by_scale" not in rec
    shutil.rmtree(run)
    assert cli.main(["bench", "--data-only", "--dataset", "ucf101",
                     "--data-path", tree, "--batch", "4", "--batches", "3",
                     "--image-size", "24x40"]) == 0
    line = _last_json(capsys)
    assert line["dataset"] == "ucf101" and line["value"] > 0
    assert line["bytes_per_batch"] == 2 * 4 * 24 * 40 * 3 * 4 + 4 * 4


def test_the_label_travels_with_its_batch():
    batch = {"source": np.zeros((2, 3, 4, 4, 3), np.float32),
             "label": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
             "other": np.ones(2)}
    pf = Prefetcher(lambda: dict(batch), depth=1, device="cpu")
    try:
        got = pf.get()
    finally:
        pf.close()
    assert got["label"].dtype == torch.int64
    assert got["label"].tolist() == [[1, 2, 3], [4, 5, 6]]
    assert got["source"].dtype == torch.float32
    assert isinstance(got["other"], np.ndarray)


@pytest.mark.parametrize("model", ["st_single", "st_baseline",
                                   "ucf101_spatial"])
def test_serving_refuses_an_action_model(model):
    with pytest.raises(ValueError, match="action head"):
        check_servable(ExperimentConfig(model=model))
    check_servable(ExperimentConfig(model="flownet_s"))
