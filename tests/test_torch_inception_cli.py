"""The paper's presets from the port's command line on the CPU (thin and
small: width 0.25, 64 x 96 or Sintel crops of 40 x 72, batch 2):
`train --preset flyingchairs` on a FlyingChairs tree and `--preset
sintel` on a Sintel tree, each through a checkpoint, `eval` and (pairs)
`predict`; `train --synthetic` at the command line's default preset;
the `verify-ckpt` verb against the JAX package's on the same run
directory; the `bench` verb; and the float32 rule (F17): a float32
`Trainer` and every `InferenceEngine` turn TF32 off.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deepof_tpu import cli as jax_cli
from deepof_tpu_torch import bench, cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          TrainConfig, get_config)
from deepof_tpu_torch.io.flo import read_flo
from deepof_tpu_torch.resilience.verify import verify_run
from deepof_tpu_torch.serve.engine import InferenceEngine
from deepof_tpu_torch.train.loop import Trainer

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

THIN = ["--device", "cpu", "--set", "width_mult=0.25",
        "--set", "data.batch_size=2", "--set", "train.eval_batch_size=2",
        "--set", "train.log_every=1"]
CHAIRS = [*THIN, "--preset", "flyingchairs",
          "--set", "data.image_size=[64,96]"]
SINTEL = [*THIN, "--preset", "sintel", "--set", "data.image_size=[48,80]",
          "--set", "data.crop_size=[40,72]",
          "--set", "data.gt_size=[60,100]"]


def _run(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _finite(d, keys=("aee", "aae", "val_loss")):
    return all(np.isfinite(d[k]) for k in keys)


@pytest.fixture(scope="module")
def chairs_run(tmp_path_factory):
    """A 2-step flyingchairs-preset run on a 12-pair tree (8 train)."""
    root = tmp_path_factory.mktemp("chairs")
    data, log_dir = str(root / "data"), str(root / "run")
    chip_smoke.write_chairs(data)
    assert cli.main(["train", *CHAIRS, "--data-path", data, "--steps", "2",
                     "--log-dir", log_dir]) == 0
    return data, log_dir


def test_flyingchairs_preset_trains_inception(chairs_run):
    _, log_dir = chairs_run
    records = _records(log_dir)
    train = [r for r in records if r["kind"] == "train"]
    assert train and all(np.isfinite(r["loss"]) for r in train)
    assert all(len(r["loss_total_by_scale"]) == 6 for r in train)
    infos = [r["message"] for r in records if r["kind"] == "info"]
    assert any(m.startswith("model parameters: ") for m in infos)
    report = verify_run(log_dir)
    assert report["ok"] and 2 in report["valid_steps"]


def test_flyingchairs_preset_evaluates_and_predicts(chairs_run, tmp_path,
                                                   capsys):
    """`eval` restores the run and scores at the preset's 384x512 ground
    truth (amplifier 2.0, the preset's clip); `predict` writes each
    pair's flow at its native 384x512."""
    data, log_dir = chairs_run
    preset = get_config("flyingchairs")
    assert preset.model == "inception_v3"
    assert (preset.train.eval_amplifier, preset.data.gt_size) == (
        2.0, (384, 512))
    ev = _run(capsys, "eval", *CHAIRS, "--data-path", data,
              "--log-dir", log_dir)
    assert _finite(ev) and ev["gt_abs_mean"] > 0
    pairs = [f"{data}/{i:05d}_img1.ppm:{data}/{i:05d}_img2.ppm"
             for i in (1, 2)]
    out = _run(capsys, "predict", *CHAIRS, "--log-dir", log_dir, "--out",
               str(tmp_path), "--pairs", *pairs)
    flows = [read_flo(p) for p in out["written"] if p.endswith(".flo")]
    assert [f.shape for f in flows] == [(384, 512, 2)] * 2
    assert all(np.isfinite(f).all() for f in flows)


def test_sintel_preset_trains_and_evaluates_inception(tmp_path, capsys):
    data, log_dir = str(tmp_path / "sintel"), str(tmp_path / "run")
    chip_smoke.write_sintel(data, hw=(60, 100))
    summary = _run(capsys, "train", *SINTEL, "--data-path", data,
                   "--max-steps", "2", "--log-dir", log_dir)
    assert summary["steps_per_sec"] > 0
    train = [r for r in _records(log_dir) if r["kind"] == "train"]
    assert train and all(np.isfinite(r["loss"]) for r in train)
    assert verify_run(log_dir)["ok"]
    ev = _run(capsys, "eval", *SINTEL, "--data-path", data,
              "--log-dir", log_dir)
    assert _finite(ev)


def test_train_at_the_default_preset(tmp_path, capsys):
    """`train --synthetic` takes the flyingchairs preset's Inception-v3."""
    summary = _run(capsys, "train", "--synthetic", *THIN, "--steps", "2",
                   "--log-dir", str(tmp_path))
    assert summary["steps_per_sec"] > 0
    assert [r["step"] for r in _records(str(tmp_path))
            if r["kind"] == "train"] == [1, 2]
    assert verify_run(str(tmp_path))["ok"]


def _verify(mod, path, capsys):
    rc = mod.main(["verify-ckpt", path])
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def test_verify_ckpt_matches_the_jax_verb(chairs_run, tmp_path, capsys):
    """The same report and exit code as `deepof_tpu verify-ckpt` on the
    same run: clean (0), with a corrupted shard (1), and empty (2, with
    the same note on stderr)."""
    import shutil

    _, log_dir = chairs_run
    run = str(tmp_path / "run")
    shutil.copytree(log_dir, run)
    for path in (run, os.path.join(run, "ckpt")):
        got, want = _verify(cli, path, capsys), _verify(jax_cli, path, capsys)
        assert got == want and got[0] == 0 and got[1]["valid_steps"]
    step = max(verify_run(run)["valid_steps"])
    step_dir = os.path.join(run, "ckpt", f"step_{step:010d}")
    shard = sorted(f for f in os.listdir(step_dir)
                   if not f.startswith("manifest"))[0]
    with open(os.path.join(step_dir, shard), "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    got, want = _verify(cli, run, capsys), _verify(jax_cli, run, capsys)
    assert got == want and got[0] == 1 and got[1]["corrupt_steps"] == [step]
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    got, want = _verify(cli, empty, capsys), _verify(jax_cli, empty, capsys)
    assert got == want and got[0] == 2 and "no checkpoints" in got[2]


def test_bench_data_only_prints_one_line(capsys):
    line = _run(capsys, "bench", "--data-only", "--batch", "4",
                "--batches", "3", "--image-size", "32x48")
    assert line["metric"] == bench.DATA_METRIC and line["value"] > 0
    assert line["bytes_per_batch"] == 4 * 32 * 48 * 3 * 4 * 2 + 4 * 32 * 48 \
        * 2 * 4 + 4 * 4
    # the recipe is ported (item 9.5): its first stage's mixture is
    # timed (tests/test_torch_recipe.py), and a missing file is missing
    with pytest.raises(FileNotFoundError):
        cli.main(["bench", "--data-only", "--recipe", "/nonexistent.json"])
    # the UCF-101 loader is ported (item 9.4): it is timed, and a missing
    # tree is a missing file, not an unported feature
    with pytest.raises(FileNotFoundError):
        cli.main(["bench", "--data-only", "--dataset", "ucf101",
                  "--data-path", "/nonexistent-ucf101"])


def test_bench_times_the_headline_step_at_a_tiny_size():
    res = bench.bench(batch=2, image_size=(64, 64), steps=2, warmup=1,
                      windows=1, device="cpu", steps_per_call=2,
                      width_mult=0.125)
    for key in ("pairs_per_sec", "pairs_per_sec_per_chip", "steps_per_sec",
                "matmul_tflops", "flops_per_step", "model_tflops",
                "mfu_nominal"):
        assert res[key] > 0, key
    assert (res["n_chips"], res["batch"], res["steps_per_call"]) == (1, 2, 2)
    assert res["pairs_per_sec"] == pytest.approx(2 * res["steps_per_sec"])
    assert res["compute_dtype"] == "bfloat16" and res["warp_impl"] == "auto"
    assert "dev_mem_peak_bytes" not in res  # None on the CPU: left out
    cfg = bench.headline_config()
    assert (cfg.model, cfg.data.batch_size, cfg.data.image_size,
            cfg.loss.weights, cfg.train.steps_per_call) == (
        "inception_v3", 16, (320, 448), (16, 8, 4, 2, 1, 1), 4)


@pytest.fixture
def tf32_on():
    """Both TF32 switches on (PyTorch's cuDNN default, and matmul's
    opt-in), restored after."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = before


def _switches():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("dtype,want", [("float32", (False, False)),
                                        ("bfloat16", (True, True))])
def test_a_float32_trainer_turns_tf32_off(tf32_on, tmp_path, dtype, want):
    cfg = ExperimentConfig(
        model="flownet_s", width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(64, 64)),
        train=TrainConfig(log_dir=str(tmp_path), compute_dtype=dtype))
    Trainer(cfg, device="cpu")
    assert _switches() == want


def test_every_engine_turns_tf32_off(tf32_on):
    cfg = ExperimentConfig(model="flownet_s", width_mult=0.125,
                           data=DataConfig(image_size=(64, 64)))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    with InferenceEngine(cfg, device="cpu"):
        assert _switches() == (False, False)
