"""Inception-v3, the flyingchairs and sintel presets' model (width 0.25,
128x16: the pair, and a T = 3 volume with 9 channels in and 4 flow
channels out), under mesh.spatial=2 on two gloo ranks on the CPU,
against the port's one-process step and eval and the JAX package's
gradient (`tests/_torch_spatial_families.py` says what each case holds
and within what), and the sintel preset from the command line."""

import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_families as F  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

NAMES = ("inception", "inception_volume")
CASES = F.cases(NAMES)


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial_inception"))
    yield F.run(work, NAMES)
    shutil.rmtree(work, ignore_errors=True)  # weights and batches


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["kind"] == "step"
                                  and "dtype" not in c])
def test_spatial_step_matches_one_process(world_run, name):
    F.assert_matches_one_process(world_run, name)


@pytest.mark.parametrize("name", NAMES)
def test_spatial_bf16_step_within_the_spread(world_run, name):
    F.assert_bf16_spread(world_run, name)


@pytest.mark.parametrize("name", NAMES)
def test_spatial_gradient_matches_the_jax_step(world_run, name):
    F.assert_matches_jax(world_run, name)


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["kind"] == "eval"])
def test_spatial_eval_matches_one_process(world_run, tmp_path, name):
    F.assert_eval_matches(world_run, name, str(tmp_path))


def test_train_multihost_spatial_sintel_volume_on_the_cpu(tmp_path):
    """The sintel preset (Inception-v3 over T-frame volumes) from the
    command line, thin, at 128 rows (the gate's bound at downsample 32
    over 2) and T = 3 on the synthetic dataset."""
    F.train_multihost(str(tmp_path / "run"), [
        "--preset", "sintel", "--set", "width_mult=0.125", "--set",
        "data.time_step=3", "--set", "data.image_size=[128,48]", "--set",
        "data.crop_size=[128,48]", "--set", "data.gt_size=[128,48]"])
