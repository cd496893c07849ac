"""st_baseline (full width; its FlowNet-S trunk sets downsample 64) at
256x16, under mesh.spatial=2 on two gloo ranks on the CPU, against the
port's one-process step and eval and the JAX package's gradient
(`tests/_torch_spatial_families.py` says what each case holds and
within what)."""

import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_families as F  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

NAMES = ("st_baseline",)
CASES = F.cases(NAMES)


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial_baseline"))
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
