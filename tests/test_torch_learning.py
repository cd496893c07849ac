"""The port's training learns: the two learning-evidence tests of the JAX
package (`tests/test_train.py::test_flownet_c_learns_matching_below_zero_flow`
and `::test_inception_learns_flow_below_zero_flow`) on the port's own
pieces, with the JAX bounds unchanged.

Each trains a thin model on `SyntheticData` (exact ground truth: the
unsupervised objective's minimiser is the true flow) and asserts that
the held-out AEE under the FlyingChairs protocol falls well below the
zero-flow EPE, the level a model that predicts no motion scores. The
init and the order of the parameters' draws are torch's, so the curve is
not the JAX one; the bound is.

Both are marked `slow` (tier-1 runs `-m 'not slow'`). They take the card
when one is present and the CPU otherwise. This file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_learning.py -m slow --noconftest -q -rP

Both run under deterministic algorithms (the `deterministic` fixture:
`torch.use_deterministic_algorithms(True)` and cuDNN deterministic, set
here only; the `Trainer`'s defaults are not changed): with PyTorch's
defaults one seed of the FlowNet-C test gave other AEEs from process to
process on the card, because cuDNN's fastest backward algorithms add
with atomics (F26). Each test prints its AEE (`-rP` shows it).
"""

import os

import numpy as np
import pytest
import torch

from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          LossConfig, OptimConfig,
                                          TrainConfig)
from deepof_tpu_torch.core.device import disable_tf32
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.tools.synthetic_fit import zero_flow_epe
from deepof_tpu_torch.train.evaluate import evaluate_aee
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import make_eval_fn, make_train_step

pytestmark = [pytest.mark.slow, pytest.mark.usefixtures("deterministic")]

H, W = 64, 64


@pytest.fixture
def deterministic():
    """Deterministic algorithms and cuDNN deterministic for one test,
    restored after it (cuBLAS needs its workspace setting for that mode
    before its first call)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.use_deterministic_algorithms(prev[0])
    torch.backends.cudnn.deterministic = prev[1]
    torch.backends.cudnn.benchmark = prev[2]


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _cfg(tmp_path, model: str, **model_kw) -> ExperimentConfig:
    """tests/test_train.py's `_cfg` with the FlyingChairs eval protocol
    (pr1 x 2, clipped), as both learning tests set it."""
    return ExperimentConfig(
        name="test", model=model, width_mult=0.25,
        loss=LossConfig(weights=(16, 8, 4, 2, 1, 1)),
        optim=OptimConfig(learning_rate=1e-4, epochs_per_decay=2),
        data=DataConfig(dataset="synthetic", image_size=(H, W),
                        gt_size=(H, W), batch_size=8),
        train=TrainConfig(num_epochs=1, log_every=1, eval_every=0,
                          ckpt_every_epochs=1, log_dir=str(tmp_path),
                          eval_amplifier=2.0, eval_clip=(-300.0, 250.0),
                          eval_batch_size=8, seed=0),
        **model_kw)


def test_flownet_c_learns_matching_below_zero_flow(tmp_path):
    """FlowNet-C with the displacement scale matched to its correlation
    bins (max_shift 8 px at 64 px, ~1 feature pixel at the 1/8 grid,
    stride 1) descends below 0.85x the zero-flow AEE in 600 steps at
    batch 8."""
    disable_tf32()
    cfg = _cfg(tmp_path, "flownet_c", corr_max_disp=3, corr_stride=1)
    ds = SyntheticData(cfg.data, num_train=512, max_shift=8.0,
                       style="blobs", n_blobs=40)
    model = build_model("flownet_c", width_mult=0.25, corr_max_disp=3,
                        corr_stride=1, device=_device())
    state = create_train_state(model, cfg.optim, lambda s: 3e-4)
    step = make_train_step(model, cfg, ds.mean)
    eval_fn = make_eval_fn(cfg, ds.mean)

    zero_epe = zero_flow_epe(ds)
    rng = np.random.RandomState(0)
    for _ in range(600):
        step(state, ds.sample_train(8, rng=rng))
    res = evaluate_aee(eval_fn, model, ds, cfg)
    print("flownet_c aee", repr(res["aee"]), "zero_epe", repr(zero_epe))
    assert res["aee"] < 0.85 * zero_epe, (res["aee"], zero_epe)


def test_inception_learns_flow_below_zero_flow(tmp_path):
    """Inception-v3 flow (the model the reference trains), thin (width
    0.25), on the affine field with a sub-pixel curriculum start,
    descends below 0.9x the zero-flow AEE within 2600 steps; evals from
    step 1400 every 200, stopping at the bound."""
    disable_tf32()
    cfg = _cfg(tmp_path, "inception_v3")
    ds = SyntheticData(cfg.data, num_train=8192, max_shift=4.0,
                       style="affine", n_blobs=40, feature_scale=16)
    model = build_model("inception_v3", width_mult=0.25, device=_device())
    state = create_train_state(model, cfg.optim, lambda s: 5e-4)
    step = make_train_step(model, cfg, ds.mean)
    eval_fn = make_eval_fn(cfg, ds.mean)

    zero_epe = zero_flow_epe(ds)
    bound = 0.9 * zero_epe
    rng = np.random.RandomState(0)
    best = float("inf")
    for s in range(2600):
        shift = min(0.25 + (4.0 - 0.25) * s / 1200.0, 4.0)
        step(state, ds.sample_train(8, rng=rng, max_shift=shift))
        if s >= 1399 and (s + 1) % 200 == 0:
            best = min(best, evaluate_aee(eval_fn, model, ds, cfg)["aee"])
            if best < bound:
                break
    print("inception best_aee", repr(best), "zero_epe", repr(zero_epe))
    assert best < bound, (best, zero_epe)
