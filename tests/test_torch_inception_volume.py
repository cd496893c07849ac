"""Training Inception-v3 on Sintel T-frame volumes in the port against
the JAX package: the `sintel` preset's loss (alpha_c = alpha_s = 0.3, no
smoothness, weights 16 / 8 / 4 / 4 / 2 / 1) on Inception's six levels of
a T = 3 volume (flow_channels = 4, the two H/8 levels folded with the
others into one warp call), and one train step of a thin model on such
a volume. The checks and their tolerances are
test_torch_inception_train.py's.
"""

from test_torch_inception_train import (T, check_loss_on_inception_levels,
                                        check_train_step)


def test_volume_loss_on_inception_levels_matches_jax(monkeypatch):
    check_loss_on_inception_levels("sintel", T, monkeypatch, op_by_op=True)


def test_volume_train_step_loss_and_gradients_match_jax():
    check_train_step("sintel", T)
