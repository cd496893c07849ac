"""A spatial=2 step of the port (`parallel/spatial.py`; two gloo ranks on
the CPU, `tests/_torch_spatial_worker.py`) against the JAX package's
single-process `model_losses` gradient of the same global batch from the
same weights (the flax init through `convert.py`).

Thin FlowNet-C (width 0.25, max_disp 2, stride 1) and FlowNet-S at
256x96, the gate's bound at downsample 64 over 2 shards, global batch 2,
the L1-like loss (alpha 0.5, F6). Tolerance: 1e-4 of each gradient
tensor's largest entry and the loss 1e-4 relative, as
`tests/test_torch_ddp.py` holds the data-parallel step. The JAX side
runs in float64 (`jax.enable_x64` inside the test only, as
`tests/test_torch_ucf101_train.py` does, every flax layer's `dtype`
float64) from the float32 weights and batch: at 256x96 two float32 sums
of a flow bias's gradient over the whole image (XLA's order and
PyTorch's) already differ by up to 1.8e-4 of its largest entry, the
one-process port step's as much as the spatial step's, so the exact
reference measures the port alone.

The same spatial=2 step in bf16 compute (`train.compute_dtype=bfloat16`,
ROADMAP item 10.2; JAX has no test of bf16 under spatial) from the same
weights and batch: its gradients' distance from JAX's float64 step
(each tensor's largest difference over its largest entry) at most
BF16_SPREAD times the distance of JAX's one-process bf16 step
(`model_losses` with `compute_dtype=bfloat16`, every flax layer's
`dtype` bf16) from that float64 step, on the worst tensor and on the
median one, and the loss within BF16_LOSS_RTOL of JAX's one-process
bf16 loss (`tests/_torch_spatial_families.py` states both).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import state_dict_from_flax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_families as F  # noqa: E402
import _torch_spatial_worker as W  # noqa: E402
from test_torch_spatial import write_case  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HW = (256, 96)
CASES = [{"name": m, "kind": "step", "model": m, "hw": list(HW),
          "batch": 2, "mesh": [1, 2, 1]} for m in ("flownet_c", "flownet_s")]
BF16_CASES = [{**c, "name": f"{c['name']}_bf16", "dtype": "bfloat16",
               "weights": c["name"]} for c in CASES]


def jax_model(case, dtype=jnp.float32):
    """The JAX model, its layers computing in `dtype` (the gradient
    reference's float64: a layer left at float32 casts to float32 inside
    `jax.enable_x64`)."""
    return jax_build_model(case["model"], width_mult=0.25, dtype=dtype,
                           **(W.CORR if case["model"] == "flownet_c"
                              else {}))


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """The flax inits (as the port's state dicts), the global batches,
    and both ranks' steps."""
    work = str(tmp_path_factory.mktemp("spatial_jax"))
    params = {}
    for case in CASES:
        write_case(work, case, seed=1)
        p = jax.jit(jax_model(case).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 6)))["params"]
        params[case["name"]] = jax.tree_util.tree_map(np.asarray, p)
        torch.save(state_dict_from_flax(params[case["name"]]),
                   os.path.join(work, f"{case['name']}.pt"))
    for case in BF16_CASES:
        write_case(work, case, seed=1)  # the same batch as its float32's
    return {"work": work, "params": params,
            "ranks": W.launch(work, CASES + BF16_CASES, 2)}


def jax_step(world_run, name: str, dtype) -> tuple[float, dict]:
    """JAX's one-process `model_losses` loss and gradients (as the
    port's state dict) of the float32 case `name`, every layer and the
    compute in `dtype` (float64: under `jax.enable_x64`)."""
    case = next(c for c in CASES if c["name"] == name)
    jm = jax_model(case, dtype)
    with jax.enable_x64(dtype == jnp.float64):
        pdt = jnp.float64 if dtype == jnp.float64 else jnp.float32
        with np.load(os.path.join(world_run["work"], f"{name}.npz")) as z:
            batch = {k: jnp.asarray(z[k], pdt)
                     for k in ("source", "target")}
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, pdt), world_run["params"][name])

        def objective(p):
            return jax_model_losses(jm, p, batch, (0.0, 0.0, 0.0),
                                    JaxLossConfig(**W.LOSS),
                                    compute_dtype=dtype)

        (total, _), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(params)
        total = float(total)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    return total, state_dict_from_flax(grads)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_spatial_gradient_matches_the_jax_step(world_run, name):
    total, want = jax_step(world_run, name, jnp.float64)
    r0, r1 = (r[name] for r in world_run["ranks"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]), total,
                               rtol=1e-4)
    assert set(r0["grads"]) == set(want)
    for n, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(r0["grads"][n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=n)
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_spatial_bf16_gradient_within_the_spread_of_jax(world_run, name):
    _, exact = jax_step(world_run, name, jnp.float64)
    total, one = jax_step(world_run, name, jnp.bfloat16)
    r0, r1 = (r[f"{name}_bf16"] for r in world_run["ranks"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]), total,
                               rtol=F.BF16_LOSS_RTOL)
    assert set(r0["grads"]) == set(exact)
    F.assert_spread(r0["grads"], one, exact)
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
    assert r0["wire_dtypes"] == r1["wire_dtypes"] == ["torch.bfloat16"]
