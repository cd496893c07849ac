"""The gradient of the PyTorch port's correlation against the JAX
package's: the plain backward against autograd of the plain forward, the
`Correlation` Function against `jax.grad` of the XLA sweep and of the
Pallas kernel in interpret mode (whose custom VJP is the XLA scan the
CUDA backward kernels replace), and a small FlowNet-C whose towers get
their gradient through the cost volume.

Tolerances: 1e-6 (atol and rtol) for the plain backward against autograd
(float32 both ways, sums in another order); 1e-4 against JAX, as
tests/test_pallas_corr.py::test_pallas_corr_grad_matches_xla pins the
JAX kernel's gradient; for the model, 1e-4 of each tensor's largest
gradient entry (float32 convolutions sum in another order in XLA and in
PyTorch; the pyramids agree at 1e-4, test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.ops.corr import correlation as jax_correlation
from deepof_tpu.ops.pallas.corr import correlation_pallas
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.models import flownet_c
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.ops.corr import (correlation,
                                       correlation_backward_reference,
                                       correlation_nchw,
                                       correlation_reference)

# NHWC shapes of tests/test_pallas_corr.py (its fixture, the ragged H and
# the gradient test's crop) and a ragged H, W and C
SHAPES = [(2, 12, 16, 8), (2, 11, 16, 8), (1, 8, 8, 8), (2, 11, 13, 5)]
GEOMETRIES = [(2, 1), (3, 1), (4, 2)]


def _inputs(shape, max_disp, stride, seed=0):
    rs = np.random.RandomState(seed)
    n = 2 * (max_disp // stride) + 1
    f1, f2 = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    g = rs.randn(*shape[:3], n * n).astype(np.float32)
    return f1, f2, g


@pytest.mark.parametrize("max_disp,stride", GEOMETRIES + [(0, 1), (6, 3)])
def test_backward_reference_matches_autograd(max_disp, stride):
    f1, f2, g = _inputs((2, 11, 13, 5), max_disp, stride, seed=1)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
            for a in (f1, f2, g)]
    a1, a2 = (t.clone().requires_grad_(True) for t in nchw[:2])
    want = torch.autograd.grad(
        correlation_reference(a1, a2, max_disp, stride), (a1, a2), nchw[2])
    got = correlation_backward_reference(*nchw, max_disp, stride)
    for gt, w in zip(got, want):
        assert gt.dtype == torch.float32 and gt.shape == w.shape
        torch.testing.assert_close(gt, w, atol=1e-6, rtol=1e-6)


def test_backward_reference_keeps_the_input_dtype():
    f1, f2, g = _inputs((1, 6, 7, 4), 2, 1)
    bf = [torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().bfloat16()
          for a in (f1, f2, g)]
    d1, d2 = correlation_backward_reference(*bf, 2, 1)
    assert d1.dtype == d2.dtype == torch.bfloat16


@pytest.mark.parametrize("max_disp,stride", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_correlation_grad_matches_jax(shape, max_disp, stride):
    f1, f2, g = _inputs(shape, max_disp, stride)
    t1, t2 = (torch.from_numpy(a).requires_grad_(True) for a in (f1, f2))
    out = correlation(t1, t2, max_disp, stride)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))

    def jax_grads(fn):
        return jax.jit(lambda a, b, ct: jax.vjp(fn, a, b)[1](ct))(
            jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g))

    for want in (jax_grads(lambda a, b: jax_correlation(
                     a, b, max_disp, stride, impl="xla")),
                 jax_grads(lambda a, b: correlation_pallas(
                     a, b, max_disp, stride, 4, True))):
        np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(t2.grad.numpy(), np.asarray(want[1]),
                                   atol=1e-4)


def test_correlation_nchw_differentiates_both_inputs_once():
    """The Function is the only route: its backward runs once, and a
    second input that needs no gradient gets none."""
    f1, f2, g = _inputs((1, 6, 7, 4), 2, 1)
    t1 = torch.from_numpy(f1).permute(0, 3, 1, 2).contiguous()
    t2 = torch.from_numpy(f2).permute(0, 3, 1, 2).contiguous()
    t1.requires_grad_(True)
    out = correlation_nchw(t1, t2, 2, 1)
    assert type(out.grad_fn).__name__ == "CorrelationBackward"
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    want = correlation_backward_reference(
        t1.detach(), t2, torch.from_numpy(g).permute(0, 3, 1, 2).contiguous(),
        2, 1)[0]
    assert torch.equal(t1.grad, want) and t2.grad is None


def test_correlation_cuda_refuses_a_tensor_that_requires_grad():
    """Outside the Function the kernel would drop the gradient: it raises
    before it looks at the device."""
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda, launches

    t = torch.zeros(1, 4, 3, 3)
    before = launches.count
    with pytest.raises(RuntimeError, match="requires grad"):
        correlation_cuda(t.clone().requires_grad_(True), t, 1, 1)
    assert launches.count == before


@pytest.fixture(scope="module")
def flownet_c_grads():
    """A FlowNet-C (width 0.25, geometry 4 / 1) from one flax init, and
    the JAX gradient of sum_k <flow_k, ct_k> over its six levels."""
    rs = np.random.RandomState(0)
    x = rs.randn(1, 64, 64, 6).astype(np.float32)
    jm = jax_build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                         corr_stride=1)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    shapes = [f.shape for f in jax.eval_shape(
        lambda p: jm.apply({"params": p}, jnp.asarray(x)), params)]
    cts = [rs.randn(*s).astype(np.float32) for s in shapes]

    def objective(p):
        flows = jm.apply({"params": p}, jnp.asarray(x))
        return sum(jnp.sum(f * c) for f, c in zip(flows, cts))

    grads = jax.tree_util.tree_map(np.asarray,
                                   jax.jit(jax.grad(objective))(params))
    return x, params, cts, state_dict_from_flax(grads)


def _port_grads(x, params, cts):
    model = build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                        corr_stride=1, device="cpu")
    load_flax_params(model, params)
    flows = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    sum((f.permute(0, 2, 3, 1) * torch.from_numpy(c)).sum()
        for f, c in zip(flows, cts)).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_flownet_c_towers_learn_through_the_cost_volume(flownet_c_grads,
                                                        monkeypatch):
    x, params, cts, want = flownet_c_grads
    got = _port_grads(x, params, cts)
    for name, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got[name], w, atol=1e-4 * scale, rtol=0,
                                   msg=name)
    # with the cost volume cut from the graph, the towers' gradient moves
    # by more than ten times the tolerance: the check above holds the
    # gradient that reaches them through the cost volume
    monkeypatch.setattr(flownet_c, "correlation_nchw",
                        lambda a, b, *geo: correlation_reference(
                            a.detach(), b.detach(), *geo))
    cut = _port_grads(x, params, cts)
    for layer in ("conv1", "conv2", "conv3"):
        name = f"{layer}.conv.weight"
        assert float(want[name].abs().max()) > 0
        gap = float((cut[name] - got[name]).abs().max())
        assert gap > 1e-3 * float(want[name].abs().max()), name
