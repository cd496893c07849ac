"""The row-sharded pools and the decoder's scale-1 deconv
(`models/common.py`: `max_pool`, `avg_pool`, `Deconv`); the families'
steps are in `tests/test_torch_spatial_families_*.py`.

  - Each layer on row blocks of 2 and 3 real gloo ranks on the CPU
    (`tests/_torch_spatial_worker.py`; even and odd heights, uneven ceil
    blocks, a block of one real row and an empty one, inputs mostly
    below zero) against the whole-height op: the pools' outputs bit for
    bit, the deconv's within 1e-6 of their largest entry (its
    transposed conv sums its taps over a window in another order than
    over the whole height: 1.7e-8 measured), the input gradients within
    1e-6 of their largest entry (a row read by two ranks gets its two
    parts added at its owner, in another order);
  - the same window arithmetic over many heights in one process
    (hypothesis): each rank's block computed from the whole input
    (`Rows(whole=True)`, whose window is the exchange's without the
    wire), concatenated, equals the whole-height op as above, and the
    gradients summed over the ranks its gradient;
"""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepof_tpu_torch.parallel.spatial import Rows, SpatialGroup

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_worker as W  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

OPS = ("max3", "max2", "avg3", "deconv1")
#: the pool cases' heights: over 2 ranks 10 (5 | 5, the pools' 5 rows
#: 3 | 2: rank 0 reads row 5 of rank 1), 9 and 3 (2 | 1: one real row);
#: over 3, 7 (3 | 3 | 1), 10 (4 | 4 | 2) and 4 (2 | 2 | 0: an empty
#: block, below any gate)
POOL_ROWS = {2: (10, 9, 3), 3: (7, 10, 4)}


def assert_layer_equal(op: str, got: torch.Tensor,
                       want: torch.Tensor) -> None:
    """A pool's blocks bit for bit; the deconv's within 1e-6 of the
    largest entry."""
    assert got.shape == want.shape
    if op == "deconv1":
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    else:
        assert torch.equal(got, want)


def pool_cases(ranks: int) -> list[dict]:
    return [{"name": f"{op}_{n}_{ranks}", "kind": "pool", "op": op,
             "n": n, "mesh": [1, ranks, 1]}
            for op in OPS for n in POOL_ROWS[ranks]]


def write_pool(work: str, case: dict) -> None:
    """x: (2, 3, n, 5) standard normal less 1 (most entries below
    zero); w: the cotangent, the whole output's shape."""
    rs = np.random.RandomState(case["n"])
    x = (rs.randn(2, 3, case["n"], 5) - 1.0).astype(np.float32)
    fn, _ = W.layer_fn(case["op"], case["n"], 3)
    out = fn(torch.tensor(x), None)
    w = rs.randn(*out.shape).astype(np.float32)
    np.savez(os.path.join(work, f"{case['name']}.npz"), x=x, w=w)


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial_layers"))
    for case in pool_cases(2) + pool_cases(3):
        write_pool(work, case)
    return {"work": work, "two": W.launch(work, pool_cases(2), 2),
            "three": W.launch(work, pool_cases(3), 3)}


@pytest.mark.parametrize("case", pool_cases(2) + pool_cases(3),
                         ids=lambda c: c["name"])
def test_row_sharded_pool_equals_the_whole_height_op(world_run, case):
    with np.load(os.path.join(world_run["work"],
                              f"{case['name']}.npz")) as z:
        x, w = z["x"], z["w"]
    fn, _ = W.layer_fn(case["op"], case["n"], 3)
    xt = torch.tensor(x, requires_grad=True)
    want = fn(xt, None)
    (want * torch.tensor(w)).sum().backward()
    ranks = world_run["two" if case["mesh"][1] == 2 else "three"]
    got = torch.cat([r[case["name"]]["out"] for r in ranks], dim=-2)
    assert_layer_equal(case["op"], got, want.detach())
    grad = torch.cat([r[case["name"]]["grad"] for r in ranks], dim=-2)
    np.testing.assert_allclose(grad.numpy(), xt.grad.numpy(), rtol=0,
                               atol=1e-6 * float(xt.grad.abs().max()))


@settings(max_examples=60, deadline=None)
@given(op=st.sampled_from(OPS), n=st.integers(2, 40),
       size=st.integers(2, 4), shift=st.floats(-3.0, 1.0))
def test_pool_windows_over_heights_in_one_process(op, n, size, shift):
    """Each rank's block from the whole input (the exchange's window,
    zeros outside the image, without the wire): the blocks of every
    rank, concatenated, are the whole-height op's, and the gradients
    summed over the ranks are its gradient."""
    g = torch.Generator().manual_seed(n * 10 + size)
    x = torch.randn(1, 2, n, 7, generator=g) + shift
    fn, n_out = W.layer_fn(op, n, 2)
    xt = x.clone().requires_grad_(True)
    want = fn(xt, None)
    w = torch.randn(want.shape, generator=g)
    (want * w).sum().backward()
    outs, grad = [], torch.zeros_like(x)
    for index in range(size):
        rows = Rows(SpatialGroup(size, index, tuple(range(size))), n,
                    whole=True)
        xi = x.clone().requires_grad_(True)
        out = fn(xi, rows)
        a, b = rows.group.block(n_out)
        assert out.shape[-2] == b - a
        (out * w[..., a:b, :]).sum().backward()
        outs.append(out.detach())
        grad += xi.grad
    assert_layer_equal(op, torch.cat(outs, dim=-2), want.detach())
    torch.testing.assert_close(grad, xt.grad, rtol=0,
                               atol=1e-6 * float(xt.grad.abs().max()))
