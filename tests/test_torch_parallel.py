"""The port's `parallel/mesh.py` against the JAX package's on the same
layouts: `process_data_coords`, `local_batch_rows` (with its span
guard), `process_seed`, the loop's `data_stream_seed`, and
`elastic_stream_seed`, all exact.

A layout is a JAX mesh over the suite's 8 virtual CPU devices, each
device owned by one of H simulated processes (blocks or round robin).
The JAX side sees process h through a monkeypatched
`jax.local_devices`, as `tests/test_parallel.py` simulates multi-host;
the port's side is a `World` whose `procs` grid holds each slot's
owner, and rank h. The port's `build_mesh` itself raises on a spatial
or time axis > 1 (ROADMAP Queue A item 10's last slice).
"""

import itertools
import os

import jax
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import MeshConfig as JaxMeshConfig
from deepof_tpu.parallel import mesh as JM
from deepof_tpu.train.loop import data_stream_seed as jax_stream_seed
from deepof_tpu_torch.core.config import MeshConfig
from deepof_tpu_torch.parallel import mesh as TM
from deepof_tpu_torch.train.loop import data_stream_seed

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SHAPES = ((8, 1, 1), (4, 2, 1), (2, 2, 2), (2, 1, 4), (4, 1, 2))
HOSTS = (1, 2, 4, 8)


def _owner(i: int, hosts: int, order: str) -> int:
    """The simulated process of device i (jax.devices() order)."""
    return i // (8 // hosts) if order == "block" else i % hosts


def _layouts():
    for shape, hosts, order in itertools.product(SHAPES, HOSTS,
                                                 ("block", "round")):
        if order == "round" and hosts in (1, 8):
            continue  # the same layouts as "block"
        yield shape, hosts, order


def _call(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", "span processes" in str(e),
                "not divisible" in str(e))


@pytest.mark.parametrize("shape,hosts,order", list(_layouts()))
def test_process_rows_and_seeds_match_jax(monkeypatch, shape, hosts, order):
    data, spatial, time = shape
    mesh = JM.build_mesh(JaxMeshConfig(data=data, spatial=spatial,
                                       time=time))
    devices = jax.devices()
    owner = {d: _owner(i, hosts, order) for i, d in enumerate(devices)}
    procs = np.vectorize(lambda d: owner[d], otypes=[np.int64])(mesh.devices)
    for h in range(hosts):
        local = [d for d in devices if owner[d] == h]
        monkeypatch.setattr(jax, "local_devices", lambda local=local: local)
        world = TM.World(procs, rank=h)
        assert world.shape == dict(mesh.shape)
        assert (TM.process_data_coords(world)
                == JM.process_data_coords(mesh))
        for seed in (0, 7, 2**31 - 5):
            assert TM.process_seed(world, seed) == JM.process_seed(mesh,
                                                                   seed)
            for start in (0, 12):
                np.testing.assert_array_equal(
                    data_stream_seed(seed, start, world),
                    jax_stream_seed(mesh, seed, start))
        for batch in (8, 16, 7, 2 * data):
            assert _call(TM.local_batch_rows, world, batch) == _call(
                JM.local_batch_rows, mesh, batch), (h, batch)


def test_the_span_guard_rejects_a_partial_span(monkeypatch):
    """tests/test_parallel.py's replica layouts: a process owning one
    spanning coordinate is a replica (same rows, same seed); one owning
    several coordinates of which one spans processes is rejected."""
    mesh = JM.build_mesh(JaxMeshConfig(spatial=2))  # (4, 2, 1)
    one = [mesh.devices[1, 0, 0]]
    procs = np.ones(mesh.devices.shape, np.int64)
    procs[1, 0, 0] = 0
    monkeypatch.setattr(jax, "local_devices", lambda: one)
    world = TM.World(procs, rank=0)
    assert TM.local_batch_rows(world, 8) == JM.local_batch_rows(mesh, 8) \
        == (2, [2, 3])
    assert TM.process_seed(world, 7) == JM.process_seed(mesh, 7) == 8
    three = [mesh.devices[0, 0, 0], mesh.devices[0, 1, 0],
             mesh.devices[1, 0, 0]]
    procs = np.ones(mesh.devices.shape, np.int64)
    for d in three:
        procs[tuple(np.argwhere(mesh.devices == d)[0])] = 0
    monkeypatch.setattr(jax, "local_devices", lambda: three)
    for fn, m in ((JM.local_batch_rows, mesh),
                  (TM.local_batch_rows, TM.World(procs, rank=0))):
        with pytest.raises(ValueError, match="span processes"):
            fn(m, 8)


@pytest.mark.parametrize("seed,host,hosts,generation,step", [
    *itertools.product((0, 7, 2**40 + 5), (0, 1, 2), (2, 3), (0, 1, 4),
                       (0, 4, 2**31 + 1)),
    (2**64 - 1, 5, 1, 9, 2**32 - 1)])
def test_elastic_stream_seed_matches_jax(seed, host, hosts, generation, step):
    got = TM.elastic_stream_seed(seed, host, hosts, generation, step)
    want = JM.elastic_stream_seed(seed, host, hosts, generation, step)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_elastic_stream_seed_rejects_what_jax_rejects():
    for args in ((0, -1, 3, 0, 0), (0, 0, 0, 0, 0)):
        for fn in (TM.elastic_stream_seed, JM.elastic_stream_seed):
            with pytest.raises(ValueError, match="invalid elastic identity"):
                fn(*args)


def test_build_mesh_spans_the_world_and_refuses_spatial_and_time():
    world = TM.build_mesh(MeshConfig(), world_size=4, rank=3)
    assert world.shape == {"data": 4, "spatial": 1, "time": 1}
    assert (world.size, world.rank, world.primary) == (4, 3, False)
    assert TM.local_batch_rows(world, 8) == (2, [6, 7])
    assert TM.build_mesh(MeshConfig(data=2), 2, 0).shape["data"] == 2
    with pytest.raises(ValueError, match="devices"):
        TM.build_mesh(MeshConfig(data=2), world_size=4)
    one = TM.build_mesh()  # no process group: a world of one
    assert (one.size, one.rank, one.backend, one.distributed) == (
        1, 0, None, False)
    for cfg in (MeshConfig(spatial=2), MeshConfig(time=2),
                MeshConfig(data=2, spatial=2, time=2)):
        with pytest.raises(NotImplementedError, match="item 10"):
            TM.build_mesh(cfg, world_size=8)


def test_local_rows_of_takes_the_ranks_rows_of_a_full_batch():
    """Every rank holds the whole val batch and evaluates its rows: rank
    2 of 4 takes rows 4-5 of every array, and passes the rest as it is."""
    full = {"source": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
            "label": np.arange(8), "scale": np.float32(2.0), "name": "val"}
    world = TM.World(np.arange(4).reshape(4, 1, 1), rank=2)
    got = TM.local_rows_of(full, world)
    np.testing.assert_array_equal(got["source"], full["source"][4:6])
    np.testing.assert_array_equal(got["label"], [4, 5])
    assert got["scale"] == 2.0 and got["name"] == "val"


def test_init_distributed_refuses_cuda_without_a_card(monkeypatch):
    """`cuda` without a card raises, as `core/device.py` does, from the
    library call and from `train --multihost`: no rank falls back to the
    CPU."""
    from deepof_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TM.init_distributed("cuda", env={"WORLD_SIZE": "1"})
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "--multihost", "--synthetic", "--steps", "1"])
    assert TM._STATE["backend"] is None
