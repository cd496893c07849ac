"""The JAX (data, spatial, time) device mesh as a `torch.distributed`
world (port of `deepof_tpu/parallel/mesh.py`).

Axes, as in the JAX package:
  - "data":    batch data parallelism: each rank computes the gradient
               of its rows and the ranks average them (`train/step.py`);
  - "spatial": context parallelism over image height: the ranks of one
               data shard's spatial axis split each level's rows
               (`parallel/spatial.py`);
  - "time":    Sintel temporal pair parallelism: they split a volume's
               folded pairs (`losses/pyramid.py`).

Each rank owns one device. `build_mesh` lays the ranks out as the JAX
mesh lays out devices, `arange(n).reshape(data, spatial, time)`, so
rank = d S T + s T + t, and ranks that share a data coordinate are
replicas of one batch shard (they load the same rows). Over a process
group the world also holds a process group for each axis (`group`:
"spatial", the ranks of procs[d, :, t]; "time", procs[d, s, :];
"shard", procs[d] whole), made once a process, every rank making every
group in one order (`new_group` is collective).

A `World` holds the grid of ranks that own
each (data, spatial, time) slot (`procs`) and this process's rank, so
the JAX functions that read `jax.local_devices()` read "the slots whose
rank is mine" here, with the same results on the same layouts:
`process_data_coords`, `local_batch_rows` (with its span guard) and
`process_seed`. With one device a rank, rank r's data coordinate is r.

`init_distributed` joins the world that `torchrun` describes in the
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
`MASTER_ADDR`, `MASTER_PORT`): rank r runs on `cuda:(LOCAL_RANK %
torch.cuda.device_count())`, over NCCL when every rank of the host has a
card of its own and over gloo when ranks share a card (NCCL refuses two
ranks on one device) or run on the CPU. The backend is named in the
world (`World.backend`) and the trainer writes it into its first log
line, its summary and its heartbeat (`dist_backend`); nothing falls back
behind the caller's back, and `cuda` on a host without a card raises.
Besides the default group, the world keeps a gloo group for host-side
agreements (the eval's gathered outputs, the stop flag): the default
group's collectives take the device's tensors, the host group's take
CPU tensors whatever the backend.

`elastic_stream_seed` is numpy only, and this module imports torch only
inside the functions that need it: the elastic coordinator
(`train/elastic.py`) imports it without torch.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np

AXES = ("data", "spatial", "time")

#: the process's distributed state (set by `init_distributed`)
_STATE: dict = {"backend": None, "device": None, "host_group": None,
                "groups": {}}


class World:
    """procs: (data, spatial, time) array of the rank that owns each
    device slot. rank: this process's rank. `device` and `backend` are
    the process's (`init_distributed`'s; None without a process group:
    a world of one)."""

    def __init__(self, procs, rank: int = 0):
        self.procs = np.asarray(procs, dtype=np.int64)
        if self.procs.ndim != 3:
            raise ValueError(f"procs must be (data, spatial, time), got "
                             f"shape {self.procs.shape}")
        self.rank = int(rank)

    @property
    def device(self):
        """This rank's torch device (None: not placed)."""
        return _STATE["device"]

    @property
    def backend(self) -> str | None:
        """The default group's backend (None: no process group)."""
        return _STATE["backend"]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.procs.shape))

    @property
    def coords(self) -> tuple[int, int, int]:
        """(data, spatial, time) of this rank's first slot."""
        return tuple(int(i) for i in np.argwhere(self.procs == self.rank)[0])

    def group(self, axis: str):
        """The process group of this rank's line along `axis` ("spatial",
        "time") or of its data shard ("shard"); None without a process
        group (`build_mesh` makes them)."""
        d, s, t = self.coords
        ranks = {"spatial": self.procs[d, :, t], "time": self.procs[d, s, :],
                 "shard": self.procs[d].reshape(-1)}[axis]
        return _STATE["groups"].get(tuple(int(r) for r in ranks))

    @property
    def size(self) -> int:
        """Processes in the world."""
        return int(np.unique(self.procs).size)

    @property
    def num_devices(self) -> int:
        return int(self.procs.size)

    @property
    def distributed(self) -> bool:
        return self.size > 1

    @property
    def primary(self) -> bool:
        """Rank 0 alone writes checkpoints, records and visuals."""
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"World(shape={self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device!r})")


def build_mesh(cfg=None, world_size: int | None = None,
               rank: int | None = None) -> World:
    """The (data, spatial, time) world over `world_size` ranks, one
    device each (default: the process group's, else a world of one), as
    the JAX `build_mesh` lays out devices: cfg.data == -1 means every
    rank left after spatial x time, and a world whose size is not data x
    spatial x time raises ValueError. Over a process group (and
    `world_size` its own) the axes' groups are made (`World.group`)."""
    from ..core.config import MeshConfig

    cfg = cfg or MeshConfig()
    group_size, group_rank = _group()
    n = group_size if world_size is None else int(world_size)
    r = group_rank if rank is None else int(rank)
    spatial, time = max(cfg.spatial, 1), max(cfg.time, 1)
    if n % (spatial * time):
        raise ValueError(
            f"{n} devices not divisible by spatial*time={spatial * time}")
    data = n // (spatial * time) if cfg.data == -1 else cfg.data
    if data * spatial * time != n:
        raise ValueError(f"mesh {data}x{spatial}x{time} != {n} devices")
    procs = np.arange(n).reshape(data, spatial, time)
    if _STATE["backend"] is not None and n == group_size and n > 1:
        _make_groups(procs)
    return World(procs, r)


def _make_groups(procs: np.ndarray) -> None:
    """Every axis line's process group and every data shard's, each made
    once a process, all ranks in one order (`new_group` is collective:
    every rank makes every group, its own or not)."""
    import torch.distributed as dist

    data, spatial, time = procs.shape
    lines = []
    if spatial > 1:
        lines += [procs[d, :, t] for d in range(data) for t in range(time)]
    if time > 1:
        lines += [procs[d, s, :] for d in range(data) for s in range(spatial)]
    if spatial * time > 1:
        lines += [procs[d].reshape(-1) for d in range(data)]
    for line in lines:
        key = tuple(int(r) for r in line)
        if key not in _STATE["groups"]:
            _STATE["groups"][key] = dist.new_group(list(key))


def current_world() -> World:
    """The process group's world, all ranks on the data axis."""
    return build_mesh()


def _group() -> tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    if _STATE["backend"] is None:
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


def process_data_coords(world: World) -> list[int]:
    """Sorted "data"-axis coordinates with a slot of this rank."""
    return sorted(d for d in range(world.procs.shape[0])
                  if (world.procs[d] == world.rank).any())


def local_batch_rows(world: World, global_batch: int) -> tuple[int, list[int]]:
    """(local batch size, owned global row indices) of this rank: the
    batch is split into contiguous row blocks in data-coordinate order,
    and a rank's rows are the blocks of its coordinates.

    When a data coordinate's slots span several ranks those ranks are
    replicas of that batch shard and must load identical rows
    (`process_seed` gives them one stream). A rank that owns several
    coordinates of which some span ranks is rejected, as in JAX: its
    replica peers would load different rows."""
    data = world.shape["data"]
    if global_batch % data:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {data}")
    per = global_batch // data
    coords = process_data_coords(world)
    spans = [d for d in coords if (world.procs[d] != world.rank).any()]
    if spans and len(coords) > 1:
        raise ValueError(
            f"data coords {spans} span processes while this process owns "
            f"{coords}: replica peers would load different rows. Pick a "
            "mesh where spatial*time divides the per-host device count")
    rows = [r for d in coords for r in range(d * per, (d + 1) * per)]
    return len(rows), rows


def global_rows(world: World, local_rows: int) -> int:
    """The global batch that `local_rows` rows of this rank imply."""
    n_coords = len(process_data_coords(world))
    if local_rows % max(n_coords, 1):
        raise ValueError(f"local batch {local_rows} not divisible by "
                         f"owned data coords {n_coords}")
    return (local_rows // max(n_coords, 1)) * world.shape["data"]


def process_seed(world: World, seed: int) -> int:
    """The rank's data-sampling seed: decorrelated across data shards,
    identical for replicas of one coordinate."""
    coords = process_data_coords(world)
    return seed + (min(coords) if coords else 0)


def elastic_stream_seed(seed: int, host_index: int, num_hosts: int,
                        generation: int, start_step: int) -> np.ndarray:
    """Base seed of one elastic trainer host's data stream
    (`train/elastic.py`), a copy of the JAX function: the seed as a
    64-bit word pair, then host, world size, generation and the resume
    step, as uint32 words (MT19937 `init_by_array` through
    `data/pipeline.py::derive_batch_rng`). Any differing component gives
    an unrelated stream, and the six words never collide with
    `data_stream_seed`'s two. `host_index` is an identity and may exceed
    `num_hosts`: survivors keep their index across re-forms."""
    if int(host_index) < 0 or int(num_hosts) < 1:
        raise ValueError(f"invalid elastic identity: host_index "
                         f"{host_index}, num_hosts {num_hosts}")
    s = int(seed)
    return np.array([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF,
                     int(host_index), int(num_hosts), int(generation),
                     int(start_step)], dtype=np.uint32)


# ------------------------------------------------------------- placement


def local_rows_of(batch: dict, world: World) -> dict:
    """This rank's rows of a batch every rank holds whole (the val
    batch). With `train/step.py::batch_to_device`, which stages a rank's
    own rows on its own device, this stands for the JAX `put_global` and
    `put_global_from_full`: no batch crosses ranks."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim:
            _, rows = local_batch_rows(world, v.shape[0])
            v = v[rows]
        out[k] = v
    return out


# ----------------------------------------------------------- collectives


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device: str = "cuda", env: dict | None = None,
                     timeout_s: float = 1800.0) -> World:
    """Join the process group that `torchrun` describes in `env`
    (default `os.environ`; without `WORLD_SIZE`, a world of one on a
    free local port) and return the world. Rank r runs on
    `cuda:(LOCAL_RANK % torch.cuda.device_count())`; the backend is NCCL
    when the host has a card for each of its ranks, else gloo, and gloo
    on the CPU. `cuda` without a card raises."""
    import torch
    import torch.distributed as dist

    env = os.environ if env is None else env
    size = int(env.get("WORLD_SIZE", 1))
    rank = int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    addr = env.get("MASTER_ADDR", "127.0.0.1")
    port = env.get("MASTER_PORT")
    if port is None:
        if size > 1:
            raise ValueError("init_distributed: WORLD_SIZE > 1 without "
                             "MASTER_PORT; launch with torchrun")
        port = _free_port()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the ranks on the CPU")
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= n else "gloo"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    # host-side agreements take CPU tensors: NCCL's default group cannot
    host = (dist.new_group(backend="gloo") if backend != "gloo"
            else dist.group.WORLD)
    _STATE.update(backend=backend, device=dev, host_group=host)
    return current_world()


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if _STATE["backend"] is None:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(backend=None, device=None, host_group=None, groups={})


def all_reduce_mean_(tensors: list, world: World) -> None:
    """Sum `tensors` (one dtype, on the rank's device) over each data
    shard's spatial x time ranks and average the shards, in place, with
    one all_reduce of a flat buffer over the world divided by the data
    axis (`train/step.py`'s invariant: a shard's ranks hold shares of
    its loss that add up to it). With spatial and time 1 that is the
    mean over the ranks. It runs whenever there is a process group, a
    world of one included (an identity there: the route is exercised,
    the bits kept)."""
    if world.backend is None or not tensors:
        return
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(world.shape["data"])
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def broadcast_(tensors: list, world: World, src: int = 0) -> None:
    """Overwrite `tensors` on every rank with rank `src`'s, one flat
    broadcast (whenever there is a process group)."""
    if world.backend is None or not tensors:
        return
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def host_barrier(world: World) -> None:
    """Block until every rank reaches it (the host group: a device
    collective may return before it has run)."""
    if world.distributed:
        import torch.distributed as dist

        dist.barrier(group=_STATE["host_group"])


def any_rank(flag: bool, world: World) -> bool:
    """True on every rank when `flag` is true on any (the host group)."""
    if not world.distributed:
        return bool(flag)
    import torch
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE["host_group"])
    return bool(t.item())


def shard_leaders(world: World) -> list[int]:
    """The first rank of each data shard, in data order (a shard's
    spatial x time ranks are replicas of its rows)."""
    return [int(world.procs[d, 0, 0]) for d in range(world.shape["data"])]


def gather_rows(x: np.ndarray, world: World) -> np.ndarray:
    """Every data shard's `x` (one shape on every rank; its leader's)
    concatenated in data order along the leading axis, on every rank
    (the host group)."""
    if not world.distributed:
        return x
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(x))
    parts = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(parts, t, group=_STATE["host_group"])
    return torch.cat([parts[r] for r in shard_leaders(world)]).numpy()


def mean_over_ranks(value: float, world: World) -> float:
    """The mean of a host float over the data shards (each shard's
    leader's value; the host group)."""
    if not world.distributed:
        return float(value)
    import torch
    import torch.distributed as dist

    lead = world.rank in shard_leaders(world)
    t = torch.tensor([float(value) if lead else 0.0], dtype=torch.float64)
    dist.all_reduce(t, group=_STATE["host_group"])
    return float(t.item()) / world.shape["data"]
