"""Spatial context parallelism and temporal pair parallelism (port of
`deepof_tpu/parallel/spatial.py`).

The JAX package shards image height over the "spatial" mesh axis and
lets GSPMD partition the convolutions and insert their halo exchanges;
PyTorch has no such partitioner, so this module says by hand which rows
each rank owns at every level, which rows each layer reads from its
neighbours, and how each gradient finds its way back:

  - **The gate** (`MIN_ROWS_PER_SHARD`, `min_spatial_height`,
    `spatial_cp_active`): copied from the JAX package, so the port
    shards H exactly where JAX does (the same configs warn). Below it the
    spatial ranks of a data shard are replicas.
  - **The partition** (`row_block`): a level of n rows is split over the
    S ranks of a spatial group into GSPMD's ceil blocks, rank s owning
    rows [s c, min((s + 1) c, n)) with c = ceil(n / S).
  - **The exchange** (`exchange_rows`): every rank receives the rows
    [lo, hi) of the global level that it names (zeros outside [0, n)),
    each from its owner by point-to-point sends. Every rank computes
    every rank's window from the layer's geometry, so no sizes travel.
    Its backward sends each received row's gradient back to its owner,
    which adds it to its own. `halo_exchange` (JAX's contract: `halo`
    rows from each ring neighbour, zeros at the outer edges) and
    `all_rows` (the row gather: every rank's rows concatenated, whose
    adjoint sums each rank's cotangent back to the owner) are its
    windows.
  - **The pair split** (`pair_block`): the folded B(T-1) pair axis of a
    T-frame volume split into contiguous blocks over the "time" axis,
    under JAX's condition (no split unless (T-1) B divides by
    data x time).

Collectives: the exchange is `torch.distributed.batch_isend_irecv` on
the spatial group. NCCL (one card a rank) takes the device's tensors;
gloo's point-to-point takes CPU tensors only, so a gloo group on the
card stages each message through host memory (`.cpu()` before the send,
a host buffer for the receive, copied back to the device). The route is
decided by the group's backend and the tensor's device, named in
`SpatialGroup.staged`, and a failed send or receive raises: nothing
falls back. A message keeps its sender's dtype on either route (bf16
rows under `train.compute_dtype=bfloat16` travel as bf16, bit for bit,
and their cotangents in the dtype autograd hands the adjoint).

`STATS` counts what crossed the wire (bytes and messages, by kind:
"halo" or "gather"), and with `STATS["timed"]` set the host seconds of
each transfer to a synchronize.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

# Spatial CP gradient-safety contract (the JAX package's): every pyramid
# level keeps >= MIN_ROWS_PER_SHARD rows per spatial shard. GSPMD's
# backward halo exchange mis-scales gradients below it (x2 or x4:
# deepof_tpu/tools/halo_grad_repro.py); the port's exchange is exact
# there too (deepof_tpu_torch/tools/halo_grad_repro.py), but keeps the
# gate so that the same runs shard in both packages.
MIN_ROWS_PER_SHARD = 2

#: bytes, messages and (when "timed") host seconds of the exchanges,
#: by kind; `reset_stats` zeroes them
STATS: dict = {"timed": False}


def reset_stats() -> None:
    timed = STATS.get("timed", False)
    STATS.clear()
    STATS["timed"] = timed
    for kind in ("halo", "gather"):
        STATS.update({f"{kind}_bytes": 0, f"{kind}_messages": 0,
                      f"{kind}_calls": 0, f"{kind}_s": 0.0})


reset_stats()


def min_spatial_height(max_downsample: int, spatial: int) -> int:
    """Smallest input H for which spatial CP is gradient-safe for a model
    whose deepest level is H / max_downsample: that level must keep
    MIN_ROWS_PER_SHARD rows on each of `spatial` shards."""
    return MIN_ROWS_PER_SHARD * max_downsample * spatial


def spatial_cp_active(h: int, max_downsample: int, spatial: int) -> bool:
    """True iff sharding H over `spatial` is gradient-safe for a model
    downsampling by `max_downsample` (stride-2 SAME chain: each level is
    ceil(previous/2)): H divides by `spatial`, (a) the deepest level
    keeps >= 2 average rows per shard, and (b) its ceil partition leaves
    no shard without a row (H=520 at downsample 64 over 4: 9 rows ->
    3, 3, 3, 0, refused)."""
    if h % spatial:
        return False
    d = h
    for _ in range(max(max_downsample.bit_length() - 1, 0)):
        d = -(-d // 2)
    if d < MIN_ROWS_PER_SHARD * spatial:
        return False
    return d - (spatial - 1) * (-(-d // spatial)) > 0


def row_block(n: int, size: int, index: int) -> tuple[int, int]:
    """Rows [lo, hi) of an n-row level that rank `index` of `size` owns:
    GSPMD's ceil blocks (the last may be short or empty)."""
    c = -(-n // size)
    lo = min(index * c, n)
    return lo, min(lo + c, n)


def pair_block(batch: int, time_step: int, data: int, time_axis: int,
               index: int, local_batch: int | None = None
               ) -> tuple[int, int] | None:
    """This time rank's contiguous block [lo, hi) of the folded pair axis
    of its rows ((T-1) x the local batch; `batch` is the global batch),
    or None where JAX does not split: time axis 1, or (T-1) x batch not
    divisible by data x time (`pair_axis_constraint`)."""
    pairs = (time_step - 1) * batch
    if time_axis <= 1 or time_step < 2 or pairs % (data * time_axis):
        return None
    local = (time_step - 1) * (batch // data if local_batch is None
                               else local_batch)
    per = local // time_axis
    return index * per, (index + 1) * per


# ------------------------------------------------------------ the group


@dataclass(frozen=True, eq=False)
class SpatialGroup:
    """This rank's place on its data shard's spatial axis: `size` ranks,
    this one at `index`, `ranks` the global rank of each index (the
    world's procs[d, :, t]), `group` their process group (None: no
    process group, a group of one)."""

    size: int
    index: int
    ranks: tuple[int, ...]
    group: object = None

    def block(self, n: int) -> tuple[int, int]:
        return row_block(n, self.size, self.index)

    def blocks(self, n: int) -> list[tuple[int, int]]:
        return [row_block(n, self.size, r) for r in range(self.size)]

    def staged(self, device: torch.device) -> bool:
        """True where a message on `device` goes through host memory: a
        gloo group and a device that is not the CPU (gloo's send and
        receive take CPU tensors only)."""
        if self.group is None or torch.device(device).type == "cpu":
            return False
        import torch.distributed as dist

        return dist.get_backend(self.group) == "gloo"


@dataclass(frozen=True, eq=False)
class Rows:
    """A level of `n` global rows over `group`; `whole`: the tensor holds
    all n rows on every rank (the network's input), else this rank's
    block."""

    group: SpatialGroup
    n: int
    whole: bool = False

    @property
    def block(self) -> tuple[int, int]:
        return (0, self.n) if self.whole else self.group.block(self.n)

    def down(self, stride: int = 2) -> "Rows":
        """The level a SAME conv of `stride` makes of this one."""
        return Rows(self.group, -(-self.n // stride))


def levels(rows: Rows, depth: int) -> list[Rows]:
    """The `depth` levels of a stride-2 chain below `rows`, finest
    first."""
    out = []
    for _ in range(depth):
        rows = rows.down(2)
        out.append(rows)
    return out


# -------------------------------------------------------- point to point


def _transfer(sends: list, recvs: list, sg: SpatialGroup, kind: str,
              device: torch.device) -> list[torch.Tensor]:
    """Send each (tensor, peer index) of `sends` and receive each (shape,
    dtype, peer index) of `recvs` in one batch of point-to-point ops on
    `sg.group`; returns the received tensors on `device`."""
    import torch.distributed as dist

    if not sends and not recvs:
        return []
    stage = sg.staged(device)
    timed = STATS["timed"]
    if timed and device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    host = torch.device("cpu")
    out_bufs = [torch.empty(shape, dtype=dtype,
                            device=host if stage else device)
                for shape, dtype, _ in recvs]
    ops = [dist.P2POp(dist.isend,
                      (t.cpu() if stage else t).contiguous(),
                      sg.ranks[p], sg.group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, buf, sg.ranks[p], sg.group)
            for buf, (_, _, p) in zip(out_bufs, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    got = [b.to(device) if stage else b for b in out_bufs]
    if timed and device.type == "cuda":
        torch.cuda.synchronize(device)
    STATS[f"{kind}_s"] += time.perf_counter() - t0
    STATS[f"{kind}_calls"] += 1
    STATS[f"{kind}_messages"] += len(sends)
    STATS[f"{kind}_bytes"] += sum(t.numel() * t.element_size()
                                  for t, _ in sends)
    return got


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (0, 0)


class _Exchange(torch.autograd.Function):
    """y = rows windows[me] of the global level x (zeros outside [0, n)),
    x split over the group in `row_block`s along `axis`. Its adjoint:
    each row of y's cotangent goes back to its owner and is added
    there."""

    @staticmethod
    def forward(ctx, x, n, windows, sg, axis, kind):
        ctx.meta = (n, windows, sg, axis, kind, x.shape[axis])
        return _exchange_forward(x, n, windows, sg, axis, kind)

    @staticmethod
    def backward(ctx, g):
        n, windows, sg, axis, kind, rows = ctx.meta
        return (_exchange_backward(g.contiguous(), n, windows, sg, axis,
                                   kind, rows),
                None, None, None, None, None)


def _exchange_forward(x, n, windows, sg, axis, kind):
    me = sg.index
    blocks = sg.blocks(n)
    a, b = blocks[me]
    if x.shape[axis] != b - a:
        raise ValueError(f"exchange: rank {me} holds {x.shape[axis]} rows "
                         f"of a {n}-row level, its block is [{a}, {b})")
    lo, hi = windows[me]
    shape = list(x.shape)
    shape[axis] = hi - lo
    out = x.new_zeros(shape)
    i0, i1 = _overlap((a, b), (lo, hi))
    if i1 > i0:
        out.narrow(axis, i0 - lo, i1 - i0).copy_(
            x.narrow(axis, i0 - a, i1 - i0))
    sends, recvs, places = [], [], []
    for p in range(sg.size):
        if p == me:
            continue
        s0, s1 = _overlap((a, b), windows[p])
        if s1 > s0:
            sends.append((x.narrow(axis, s0 - a, s1 - s0), p))
        r0, r1 = _overlap(blocks[p], (lo, hi))
        if r1 > r0:
            rshape = list(x.shape)
            rshape[axis] = r1 - r0
            recvs.append((rshape, x.dtype, p))
            places.append(r0 - lo)
    for at, t in zip(places, _transfer(sends, recvs, sg, kind, x.device)):
        out.narrow(axis, at, t.shape[axis]).copy_(t)
    return out


def _exchange_backward(g, n, windows, sg, axis, kind, rows):
    me = sg.index
    blocks = sg.blocks(n)
    a, b = blocks[me]
    lo, hi = windows[me]
    shape = list(g.shape)
    shape[axis] = rows
    gx = g.new_zeros(shape)
    i0, i1 = _overlap((a, b), (lo, hi))
    if i1 > i0:
        gx.narrow(axis, i0 - a, i1 - i0).add_(g.narrow(axis, i0 - lo,
                                                       i1 - i0))
    # the rows received from p go back to p; the rows sent to p come back
    sends, recvs, places = [], [], []
    for p in range(sg.size):
        if p == me:
            continue
        r0, r1 = _overlap(blocks[p], (lo, hi))
        if r1 > r0:
            sends.append((g.narrow(axis, r0 - lo, r1 - r0), p))
        s0, s1 = _overlap((a, b), windows[p])
        if s1 > s0:
            rshape = list(g.shape)
            rshape[axis] = s1 - s0
            recvs.append((rshape, g.dtype, p))
            places.append(s0 - a)
    for at, t in zip(places, _transfer(sends, recvs, sg, kind, g.device)):
        gx.narrow(axis, at, t.shape[axis]).add_(t)
    return gx


def exchange_rows(x: torch.Tensor, n: int, windows, sg: SpatialGroup,
                  axis: int = -2, kind: str = "halo") -> torch.Tensor:
    """This rank's window of an n-row level split over `sg`: `x` holds
    this rank's `row_block` along `axis`; `windows[r]` is the [lo, hi)
    rank r reads (every rank's, so each knows what to send). Returns the
    rows windows[sg.index] of the global level, zeros outside [0, n).
    Differentiable: the adjoint adds each row's gradient at its owner."""
    axis = axis % x.dim()
    windows = tuple((int(lo), int(hi)) for lo, hi in windows)
    if len(windows) != sg.size:
        raise ValueError(f"exchange: {len(windows)} windows for a group "
                         f"of {sg.size}")
    return _Exchange.apply(x, int(n), windows, sg, axis, kind)


def take_window(x: torch.Tensor, rows: Rows, windows,
                kind: str = "halo") -> torch.Tensor:
    """Rows windows[me] of the level `rows` describes: a local slice,
    zero-padded, of a whole tensor; else the exchange."""
    if not rows.whole:
        if list(windows) == rows.group.blocks(rows.n):
            return x  # every rank reads its own block: nothing to move
        return exchange_rows(x, rows.n, windows, rows.group, -2, kind)
    lo, hi = windows[rows.group.index]
    a, b = max(lo, 0), min(hi, rows.n)
    body = x[..., a:b, :] if b > a else x[..., :0, :]
    if lo == a and hi == b:
        return body
    return torch.nn.functional.pad(body, (0, 0, a - lo, hi - b))


def all_rows(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The row gather: every rank's block of the level concatenated (the
    whole level on every rank). Its adjoint sums each rank's cotangent
    back to the owner's rows: exact where the cotangent is partial (the
    correlation keeps this rank's rows of its output), and, where the
    downstream is replicated on every rank, exact under the step's
    invariant that a replicated term enters each rank's loss divided by
    the group's size (`train/step.py`)."""
    if rows.whole:
        return x
    sg = rows.group
    return exchange_rows(x, rows.n, [(0, rows.n)] * sg.size, sg, -2,
                         "gather")


def halo_exchange(x: torch.Tensor, halo: int, group: SpatialGroup,
                  axis: int = 0) -> torch.Tensor:
    """Pad this rank's equal block with `halo` rows from each ring
    neighbour along `axis` (the JAX `halo_exchange` under `shard_map`):
    (..., rows, ...) -> (..., rows + 2 halo, ...), the outer edges'
    halos zeros. Differentiable: each halo's gradient is sent back to
    its owner and added there."""
    axis = axis % x.dim()
    c = x.shape[axis]
    if halo > c:
        raise ValueError(f"halo_exchange: halo {halo} > the block's {c} "
                         "rows (a ring neighbour holds only its block)")
    windows = [(r * c - halo, (r + 1) * c + halo) for r in range(group.size)]
    return exchange_rows(x, c * group.size, windows, group, axis, "halo")


# ------------------------------------------------------ the world's part


def spatial_group(world) -> SpatialGroup | None:
    """This rank's spatial group in `world` (`parallel/mesh.py`), None on
    a spatial axis of 1."""
    s = world.shape["spatial"]
    if s <= 1:
        return None
    d, si, t = world.coords
    return SpatialGroup(s, si, tuple(int(r) for r in world.procs[d, :, t]),
                        world.group("spatial"))


# ---------------------------------------------------- what runs sharded


def context_parallel(cfg, max_downsample: int, data: int = 1
                     ) -> tuple[bool, bool]:
    """(spatial CP on, pair split on) for `cfg` on a world of `data`
    shards: H sharded where `spatial_cp_active` passes (cfg's crop or
    image height), the volume's pairs split where `pair_block` does."""
    h = (cfg.data.crop_size or cfg.data.image_size)[0]
    spatial = (cfg.mesh.spatial > 1
               and spatial_cp_active(h, max_downsample, cfg.mesh.spatial))
    pairs = pair_block(cfg.data.batch_size, cfg.data.time_step, data,
                       cfg.mesh.time, 0) is not None
    return spatial, pairs


def check_context_parallel(cfg, model=None, data: int = 1,
                           elastic: bool = False) -> None:
    """Raise NotImplementedError, naming ROADMAP item 10, where `cfg`
    would shard rows or pairs (`context_parallel`) on a path not ported
    yet: the elastic pool (item 10.3). Every family of the registry
    (FlowNet-S and -C, FlowNet-CS, Inception-v3, VGG16Flow and the three
    UCF-101 models) shards its rows and pairs in float32 and in bf16
    compute (`train.compute_dtype=bfloat16`): the exchange and the
    gathers carry the sender's dtype, bit for bit, and the flows are
    gathered before the step casts them to float32. With the gate off
    the ranks are replicas and nothing is refused. `model`: the built
    model, or None to look its class up by `cfg.model`."""
    if cfg.mesh.spatial <= 1 and cfg.mesh.time <= 1:
        return
    from ..core.config import raise_unported

    if model is None:
        from ..models.registry import MODELS

        model = MODELS[cfg.model]
    spatial, pairs = context_parallel(
        cfg, getattr(model, "max_downsample", 64), data)
    what = (f"mesh.spatial={cfg.mesh.spatial}" if spatial
            else f"mesh.time={cfg.mesh.time}")
    todo = []
    if (spatial or pairs) and elastic:
        todo.append((f"{what} in the elastic pool", "10.3"))
    raise_unported(todo)
