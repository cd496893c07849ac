"""The JAX package's halo-gradient repro (`tools/halo_grad_repro.py`) on
the port's explicit exchange (`parallel/spatial.py`).

A stride-2 SAME conv chain (3x3 convs of 4 channels with ELU, then a
linear 3x3 head of 2) is differentiated twice: on one process with the
input whole, and row-sharded over S gloo ranks (`ConvELU` with `rows`:
each conv reads its window through `exchange_rows`, each halo's
gradient is added back at its owner, the ranks' loss shares summed).
For each layer it prints the median ratio |g_sharded / g_whole| and
the relative error of the kernel gradient, in the JAX tool's format,
on the JAX tool's probes: spatial 2 and 4, the same H and depths. GSPMD
mis-scales the upstream gradients x4 at H=64 depth 5 and H=32 depth 4
over 2 shards (one row a shard at the coarsest level) and x2 in a
sub-row collapse over 4; the port's gate (`MIN_ROWS_PER_SHARD`) stays
the JAX package's whatever this tool prints, so that the same runs shard
in both packages.

    python -m deepof_tpu_torch.tools.halo_grad_repro [--device cpu|cuda]

Each spatial size is one world of S ranks (subprocesses of this tool;
on the card they share its one device over gloo, the exchange staged
through host memory). Prints the probes' lines, then one JSON line
{"probes": [...], "exact": bool}; rc 0 when every layer of every probe
agrees within 1e-3 (the JAX tool's MISMATCH flag), else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: the JAX tool's probes (spatial, H, depth), in its order
PROBES = ((2, 64, 5), (2, 32, 4), (2, 128, 5), (4, 64, 3), (4, 32, 3),
          (4, 32, 4), (2, 160, 5), (2, 80, 4), (4, 160, 4))
WIDTH = 32
MISMATCH = 1e-3


def make_stack(n_down: int, device):
    """The JAX tool's `Stack`: n_down stride-2 ELU convs and a head."""
    import torch

    from ..models.common import ConvELU, init_weights

    layers = torch.nn.ModuleDict(
        {f"c{i}": ConvELU(3 if i == 0 else 4, 4, stride=2)
         for i in range(n_down)})
    layers["head"] = ConvELU(4, 2, act=False)
    return init_weights(layers, 0).to(device)


def run(stack, x, rows=None):
    """The chain's sum of squares; `rows`: x's level, row-sharded (this
    rank's share of the loss)."""
    r = rows
    for name, layer in stack.items():
        if name == "head":
            x = layer(x, r)
        else:
            x, r = layer(x, r), (None if r is None else r.down(2))
    return (x ** 2).sum()


def probe(spatial: int, h: int, n_down: int, world, device) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..parallel.spatial import Rows, spatial_group

    stack = make_stack(n_down, device)
    x = torch.tensor(np.random.RandomState(0).rand(
        8 // spatial, h, WIDTH, 3).astype(np.float32)).permute(
            0, 3, 1, 2).contiguous().to(device)
    run(stack, x).backward()
    whole = {n: m.conv.weight.grad.detach().clone()
             for n, m in stack.items()}
    stack.zero_grad(set_to_none=False)
    run(stack, x, Rows(spatial_group(world), h, whole=True)).backward()
    flat = torch.cat([m.conv.weight.grad.reshape(-1)
                      for m in stack.values()])
    dist.all_reduce(flat)  # the shares of the loss add up to it
    layers, at = {}, 0
    for name, m in stack.items():
        n = m.conv.weight.numel()
        s = flat[at:at + n].cpu().numpy()
        at += n
        r = whole[name].reshape(-1).cpu().numpy()
        keep = np.abs(r) > 1e-6 * np.abs(r).max()
        layers[name] = {
            "ratio": float(np.median(np.abs(s[keep] / r[keep]))),
            "relerr": float(np.abs(s - r).max() / np.abs(r).max())}
    return {"spatial": spatial, "H": h, "depth": n_down,
            "coarsestH": h >> n_down, "layers": layers}


def print_probe(p: dict) -> None:
    c = p["coarsestH"]
    print(f"spatial={p['spatial']} H={p['H']} depth={p['depth']} "
          f"coarsestH={c} ({c / p['spatial']:.1f} rows/shard):", flush=True)
    for name in sorted(p["layers"]):
        r = p["layers"][name]
        flag = "  <-- MISMATCH" if r["relerr"] > MISMATCH else ""
        print(f"  {name:6s} median|g_sharded/g_repl|={r['ratio']:8.4f} "
              f"relerr={r['relerr']:.2e}{flag}", flush=True)


def rank_main(out: str, spatial: int, device: str) -> int:
    """One rank of a world of `spatial` ranks: the probes of that size,
    written by rank 0 to `out`."""
    import torch

    from ..core.config import MeshConfig
    from ..core.device import disable_tf32
    from ..parallel.mesh import (build_mesh, init_distributed,
                                 shutdown_distributed)

    disable_tf32()
    torch.set_num_threads(1)
    world = init_distributed(device, timeout_s=300)
    world = build_mesh(MeshConfig(spatial=spatial))
    rows = [probe(s, h, d, world, world.device)
            for s, h, d in PROBES if s == spatial]
    if world.rank == 0:
        with open(out, "w") as f:
            json.dump(rows, f)
    shutdown_distributed()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=None,
                    help="where the ranks write their probes (default: a "
                         "temporary directory)")
    args = ap.parse_args(argv)
    import tempfile

    from ..parallel.mesh import _free_port

    out_dir = args.out_dir or tempfile.mkdtemp(prefix="halo_grad_repro-")
    os.makedirs(out_dir, exist_ok=True)
    found = {}
    for spatial in sorted({s for s, _, _ in PROBES}):
        out = os.path.join(out_dir, f"spatial{spatial}.json")
        port = str(_free_port())
        env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, WORLD_SIZE=str(spatial),
                   LOCAL_WORLD_SIZE=str(spatial))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "deepof_tpu_torch.tools.halo_grad_repro",
             "--rank-of", out, str(spatial), args.device],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
            for r in range(spatial)]
        rcs = [p.wait(timeout=600) for p in procs]
        if any(rcs):
            raise RuntimeError(f"halo_grad_repro: spatial={spatial} ranks "
                               f"exited {rcs}")
        with open(out) as f:
            found.update({(p["spatial"], p["H"], p["depth"]): p
                          for p in json.load(f)})
    probes = [found[k] for k in PROBES]
    for p in probes:
        print_probe(p)
    exact = all(r["relerr"] <= MISMATCH for p in probes
                for r in p["layers"].values())
    print(json.dumps({"device": args.device, "probes": probes,
                      "exact": exact}), flush=True)
    return 0 if exact else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-of"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
