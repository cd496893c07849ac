"""Process and device telemetry of the training loop (port of
`deepof_tpu/obs/telemetry.py`).

  - `process_rss_bytes`: the process's resident set, as in the JAX
    package;
  - `device_memory_summary(device)`: the caching allocator's bytes in use
    and their peak on the loop's CUDA device (`torch.cuda.memory_stats`);
    the keys are always present, None on the CPU;
  - `count_flops(fn)`: the FLOPs of one call of `fn`, counted by
    `torch.utils.flop_counter.FlopCounterMode` around that call itself,
    so counting adds no step, no update and no random draw.

What the count sees: FlopCounterMode counts the aten operators it has
formulas for, the matrix products and convolutions (forward and
backward), and nothing else. The correlation and warp kernels are ctypes
launches, the plain versions on the CPU elementwise operators, and the
loss's and Adam's elementwise work has no formula either: none of them
is counted. XLA's cost analysis, which `deepof_tpu` uses, counts every
HLO operator but does not see inside a Pallas call. The count here is
the convolutions' work; `tests/test_torch_obs.py` measures its ratio to
the JAX package's count for the same small model on the CPU.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

#: Dense bf16 peak of the card the port is measured on: the NVIDIA H100
#: SXM data sheet, 989 TFLOP/s (NVIDIA H100 80GB HBM3, 700 W). The loop's
#: `mfu_nominal` divides its model TFLOP/s by this; `chip_smoke.py` takes
#: the same figure as `PEAK_BF16_FLOPS`.
NOMINAL_BF16_TFLOPS = 989.0


def process_rss_bytes() -> int | None:
    """Resident set size of this process (Linux /proc); None elsewhere."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def device_memory_summary(device: torch.device | str | None = None) -> dict:
    """`dev_mem_bytes_in_use` and `dev_mem_peak_bytes` of `device` from
    the caching allocator (`torch.cuda.memory_stats`). Both keys are
    always present, so a record's schema does not depend on the device:
    None for a CPU (or absent) device."""
    out = {"dev_mem_bytes_in_use": None, "dev_mem_peak_bytes": None}
    if device is None or torch.device(device).type != "cuda":
        return out
    stats = torch.cuda.memory_stats(device)
    out["dev_mem_bytes_in_use"] = stats.get("allocated_bytes.all.current")
    out["dev_mem_peak_bytes"] = stats.get("allocated_bytes.all.peak")
    return out


def count_flops(fn: Callable[[], object]) -> tuple[object, int]:
    """(fn(), the FLOPs FlopCounterMode counted in that call)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, int(counter.get_total_flops())
