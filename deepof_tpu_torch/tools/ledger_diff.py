"""Diff a run's executable ledger against a baseline ledger (port of the
JAX package's `tools/ledger_diff.py`).

Each executable's first call writes a row (`obs/ledger.py`: the op-trace
fingerprint, first-call seconds, libraries built or found, FLOPs, bytes,
memory) to ``<log_dir>/ledger.jsonl``. This tool compares a run's rows
with a baseline's, per executable name, and fails with exit code 8, the
code `tail --ledger-baseline` gives for the same verdict, on:

  - fingerprint drift: the computation changed (a config edit, another
    torch, CUDA or cuDNN, a rebuilt kernel library);
  - unexpected recompiles: the baseline found its libraries built and
    this run built one;
  - first-call blowups: compile_s past max(--compile-floor-s, baseline *
    --compile-factor);
  - memory growth: argument + output + temp bytes past baseline *
    --memory-factor.

New or missing names are reported but never fail. rc 0 clean, 8 on
drift, 1 on an unreadable or empty ledger. Torch-free:

    python -m deepof_tpu_torch.tools.ledger_diff --baseline BASE.jsonl \
        --run /runs/c1
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs.ledger import (DEFAULT_COMPILE_FACTOR, DEFAULT_COMPILE_FLOOR_S,
                          DEFAULT_MEMORY_FACTOR, diff_ledgers, load_ledger)

#: the exit code on drift: `tail`'s for a failed ledger verdict
RC_DRIFT = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepof_tpu_torch.tools.ledger_diff",
        description="diff a run's executable ledger against a baseline "
                    "(rc 0 clean, 8 on drift, 1 usage error)")
    ap.add_argument("--baseline", required=True,
                    help="baseline ledger.jsonl (or a run dir holding one)")
    ap.add_argument("--run", required=True,
                    help="the run's ledger.jsonl (or its --log-dir)")
    ap.add_argument("--compile-factor", type=float,
                    default=DEFAULT_COMPILE_FACTOR,
                    help="first-call blowup bound: fail when compile_s > "
                         "max(floor, baseline * FACTOR) "
                         "(default %(default)s)")
    ap.add_argument("--compile-floor-s", type=float,
                    default=DEFAULT_COMPILE_FLOOR_S,
                    help="the blowup floor in seconds: below it no "
                         "first-call time fails (default %(default)s)")
    ap.add_argument("--memory-factor", type=float,
                    default=DEFAULT_MEMORY_FACTOR,
                    help="memory-growth bound: fail when arg+out+temp "
                         "bytes > baseline * FACTOR (default %(default)s)")
    ap.add_argument("--json-indent", type=int, default=None)
    args = ap.parse_args(argv)

    try:
        baseline = load_ledger(args.baseline)
        run = load_ledger(args.run)
    except OSError as e:
        print(f"ledger_diff: {e}", file=sys.stderr)
        return 1
    for rows, path in ((baseline, args.baseline), (run, args.run)):
        if not rows:
            print(f"ledger_diff: no ledger rows in {path!r}",
                  file=sys.stderr)
            return 1
    verdict = diff_ledgers(baseline, run,
                           compile_factor=args.compile_factor,
                           compile_floor_s=args.compile_floor_s,
                           memory_factor=args.memory_factor)
    print(json.dumps(verdict, indent=args.json_indent))
    return RC_DRIFT if verdict["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
