"""`python -m deepof_tpu_torch train|eval|predict|config` (see cli.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
