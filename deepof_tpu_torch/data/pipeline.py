"""Deterministic per-batch random streams (port of
`deepof_tpu/data/pipeline.py::derive_batch_rng`; the input pipeline
itself is still to port, ROADMAP Queue A item 5)."""

from __future__ import annotations

import numpy as np


def derive_batch_rng(base_seed, batch_index: int,
                     salt: int = 0) -> np.random.RandomState:
    """(stream seed, batch index) -> rng, independent of the order in
    which batches are assembled. `base_seed` is an int or a uint32 array;
    base words and the index are carried as uint32 pairs, so 64-bit
    values fold in losslessly. `salt` selects a sibling stream; 0 appends
    nothing."""
    base = np.atleast_1d(np.asarray(base_seed, dtype=np.uint64))
    words = np.empty(2 * base.size + 2, np.uint32)
    words[0:-2:2] = (base & 0xFFFFFFFF).astype(np.uint32)
    words[1:-2:2] = (base >> 32).astype(np.uint32)
    idx = int(batch_index)
    words[-2] = idx & 0xFFFFFFFF
    words[-1] = (idx >> 32) & 0xFFFFFFFF
    if salt:
        s = int(salt)
        words = np.concatenate([
            words,
            np.asarray([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF], np.uint32),
        ])
    return np.random.RandomState(words)
