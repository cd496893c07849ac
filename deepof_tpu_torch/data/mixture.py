"""Deterministic weighted multi-dataset mixing (port of
`deepof_tpu/data/mixture.py`): the data half of the staged training
recipes the reference ships as three disjoint trainers (Chairs pairs,
Sintel volumes, UCF-101 two-stream).

`MixtureDataset` wraps N member datasets behind the same dataset
protocol: each `sample_train` call folds the member CHOICE out of the
per-batch rng the caller passes in (`derive_batch_rng(seed,
batch_index)`, data/pipeline.py), then delegates the draw to the chosen
member with the SAME rng. The whole mixed batch is therefore a pure
function of the batch index: the mixed stream is bit-identical for any
`data.num_workers` and `steps_per_call` regrouping, and the member
chosen for a batch index is the JAX package's (one `random_sample()`
of the same numpy rng).

Member batches are structurally validated at BUILD time, not mid-run: a
T=2 Sintel volume batch is normalized to the pair form ({source,
target, flow}) Chairs emits, and any remaining disagreement on keys,
per-sample shapes, dtypes, or implied time_step raises a ValueError
naming the recipe stage and both members.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core.config import DataConfig, StageConfig


def normalize_batch(batch: dict) -> dict:
    """Canonical batch form shared by mixture members: a T=2 volume
    ((B, H, W, 6) frames + (B, H, W, 2) flow) becomes the pair form
    {source, target, flow} FlyingChairs emits, so Chairs pairs and
    2-frame Sintel windows mix structurally. T > 2 volumes pass
    through untouched (every member must then be volume-form)."""
    vol = batch.get("volume")
    if vol is not None and vol.ndim == 4 and vol.shape[-1] == 6:
        out = {k: v for k, v in batch.items() if k != "volume"}
        out["source"] = np.ascontiguousarray(vol[..., :3])
        out["target"] = np.ascontiguousarray(vol[..., 3:])
        return out
    return batch


def batch_structure(batch: dict) -> dict[str, tuple]:
    """{key -> (per-sample shape, dtype, implied time_step)} of one
    normalized batch — the structural signature members must agree on
    (the batch axis is dropped: members may be probed at any size)."""
    out: dict[str, tuple] = {}
    for k in sorted(batch):
        v = np.asarray(batch[k])
        shape = tuple(int(s) for s in v.shape[1:])
        if k == "volume":
            t = shape[-1] // 3 if shape else 0
        elif k in ("source", "target"):
            t = 2
        else:
            t = None
        out[k] = (shape, str(v.dtype), t)
    return out


class MixtureDataset:
    """Weighted deterministic mixture of member datasets behind the
    dataset protocol (datasets.py).

    Train draws pick one member per batch (weight-proportional, folded
    from the caller's rng) and delegate with that same rng; val
    delegates entirely to the DOMINANT member (highest weight, first on
    ties) — eval AEE tracks the mixture's primary objective instead of
    averaging incomparable protocols. `mean` is the weight-averaged
    member mean so preprocessing is identical whichever member a batch
    came from (the train step subtracts ONE mean).
    """

    def __init__(self, members: list, weights: list[float],
                 names: list[str], stage: str = ""):
        if not members or len(members) != len(weights) \
                or len(members) != len(names):
            raise ValueError(
                f"recipe stage {stage!r}: mixture needs parallel "
                f"members/weights/names, got {len(members)}/"
                f"{len(weights)}/{len(names)}")
        if any(w <= 0 for w in weights):
            raise ValueError(
                f"recipe stage {stage!r}: mixture weights must be "
                f"positive, got {weights}")
        self.members = list(members)
        self.names = list(names)
        self.stage = stage
        total = float(sum(weights))
        self.weights = [float(w) / total for w in weights]
        # cumulative bounds for the single uniform draw per batch
        self._cum = np.cumsum(self.weights)
        self._validate_members()
        self.num_train = sum(int(m.num_train) for m in self.members)
        # eval protocol: the dominant member owns the val split
        self._primary = int(max(range(len(self.members)),
                                key=lambda i: self.weights[i]))
        self.num_val = int(self.members[self._primary].num_val)
        self.mean = sum(
            w * np.asarray(m.mean, dtype=np.float64)
            for w, m in zip(self.weights, self.members)).astype(np.float32)
        # draws-by-member counters (obs/registry.py recipe_draws_by_
        # dataset): pipeline workers call sample_train concurrently
        self._lock = threading.Lock()
        self._draws = {n: 0 for n in self.names}

    # ------------------------------------------------------- validation
    def _validate_members(self) -> None:
        """Loud build-time structure agreement check: every member is
        probed for one normalized sample
        and any disagreement on keys / per-sample shape / dtype /
        implied time_step raises, naming the stage and both members —
        a mixed recipe must fail at build, not mid-run."""
        ref_sig = ref_name = None
        for name, member in zip(self.names, self.members):
            # probe rng is local: member probing must not perturb the
            # training stream (sample_train is pure in the rng)
            batch = normalize_batch(
                member.sample_train(1, rng=np.random.RandomState(0)))
            sig = batch_structure(batch)
            if ref_sig is None:
                ref_sig, ref_name = sig, name
            elif sig != ref_sig:
                where = (f"recipe stage {self.stage!r}" if self.stage
                         else "mixture")
                raise ValueError(
                    f"{where}: mixture members disagree on sample "
                    f"structure/time_step — {ref_name!r} yields "
                    f"{ref_sig} but {name!r} yields {sig}; align the "
                    f"stage's image_size/time_step (or the members' "
                    f"overrides) so every member produces identical "
                    f"per-sample shapes")

    # --------------------------------------------------------- sampling
    def _pick(self, rng) -> int:
        """Member index from ONE uniform draw of the per-batch rng —
        the choice (and everything after it) is pure in the batch
        index, so any worker count replays the identical stream."""
        u = rng.random_sample()
        return int(np.searchsorted(self._cum, u, side="right").clip(
            0, len(self.members) - 1))

    def sample_train(self, batch_size, iteration=None, rng=None):
        if rng is None:
            rng = np.random.RandomState(iteration)
        idx = self._pick(rng)
        with self._lock:
            self._draws[self.names[idx]] += 1
        batch = self.members[idx].sample_train(batch_size,
                                               iteration=iteration,
                                               rng=rng)
        return normalize_batch(batch)

    def sample_val(self, batch_size, batch_id):
        return normalize_batch(
            self.members[self._primary].sample_val(batch_size, batch_id))

    def cache_stats(self) -> dict:
        out = {"hits": 0, "misses": 0, "evictions": 0}
        for m in self.members:
            s = m.cache_stats()
            for k in out:
                out[k] += int(s.get(k, 0))
        return out

    def mixture_stats(self) -> dict:
        """The registry-declared recipe mixture block: cumulative
        draws per member dataset name (kind: map, summed key-wise)."""
        with self._lock:
            return {"recipe_draws_by_dataset": dict(self._draws)}


def build_mixture(data_cfg: DataConfig, stage: StageConfig):
    """Build a stage's mixture dataset from its member configs.

    `data_cfg` is the STAGE-resolved DataConfig (image_size/time_step
    overrides already applied by train/recipe.py); each member inherits
    it and overrides only dataset identity, path, sintel_pass, and
    time_step. A single-member mixture degenerates to that member's
    dataset wrapped for the counters — same code path, no special case.
    """
    from .datasets import build_dataset

    if not stage.mixture:
        raise ValueError(f"recipe stage {stage.name!r}: empty mixture — "
                         f"declare at least one member")
    members, weights, names = [], [], []
    for m in stage.mixture:
        dcfg = dataclasses.replace(
            data_cfg,
            dataset=m.dataset,
            data_path=m.data_path or data_cfg.data_path,
            sintel_pass=m.sintel_pass or data_cfg.sintel_pass,
            time_step=m.time_step or data_cfg.time_step)
        members.append(build_dataset(dcfg))
        weights.append(float(m.weight))
        names.append(m.dataset)
    return MixtureDataset(members, weights, names, stage=stage.name)
