"""Whole-train-state checkpoints with auto-resume and verification (port
of `deepof_tpu/train/checkpoint.py` on `torch.save`).

Layout, as in the JAX package: one directory per step under the
checkpoint directory (`<log_dir>/ckpt/step_0000000012/`), holding
`state.pt` = {"step", "model" (state_dict), "optimizer" (Adam
state_dict), "updates", "mini_step", "acc" (the gradient accumulator
under `optim.grad_accum` > 1, else None)}, and a sibling manifest
(`resilience/verify.py`: size and CRC32 of every file, a digest of the
state's structure, the config digest). A save writes into a temporary
directory, renames it into place, then writes the manifest, so a step
directory without a manifest is one whose save was cut between the two
(restored unverified, as a legacy checkpoint would be) and a torn write
never has the final name.

A run saved in the middle of an accumulation resumes to the same bits.
The accumulator is part of the structure digest only when grad_accum >
1: a checkpoint written before the port carried it (no "updates",
"mini_step" or "acc") restores into a grad_accum = 1 run with updates =
step and mini_step = 0, which is what they were; into a grad_accum > 1
run it fails the structure check and is not restored, as a plain Adam
state does not restore into the JAX package's MultiSteps state.

`restore` verifies each candidate, newest first, and falls back to the
newest one that verifies and loads; a failed save degrades to a logged
warning with the previous checkpoint kept. A fault injector
(`resilience/faults.py`) may fail a save (``ckpt_save``) or a restore
(``ckpt_restore``) and damage a committed checkpoint after its manifest
is written (``ckpt_truncate`` / ``ckpt_corrupt``), as in the JAX
package. Saves are synchronous: at full width (38,777,706 float32
parameters and two Adam moments) a checkpoint is ~465 MB, a quarter more
with the accumulator.
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
import warnings
import zlib

import torch

from ..resilience import verify as ckpt_verify
from .state import TrainState

PAYLOAD = "state.pt"


def _structure_digest(model_sd: dict, optim_sd: dict,
                      acc: list | None = None) -> dict:
    """Tensor names, shapes and dtypes of the model, the optimizer's
    parameter count (its moments exist only after a first update, so
    they are not part of the structure), and the gradient accumulator's
    shapes when there is one."""
    crc = 0
    for name, t in model_sd.items():
        crc = zlib.crc32(f"{name}:{tuple(t.shape)}:{t.dtype};".encode(), crc)
    n_opt = sum(len(g["params"]) for g in optim_sd["param_groups"])
    crc = zlib.crc32(f"optimizer:{n_opt};".encode(), crc)
    n_acc = len(acc) if acc is not None else 0
    for i, t in enumerate(acc or ()):
        crc = zlib.crc32(f"acc{i}:{tuple(t.shape)}:{t.dtype};".encode(), crc)
    return {"num_leaves": len(model_sd) + n_opt + n_acc, "crc32": crc}


class CheckpointManager:
    """directory: where the step directories live.
    keep: checkpoints kept on disk (the newest committed one always
        survives a save, so keep=1 transiently holds 2).
    create: False opens read-only (no mkdir; the `train.init_from`
        source, where a typo must not leave an empty run behind).
    verify: check candidates against their manifests on restore.
    log / info_log: optional (step, message) sinks for recovery events
        and for restore provenance; `warnings.warn` without them.
    config_digest: recorded in each manifest; restore warns on a
        mismatch and proceeds (fine-tunes legitimately cross configs).
    injector: optional `resilience.faults.FaultInjector`.
    manifest_extra: a jsonable block written verbatim as ``extra`` into
        every manifest (the staged recipe's {recipe_stage,
        recipe_stage_name, stage_start_step}); `read_manifest_extra`
        gives it back without loading the payload.
    """

    def __init__(self, directory: str, keep: int = 3, create: bool = True,
                 verify: bool = True, log=None, info_log=None,
                 config_digest: str | None = None, injector=None,
                 manifest_extra: dict | None = None):
        self.directory = os.path.abspath(directory)
        self._inj = injector
        self._manifest_extra = manifest_extra
        self.keep = keep
        self._verify = verify
        self._log = log
        self._info_log = info_log
        self._config_digest = config_digest
        self._saves = 0
        self._save_failures = 0
        self._save_s_total = 0.0
        self._save_s_max = 0.0
        self._restore_failures = 0
        self._restore_fallbacks = 0
        self._verify_failures = 0
        if create:
            os.makedirs(self.directory, exist_ok=True)

    def _warn(self, step: int, message: str) -> None:
        if self._log is not None:
            self._log(step, message)
        else:
            warnings.warn(message, RuntimeWarning, stacklevel=3)

    def stats(self) -> dict[str, float]:
        """Recovery-event counters for train records and the summary, and
        the host seconds of the committed saves (total and longest)."""
        return {"saves": self._saves,
                "save_s_total": round(self._save_s_total, 4),
                "save_s_max": round(self._save_s_max, 4),
                "save_failures": self._save_failures,
                "restore_failures": self._restore_failures,
                "restore_fallbacks": self._restore_fallbacks,
                "verify_failures": self._verify_failures}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        return [s for s, _ in ckpt_verify.step_dirs(self.directory)]

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _rm(self, step: int) -> None:
        shutil.rmtree(self._path(step), ignore_errors=True)
        try:
            os.remove(ckpt_verify.manifest_path(self._path(step)))
        except OSError:
            pass

    def save(self, state: TrainState) -> str | None:
        """Write a checkpoint of `state` at `state.step`; on failure (disk
        full, ...) warn and return None, keeping the previous one."""
        t0 = time.perf_counter()
        step = int(state.step)
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        model_sd = state.model.state_dict()
        optim_sd = state.optimizer.state_dict()
        try:
            if self._inj is not None:
                self._inj.check("ckpt_save", step)
            if os.path.exists(path):
                self._rm(step)
            # prune before the write, always keeping the newest committed
            # checkpoint: if this write never commits, one survives
            for old in self.all_steps()[: -max(self.keep - 1, 1)]:
                self._rm(old)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"step": step, "model": model_sd,
                        "optimizer": optim_sd, "updates": state.updates,
                        "mini_step": state.mini_step, "acc": state.acc},
                       os.path.join(tmp, PAYLOAD))
            os.replace(tmp, path)
        except (OSError, RuntimeError) as e:
            self._save_failures += 1
            shutil.rmtree(tmp, ignore_errors=True)
            self._warn(step, f"checkpoint save failed at step {step}: "
                             f"{type(e).__name__}: {e}; previous checkpoint "
                             "retained")
            return None
        self._saves += 1
        try:
            ckpt_verify.write_manifest(path, ckpt_verify.build_manifest(
                path, step,
                structure=_structure_digest(model_sd, optim_sd, state.acc),
                cfg_digest=self._config_digest, extra=self._manifest_extra))
        except OSError as e:
            self._warn(step, f"checkpoint manifest write failed at step "
                             f"{step}: {e}; checkpoint restores unverified")
        if self._inj is not None:
            # after the manifest, so the damage is detectable, as real
            # corruption would be
            for act in self._inj.tamper_checkpoint(step, path):
                self._warn(step, f"fault injection: {act}")
        seconds = time.perf_counter() - t0
        self._save_s_total += seconds
        self._save_s_max = max(self._save_s_max, seconds)
        return path

    def _verify_candidate(self, step: int, expect: dict) -> list[str]:
        """Problems blocking a restore of `step` ([] = restorable). A
        missing manifest restores unverified: absence is not
        corruption."""
        if not self._verify:
            return []
        path = self._path(step)
        manifest = ckpt_verify.load_manifest(ckpt_verify.manifest_path(path))
        if manifest is None:
            return []
        problems = ckpt_verify.verify_files(path, manifest)
        saved = manifest.get("structure")
        if not problems and saved and saved != expect:
            problems = [f"state structure mismatch (checkpoint {saved} != "
                        f"restore template {expect})"]
        if not problems:
            digest = manifest.get("config_digest")
            if (digest and self._config_digest
                    and digest != self._config_digest):
                self._warn(step, f"checkpoint step {step} was written by a "
                                 f"different config (digest {digest} != "
                                 f"{self._config_digest}); restoring anyway")
        return problems

    def _load(self, step: int, device) -> dict:
        return torch.load(os.path.join(self._path(step), PAYLOAD),
                          map_location=device, weights_only=True)

    def restore(self, state: TrainState) -> TrainState | None:
        """Load the newest checkpoint that verifies and reads into
        `state` (model, Adam state, step, update count and accumulator,
        in place) and return it; None if none does. A candidate that
        fails verification or whose read raises is skipped with a
        warning."""
        candidates = list(reversed(self.all_steps()))
        expect = _structure_digest(state.model.state_dict(),
                                   state.optimizer.state_dict(), state.acc)
        device = next(state.model.parameters()).device
        for i, s in enumerate(candidates):
            fallback = ("trying an older checkpoint"
                        if i + 1 < len(candidates)
                        else "no older checkpoint to fall back to")
            problems = self._verify_candidate(s, expect)
            if problems:
                self._verify_failures += 1
                self._warn(s, f"checkpoint step {s} failed verification "
                              f"({'; '.join(problems[:3])}); {fallback}")
                continue
            try:
                if self._inj is not None:
                    self._inj.check("ckpt_restore", s)
                payload = self._load(s, device)
                got = _structure_digest(payload["model"],
                                        payload["optimizer"],
                                        payload.get("acc"))
                if got != expect:
                    raise ValueError(f"state structure {got} != restore "
                                     f"template {expect}")
                state.model.load_state_dict(payload["model"])
                state.optimizer.load_state_dict(payload["optimizer"])
                state.step = int(payload["step"])
                state.updates = int(payload.get("updates", state.step))
                state.mini_step = int(payload.get("mini_step", 0))
                for a, t in zip(state.acc or (), payload.get("acc") or ()):
                    a.copy_(t)
            except (OSError, RuntimeError, ValueError, KeyError, EOFError,
                    pickle.UnpicklingError) as e:
                self._restore_failures += 1
                self._warn(s, f"checkpoint restore failed at step {s}: "
                              f"{type(e).__name__}: {e}; {fallback}")
                continue
            if i > 0:
                self._restore_fallbacks += 1
            why = ("newest checkpoint" if i == 0
                   else f"fallback after corruption: {i} newer candidate(s) "
                        "failed verification/restore")
            msg = f"checkpoint restore: step {s} ({why})"
            if self._info_log is not None:
                self._info_log(s, msg)
            elif self._log is not None:
                self._log(s, msg)
            elif i > 0:
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
            return state
        return None

    def read_manifest_extra(self, step: int | None = None) -> dict | None:
        """The ``extra`` block of a committed checkpoint's manifest (the
        newest step when None); None when the checkpoint, its manifest
        or the block is absent."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        manifest = ckpt_verify.load_manifest(
            ckpt_verify.manifest_path(self._path(step)))
        extra = (manifest or {}).get("extra")
        return dict(extra) if isinstance(extra, dict) else None

    def restore_raw(self, subtree: str) -> dict | None:
        """The `subtree` entry (e.g. "model") of the newest checkpoint's
        payload, on the CPU, with no template: for `transfer_params`,
        where the structures differ. None when there is no checkpoint."""
        step = self.latest_step()
        return None if step is None else self._load(step, "cpu")[subtree]


def transfer_params(target: dict, source: dict) -> tuple[dict, int, int]:
    """Copy `source` tensors onto `target` (state_dicts) where name AND
    shape match: the cross-config fine-tune path. Returns (new target,
    tensors copied, target tensors left as they were)."""
    out, copied = {}, 0
    for name, t in target.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(t.shape):
            out[name] = src.to(dtype=t.dtype, device=t.device)
            copied += 1
        else:
            out[name] = t
    return out, copied, len(target) - copied
