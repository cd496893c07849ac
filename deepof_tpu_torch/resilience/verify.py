"""Checkpoint manifests and offline verification (copy of the stdlib
module `deepof_tpu/resilience/verify.py`, same manifest format).

`CheckpointManager` writes one manifest per committed checkpoint, and
every restore path validates against it.

Manifest (``step_XXXXXXXXXX.manifest.json``, a SIBLING of the step
directory, so the checkpoint payload itself stays untouched):

    {
      "version": 1,
      "step": 120,
      "time": 1722580000.0,
      "files": {"<relpath>": {"size": 1234, "crc32": 305419896}, ...},
      "content_crc32": 123456,          # crc over the sorted file table
      "structure": {"num_leaves": 42, "crc32": 987654},  # state digest
      "config_digest": "a1b2c3d4"       # crc of the experiment config
    }

``files`` inventories every file under the committed directory with its
size and crc32, so verification is a filesystem walk and a checksum.
``structure`` digests the train state (tensor names, shapes and dtypes)
so a same-files-different-state mismatch is also caught.
``config_digest`` ties the checkpoint to the config that wrote it
(advisory: restore warns on a mismatch and proceeds).

Writes are atomic (tmp + rename): a reader never sees a torn manifest,
and a missing manifest reads as "unverified", never as corruption.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib

MANIFEST_VERSION = 1
MANIFEST_SUFFIX = ".manifest.json"


def manifest_path(ckpt_path: str) -> str:
    """Sibling manifest file for a checkpoint step directory."""
    return ckpt_path.rstrip("/\\") + MANIFEST_SUFFIX


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def config_digest(cfg_dict) -> str:
    """Stable 8-hex-digit digest of a JSON-able config dict."""
    blob = json.dumps(cfg_dict, sort_keys=True, default=str).encode()
    return f"{zlib.crc32(blob):08x}"


def build_manifest(ckpt_path: str, step: int,
                   structure: dict | None = None,
                   cfg_digest: str | None = None,
                   extra: dict | None = None) -> dict:
    """Inventory the COMMITTED checkpoint directory. ``extra`` is an
    optional jsonable block carried verbatim; it never takes part in
    verification."""
    files: dict[str, dict] = {}
    for root, _, names in os.walk(ckpt_path):
        for nm in sorted(names):
            p = os.path.join(root, nm)
            rel = os.path.relpath(p, ckpt_path).replace(os.sep, "/")
            files[rel] = {"size": os.path.getsize(p), "crc32": file_crc32(p)}
    content = 0
    for rel in sorted(files):
        content = zlib.crc32(
            f"{rel}:{files[rel]['size']}:{files[rel]['crc32']};".encode(),
            content)
    manifest = {
        "version": MANIFEST_VERSION,
        "step": int(step),
        "time": time.time(),
        "files": files,
        "content_crc32": content,
        "structure": structure,
        "config_digest": cfg_digest,
    }
    if extra:
        manifest["extra"] = dict(extra)
    return manifest


def write_manifest(ckpt_path: str, manifest: dict) -> str:
    path = manifest_path(ckpt_path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)  # readers never see a torn manifest
    return path


def load_manifest(path: str) -> dict | None:
    """The manifest dict, or None when absent, unreadable or torn (that
    reads as unverified, not as corruption)."""
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    return m if isinstance(m, dict) and "files" in m else None


def verify_files(ckpt_path: str, manifest: dict) -> list[str]:
    """Problems of the checkpoint directory against its manifest (empty
    = intact): the directory present, every manifested file present with
    its size and crc32. Extra files are tolerated."""
    problems: list[str] = []
    if not os.path.isdir(ckpt_path):
        return [f"checkpoint directory missing: {ckpt_path}"]
    for rel, spec in sorted(manifest.get("files", {}).items()):
        p = os.path.join(ckpt_path, *rel.split("/"))
        if not os.path.isfile(p):
            problems.append(f"missing file: {rel}")
            continue
        size = os.path.getsize(p)
        if size != spec.get("size"):
            problems.append(
                f"size mismatch: {rel} ({size} != {spec.get('size')})")
            continue
        crc = file_crc32(p)
        if crc != spec.get("crc32"):
            problems.append(
                f"checksum mismatch: {rel} (crc32 {crc} != "
                f"{spec.get('crc32')})")
    return problems


def step_dirs(ckpt_dir: str) -> list[tuple[int, str]]:
    """(step, path) of each committed `step_<n>` directory, by step."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        p = os.path.join(ckpt_dir, name)
        if m and os.path.isdir(p):
            out.append((int(m.group(1)), p))
    return sorted(out)


def verify_run(path: str) -> dict:
    """Validate every checkpoint of a run. `path` is a run's log dir
    (its ``ckpt/`` subdirectory is used) or a checkpoint directory.
    Returns a jsonable report: per-checkpoint status (``ok`` /
    ``corrupt`` / ``unverified``), the problems of corrupt ones, and the
    valid/corrupt/unverified step lists. ``ok`` is False iff any
    manifested checkpoint fails its manifest."""
    sub = os.path.join(path, "ckpt")
    ckpt_dir = sub if os.path.isdir(sub) else path
    checkpoints = []
    valid, corrupt, unverified = [], [], []
    for step, p in step_dirs(ckpt_dir):
        manifest = load_manifest(manifest_path(p))
        if manifest is None:
            status, problems = "unverified", ["no manifest"]
            unverified.append(step)
        else:
            problems = verify_files(p, manifest)
            if problems:
                status = "corrupt"
                corrupt.append(step)
            else:
                status, problems = "ok", []
                valid.append(step)
        checkpoints.append({"step": step, "path": p, "status": status,
                            "problems": problems})
    return {
        "dir": os.path.abspath(ckpt_dir),
        "checkpoints": checkpoints,
        "valid_steps": valid,
        "corrupt_steps": corrupt,
        "unverified_steps": unverified,
        "ok": not corrupt,
    }
