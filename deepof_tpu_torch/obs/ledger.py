"""The executable ledger (port of `deepof_tpu/obs/ledger.py`): one row
per executable function, as the card ran it the first time, appended to
``<log_dir>/ledger.jsonl``, and the drift verdict of a run's ledger
against a baseline (`diff_ledgers`: `tail`'s exit code 8 and
`tools/ledger_diff.py`).

What an executable is here. The JAX package lowers each function to
StableHLO and compiles it with XLA, and a row describes one lowering.
This package compiles nothing per call: it runs eager PyTorch over
cuDNN and three CUDA libraries, each built once under a hash of its
source (`ops/cuda/build.py::library_path`). So a row describes ONE CALL
of an executable function (a train step, an eval step, one serving
forward per (bucket, tier, mode), the quality scorer per bucket) the
first time the process ran it. The row has exactly the JAX `ROW_KEYS`,
so the JAX package's `load_ledger` and `diff_ledgers` read a ledger of
this package. The fields:

  fingerprint, hlo_chars  the analogue of the StableHLO text is the
      call's normalized op trace: a `TorchDispatchMode` writes each aten
      overload with its tensor arguments' shapes, dtypes, strides and
      device type, its other arguments, and its results' tensors (a
      result that is not a tensor, such as `.item()`'s number, is data
      and goes in by its type alone); the CUDA kernels' launches,
      which the mode cannot see (ctypes), are folded in where they
      happen with their plans (`ops/cuda/build.py::LaunchCounter.add`);
      then the 16-hex hash of each library the call launched from, and
      the torch, CUDA and cuDNN versions and the card's capability.
      `fingerprint` is the sha256 of that text (16 hex, as in JAX),
      `hlo_chars` its length. No data pointer, tensor id or object id
      goes in: the same config and shapes give the same fingerprint in
      every process, and a change of the computation changes it.
  compile_s, compile_kind, cache_*  the only compile is a library
      build. `cache_requests` counts the libraries the call launched
      from, `cache_misses` those this process built during the call,
      `cache_hits` the rest (found built); `cache_verdict` is "miss"
      when any was built, else "hit" (None on the CPU, which builds
      none). `compile_s` is the call's wall time to its end on the
      device, builds and the trace included; `compile_kind` is
      "first_step". So `unexpected_recompiles` fires on this package's
      real cold-start regression: a library rebuilt that the baseline
      found built.
  flops, bytes_accessed, arith_intensity, roofline_s  `flops` is
      `FlopCounterMode`'s count in the same pass (convolutions and
      matrix products: `obs/telemetry.py`). `bytes_accessed` is NOMINAL:
      the sum of every traced op's tensor input and output bytes, views
      included, with no cache model. `roofline_s` = flops at
      `obs/telemetry.py::NOMINAL_BF16_TFLOPS`.
  argument_bytes, output_bytes, num_args  the call's tensor inputs (the
      parameters, the optimizer's moments and the batch of a train step;
      the batch of a forward) and outputs.
  temp_bytes  the allocator's peak over the call less what was
      allocated before it (the peak statistic is reset at the call's
      start); None on the CPU.
  code_bytes  the sizes of the libraries' `.so` files; None without one.
  alias_bytes, donated_args  None: PyTorch donates no buffer.
  resolve_s  None on a traced first call; the artifact plane's rows
      below carry the seconds of their store lookup.

The artifact plane (`serve/artifacts.py`) writes three more kinds of
row, with JAX's `compile_kind` and `cache_verdict` values:

  record_aot  "aot": `warmup`'s traced first call of an executable, the
      row a store entry is published from. With a store it also looks
      the traced fingerprint up there (`ArtifactStore.fetch`): a hit is
      compile_kind "artifact", cache_verdict "artifact_hit" (the store
      holds this computation, with libraries built from this checkout's
      sources), and `exec_artifact_*` count hits, misses and rejects. A
      fetch by fingerprint loads nothing here: the libraries a call
      launches were installed before it (`fetch_libraries`), since a
      call cannot be traced without them.
  record_index  compile_kind "artifact", cache_verdict "index_hit": an
      entry resolved through the store's index with no trace; its
      fingerprint is the index's, and the call runs untraced
      (`exec_index_*`, and one `exec_deep_verify_pending` a hit).
  note_deep_verify  the engine's re-trace of an index-resolved entry,
      compile_kind "deep_verify", cache_verdict "deep_verify_ok" or
      "deep_verify_demoted" (`exec_deep_verify_ok`/`_demoted`).

`diff_ledgers` never counts an "artifact" or "deep_verify" row as a
recompile, on either side. A library fetch that rejects (`serve/
artifacts.py::ArtifactStore.fetch_libraries`) counts in
`exec_artifact_rejects` too (`note_library_fetch`).

What the ledger does not see: cuDNN's choice of algorithms (below the
aten level), and a kernel whose launch plan is equal but whose source
changed only where the hash of its library shows it.

Import discipline: stdlib-only at import (`analyze`, `tail` and
`tools/ledger_diff.py` import this without torch); torch is imported
inside the recording helpers, which run beside a call on the device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable

#: Ledger schema version (rows carry it), as the JAX package's.
LEDGER_SCHEMA = 1

#: Every row carries exactly these keys (None where a field has no
#: counterpart): the JAX package's schema.
ROW_KEYS = (
    "kind", "schema", "name", "time", "backend", "fingerprint",
    "hlo_chars", "compile_s", "resolve_s", "compile_kind", "cache_requests",
    "cache_hits", "cache_misses", "cache_verdict", "flops",
    "bytes_accessed", "arith_intensity", "roofline_s", "argument_bytes",
    "output_bytes", "temp_bytes", "alias_bytes", "code_bytes",
    "donated_args", "num_args",
)


def exec_name(bucket: tuple[int, int], tier: str, mode: str) -> str:
    """The ledger name of a serving executable:
    ``serve:<H>x<W>:<tier>:<mode>``."""
    return f"serve:{bucket[0]}x{bucket[1]}:{tier}:{mode}"


def quality_exec_name(bucket: tuple[int, int]) -> str:
    """The ledger name of a bucket's quality scorer: ``quality:<H>x<W>``."""
    return f"quality:{bucket[0]}x{bucket[1]}"


# ------------------------------------------------------------- tracing
def _arg_text(a, out: list, tensors: list) -> None:
    """Append `a`'s normalized text to `out` and its tensors to
    `tensors`: a tensor by dtype, shape, stride and device type; a
    number, string or None by repr; a dtype, layout or memory format by
    name; a device by type; anything else by its type's name alone (a
    generator's repr holds an address)."""
    import torch

    if isinstance(a, torch.Tensor):
        tensors.append(a)
        out.append(f"T[{str(a.dtype)[6:]}{tuple(a.shape)}"
                   f"{tuple(a.stride()) if a.layout == torch.strided else ''}"
                   f"{a.device.type}]")
    elif a is None or isinstance(a, (bool, int, float, str)):
        out.append(repr(a))
    elif isinstance(a, (list, tuple)):
        out.append("(")
        for x in a:
            _arg_text(x, out, tensors)
            out.append(",")
        out.append(")")
    elif isinstance(a, torch.device):
        out.append(f"dev:{a.type}")
    elif isinstance(a, (torch.dtype, torch.layout, torch.memory_format)):
        out.append(str(a))
    else:
        out.append(f"<{type(a).__name__}>")


_MODE_CLASS: list = []


def _trace_mode_class():
    """The dispatch mode class that writes the op trace (built once,
    at the first trace: torch is imported here, not at import)."""
    if _MODE_CLASS:
        return _MODE_CLASS[0]
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpTrace(TorchDispatchMode):
        """Hashes each aten call and kernel launch of its thread (and of
        autograd's device threads, which inherit the mode) into one
        sha256; counts the text's characters, the ops' nominal bytes,
        the libraries launched from, and its own seconds."""

        def __init__(self):
            super().__init__()
            self.h = hashlib.sha256()
            self.chars = 0
            self.bytes = 0
            self.sources: dict[str, None] = {}
            self.self_s = 0.0
            self._lock = threading.Lock()

        def _add(self, text: str) -> None:
            with self._lock:
                self.h.update(text.encode())
                self.chars += len(text)

        def note_launch(self, name: str, source: str, plan: tuple) -> None:
            self.sources[source] = None
            self._add(f"launch {name}{plan!r}\n")

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            t0 = time.perf_counter()
            parts: list[str] = [str(func), "("]
            tensors: list = []
            _arg_text(args, parts, tensors)
            if kwargs:
                _arg_text(sorted(kwargs.items()), parts, tensors)
            t1 = time.perf_counter()
            res = func(*args, **kwargs)
            t2 = time.perf_counter()
            parts.append(")->")
            # the result's tensors by their metadata, and nothing of its
            # other values: `.item()`'s number is data
            for r in (res if isinstance(res, (list, tuple)) else [res]):
                if isinstance(r, torch.Tensor):
                    _arg_text(r, parts, tensors)
                else:
                    parts.append(f"<{type(r).__name__}>")
            parts.append("\n")
            self._add("".join(parts))
            with self._lock:
                self.bytes += sum(t.nbytes for t in tensors)
                self.self_s += (t1 - t0) + (time.perf_counter() - t2)
            return res

    _MODE_CLASS.append(OpTrace)
    return OpTrace


def _tensors(obj, found: dict) -> None:
    """The distinct tensors and numpy arrays of a nest of dicts, lists
    and tuples, by id (a parameter passed twice counts once)."""
    import numpy as np
    import torch

    if isinstance(obj, (torch.Tensor, np.ndarray)):
        found[id(obj)] = obj
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, found)


def _environment(device, sources: list[str]) -> tuple[str, int | None]:
    """The trace's tail: each library's 16-hex hash, the torch, CUDA and
    cuDNN versions and the card's capability; and the libraries' bytes
    (None without a library)."""
    import torch

    lines, code = [], None
    if sources:
        from ..ops.cuda.build import library_path

        code = 0
        for src in sorted(sources):
            path = library_path(src)
            lines.append(f"library {src} {path.stem.rsplit('-', 1)[-1]}")
            if path.exists():
                code += path.stat().st_size
    cap = (torch.cuda.get_device_capability(device)
           if device.type == "cuda" else None)
    lines.append(f"torch {torch.__version__} cuda {torch.version.cuda} "
                 f"cudnn {torch.backends.cudnn.version()} capability {cap}")
    return "\n".join(lines) + "\n", code


def trace_call(fn: Callable[[], Any], device, inputs=(),
               count_flops: bool = True) -> tuple[Any, dict]:
    """Run `fn()` once under the op trace (and `FlopCounterMode` when
    `count_flops`) and return (its result, the row's measured fields:
    fingerprint, hlo_chars, compile_s, cache, flops, bytes_accessed,
    argument_bytes, output_bytes, temp_bytes, code_bytes, num_args,
    trace_s). `inputs` are the call's tensor inputs (any nest)."""
    import torch

    from ..ops.cuda import build

    device = torch.device(device)
    cuda = device.type == "cuda"
    built_before = len(build.built_names())
    if cuda:
        torch.cuda.synchronize(device)
        allocated = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    from torch.utils.flop_counter import FlopCounterMode

    mode = _trace_mode_class()()
    counter = FlopCounterMode(display=False) if count_flops else None
    t0 = time.perf_counter()
    with build.tracing(), counter or contextlib.nullcontext(), mode:
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    built = build.built_names()[built_before:]
    sources = list(mode.sources)
    env, code = _environment(device, sources)
    mode._add(env)
    ins: dict = {}
    outs: dict = {}
    _tensors(inputs, ins)
    _tensors(out, outs)
    misses = sum(1 for s in sources if s in built)
    fields = {
        "fingerprint": mode.h.hexdigest()[:16],
        "hlo_chars": mode.chars,
        "compile_s": wall,
        "cache": ({"requests": len(sources), "hits": len(sources) - misses,
                   "misses": misses} if sources else None),
        "flops": (float(counter.get_total_flops())
                  if counter is not None else None),
        "bytes_accessed": float(mode.bytes),
        "argument_bytes": sum(t.nbytes for t in ins.values()),
        "output_bytes": sum(t.nbytes for t in outs.values()),
        "temp_bytes": (torch.cuda.max_memory_allocated(device) - allocated
                       if cuda else None),
        "code_bytes": code,
        "num_args": len(ins),
        "trace_s": mode.self_s,
        "sources": sorted(sources),
    }
    return out, fields


def exec_row(name: str, fields: dict, backend: str | None) -> dict:
    """One ledger row of `ROW_KEYS` from `trace_call`'s fields."""
    from .telemetry import NOMINAL_BF16_TFLOPS

    row: dict[str, Any] = {k: None for k in ROW_KEYS}
    row.update({"kind": "exec", "schema": LEDGER_SCHEMA, "name": name,
                "time": round(time.time(), 3), "backend": backend,
                "fingerprint": fields["fingerprint"],
                "hlo_chars": fields["hlo_chars"],
                "compile_s": round(float(fields["compile_s"]), 4),
                "compile_kind": "first_step"})
    cache = fields.get("cache")
    if cache:
        for k in ("requests", "hits", "misses"):
            row[f"cache_{k}"] = cache[k]
        row["cache_verdict"] = "miss" if cache["misses"] else "hit"
    flops, byt = fields.get("flops"), fields.get("bytes_accessed")
    if flops:
        row["flops"] = flops
        row["roofline_s"] = flops / (NOMINAL_BF16_TFLOPS * 1e12)
    if byt:
        row["bytes_accessed"] = byt
    if flops and byt:
        row["arith_intensity"] = round(flops / byt, 3)
    for k in ("argument_bytes", "output_bytes", "temp_bytes", "code_bytes",
              "num_args"):
        row[k] = fields.get(k)
    return row


class ExecutableLedger:
    """A process's executable ledger: appends one row per executable to
    ``<log_dir>/ledger.jsonl`` (none when `enabled` is false or there is
    no log dir) and keeps the ``exec_*`` block of the stats surfaces
    (heartbeat, /healthz, /metrics, analyze and tail), the artifact,
    index and deep-verify counters included. `libraries` maps each
    recorded executable to the libraries its call launched (what
    `warmup --serve` publishes with it). Thread-safe; the hot path is
    `note_exec`, one dict update a dispatch."""

    def __init__(self, log_dir: str | None, enabled: bool = True,
                 backend: str | None = None):
        self.path = (os.path.join(log_dir, "ledger.jsonl")
                     if log_dir and enabled else None)
        self.backend = backend
        self._lock = threading.Lock()
        self._fingerprints: dict[str, str] = {}
        self._lowerings = 0
        self._recompiles = 0
        self._compile_s = 0.0
        self._cache_hits = 0
        self._cache_misses = 0
        #: the trace passes' own seconds (op text and hashing)
        self.trace_s = 0.0
        # name -> [count, total_s, roofline_s]
        self._exec: dict[str, list] = {}
        #: executable name -> the libraries its recorded call launched
        self.libraries: dict[str, list[str]] = {}
        self._artifact = {"hits": 0, "misses": 0, "rejects": 0}
        self._index = {"hits": 0, "misses": 0, "rejects": 0}
        self._deep_verify = {"pending": 0, "ok": 0, "demoted": 0}

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def _append(self, row: dict) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def record(self, row: dict) -> dict:
        """Count and append one row (see `exec_row`); returns it."""
        name = row["name"]
        with self._lock:
            self._lowerings += 1
            if row.get("compile_s") is not None:
                self._compile_s += float(row["compile_s"])
            self._cache_hits += row.get("cache_hits") or 0
            self._cache_misses += row.get("cache_misses") or 0
            fp = row.get("fingerprint")
            if fp is not None:
                prev = self._fingerprints.get(name)
                if prev is not None and prev != fp:
                    # the same executable ran another computation
                    self._recompiles += 1
                self._fingerprints[name] = fp
            if row.get("roofline_s") is not None:
                self._exec.setdefault(name, [0, 0.0, 0.0])[2] = \
                    row["roofline_s"]
        self._append(row)
        return row

    def record_call(self, name: str, fn: Callable[[], Any], device,
                    inputs=(), count_flops: bool = True
                    ) -> tuple[Any, dict]:
        """Run `fn()` once under the trace, record its row under `name`
        and return (fn's result, the row)."""
        out, fields = trace_call(fn, device, inputs, count_flops)
        with self._lock:
            self.trace_s += fields["trace_s"]
            self.libraries[name] = fields["sources"]
        return out, self.record(exec_row(name, fields, self.backend))

    def record_aot(self, name: str, fn: Callable[[], Any], device,
                   inputs=(), artifacts=None, kind: str = "aot"
                   ) -> tuple[Any, dict]:
        """`record_call` with compile_kind `kind` ("aot" for `warmup`,
        "first_step" for a serving engine's first call) and, with a
        store (`serve/artifacts.py::ArtifactStore`), the traced
        fingerprint looked up there: a hit is recorded as compile_kind
        "artifact", cache_verdict "artifact_hit", with the lookup's
        seconds in resolve_s. Returns (fn's result, the row)."""
        out, fields = trace_call(fn, device, inputs)
        row = exec_row(name, fields, self.backend)
        row["compile_kind"] = kind
        if artifacts is not None:
            t0 = time.perf_counter()
            try:
                _, verdict = artifacts.fetch(fields["fingerprint"])
            except Exception:  # noqa: BLE001 - the store is best-effort
                verdict = "reject:fetch_failed"
            kind_ = {"hit": "hits", "miss": "misses"}.get(verdict,
                                                          "rejects")
            with self._lock:
                self._artifact[kind_] += 1
            if verdict == "hit":
                row.update(compile_kind="artifact",
                           cache_verdict="artifact_hit",
                           resolve_s=round(time.perf_counter() - t0, 4))
        with self._lock:
            self.trace_s += fields["trace_s"]
            self.libraries[name] = fields["sources"]
        return out, self.record(row)

    def record_index(self, name: str, artifacts, key: str,
                     fn: Callable[[], Any], device
                     ) -> tuple[Any, dict | None, str]:
        """Resolve `key` through the store's index (no trace) and, on a
        hit, run `fn()` untraced and record the row: compile_kind
        "artifact", cache_verdict "index_hit", the index's fingerprint,
        compile_s the lookup and the call to its end on the device,
        resolve_s the lookup alone, code_bytes the libraries' bytes. A
        miss or a reject runs nothing and records nothing: (None, None,
        verdict), and the caller takes the traced path. Returns (fn's
        result, the row, the verdict)."""
        import torch

        t0 = time.perf_counter()
        try:
            libs, fp, verdict = artifacts.resolve(key)
        except Exception:  # noqa: BLE001 - the index is best-effort
            libs, fp, verdict = None, None, "index_reject:resolve_failed"
        t_res = time.perf_counter()
        kind = {"index_hit": "hits", "index_miss": "misses"}.get(verdict,
                                                                "rejects")
        with self._lock:
            self._index[kind] += 1
            if verdict == "index_hit":
                self._deep_verify["pending"] += 1
        if libs is None:
            return None, None, verdict
        device = torch.device(device)
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row: dict[str, Any] = {k: None for k in ROW_KEYS}
        row.update({"kind": "exec", "schema": LEDGER_SCHEMA, "name": name,
                    "time": round(time.time(), 3), "backend": self.backend,
                    "fingerprint": fp,
                    "compile_s": round(time.perf_counter() - t0, 4),
                    "resolve_s": round(t_res - t0, 4),
                    "compile_kind": "artifact",
                    "cache_verdict": "index_hit",
                    "code_bytes": (sum(os.path.getsize(p)
                                       for p in libs.values())
                                   if libs else None)})
        with self._lock:
            self.libraries[name] = sorted(libs)
        return out, self.record(row), verdict

    def note_deep_verify(self, ok: bool) -> None:
        """One deep-verify outcome: the re-traced fingerprint equals the
        index's (ok) or not (demoted). Either way one pending slot
        drains."""
        with self._lock:
            self._deep_verify["pending"] = max(
                0, self._deep_verify["pending"] - 1)
            self._deep_verify["ok" if ok else "demoted"] += 1

    def note_library_fetch(self, verdicts: dict[str, str]) -> None:
        """Count each rejected library fetch (`ArtifactStore.
        fetch_libraries`) in `exec_artifact_rejects`: the library is then
        built from source, loudly."""
        n = sum(1 for v in verdicts.values() if v.startswith("reject"))
        with self._lock:
            self._artifact["rejects"] += n

    def note_exec(self, name: str, seconds: float) -> None:
        """One measured execution of `name` (the engine's dispatch): the
        denominator of the per-executable MFU of `stats`."""
        with self._lock:
            e = self._exec.setdefault(name, [0, 0.0, 0.0])
            e[0] += 1
            e[1] += float(seconds)

    def stats(self) -> dict:
        """The ``exec_*`` block (the JAX package's keys)."""
        with self._lock:
            out: dict[str, Any] = {
                "exec_lowerings": self._lowerings,
                "exec_recompiles": self._recompiles,
                "exec_compile_s": round(self._compile_s, 3),
                "exec_cache_hits": self._cache_hits,
                "exec_cache_misses": self._cache_misses,
                **{f"exec_artifact_{k}": v
                   for k, v in self._artifact.items()},
                **{f"exec_index_{k}": v for k, v in self._index.items()},
                **{f"exec_deep_verify_{k}": v
                   for k, v in self._deep_verify.items()},
                "exec_executables": len(self._fingerprints),
                "exec_fingerprints": dict(self._fingerprints),
                "exec_dispatches": sum(e[0] for e in self._exec.values()),
                "exec_dispatch_s": round(
                    sum(e[1] for e in self._exec.values()), 4),
            }
            mfus = [e[2] * e[0] / e[1]
                    for e in self._exec.values()
                    if e[0] > 0 and e[1] > 0 and e[2] > 0]
        out["exec_mfu_nominal"] = (round(max(mfus), 6) if mfus else None)
        return out

    def flush(self) -> None:
        """One kind="exec_timing" row per executable with measured
        executions (at the engine's close): the measured mean beside the
        roofline."""
        if not self.enabled:
            return
        with self._lock:
            items = [(n, list(e)) for n, e in self._exec.items()
                     if e[0] > 0]
        for name, (count, total_s, roofline_s) in items:
            mean_s = total_s / count
            self._append({
                "kind": "exec_timing", "schema": LEDGER_SCHEMA,
                "name": name, "time": round(time.time(), 3),
                "count": count, "total_s": round(total_s, 4),
                "mean_s": round(mean_s, 6),
                "mfu_nominal": (round(roofline_s / mean_s, 6)
                                if roofline_s > 0 and mean_s > 0
                                else None)})


# ------------------------------------------------- reading and diffing
# (a copy of the JAX module's stdlib half)

def resolve_ledger_path(path: str) -> str:
    """A ledger argument may be the ledger.jsonl itself or a run dir
    holding one — ONE resolution rule, shared by load_ledger and the
    CLI pre-checks (tail's --ledger-baseline existence check), so the
    gates can never diverge on what counts as a valid ledger path."""
    if os.path.isdir(path):
        return os.path.join(path, "ledger.jsonl")
    return path


def load_ledger(path: str) -> list[dict]:
    """Rows from a ledger.jsonl (or a run dir containing one). Torn
    trailing writes from a killed run are tolerated like metrics.jsonl."""
    path = resolve_ledger_path(path)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def latest_by_name(rows: list[dict]) -> dict[str, dict]:
    """{executable name -> newest lowering row}. The newest row wins:
    a re-lowering within a run supersedes the first (the recompile
    itself is visible via exec_recompiles and the diff)."""
    out: dict[str, dict] = {}
    for r in rows:
        if r.get("kind") == "exec" and isinstance(r.get("name"), str):
            out[r["name"]] = r
    return out


def summarize_ledger(rows: list[dict]) -> dict | None:
    """The condensed `exec` block analyze/tail print for a run dir with
    a ledger: totals plus the slowest compiles (the entries worth
    staring at when a cold start got slower). compile_s_total is the
    raw wall the dir's recorded compiles paid, split per compile_kind
    (a dir that held both a `warmup` baseline and a live run mixes
    "aot" and "first_step" units — the split keeps them readable apart,
    exactly as diff_ledgers refuses to compare them); `slowest` is
    newest-row-per-name so a re-lowered executable appears once, with
    its kind."""
    execs = [r for r in rows if r.get("kind") == "exec"]
    if not execs:
        return None
    by_name = latest_by_name(rows)
    recompiles = 0
    seen: dict[str, str] = {}
    for r in execs:
        fp = r.get("fingerprint")
        name = r.get("name")
        if fp and name:
            if name in seen and seen[name] != fp:
                recompiles += 1
            seen[name] = fp
    timings = {r["name"]: r for r in rows
               if r.get("kind") == "exec_timing"
               and isinstance(r.get("name"), str)}
    compile_s = [r["compile_s"] for r in execs
                 if isinstance(r.get("compile_s"), (int, float))]
    by_kind: dict[str, float] = {}
    for r in execs:
        if isinstance(r.get("compile_s"), (int, float)):
            k = r.get("compile_kind") or "unknown"
            by_kind[k] = by_kind.get(k, 0.0) + r["compile_s"]
    out: dict[str, Any] = {
        "lowerings": len(execs),
        "executables": len(by_name),
        "recompiles": recompiles,
        "compile_s_total": round(sum(compile_s), 3) if compile_s else None,
        "compile_s_by_kind": ({k: round(v, 3)
                               for k, v in sorted(by_kind.items())}
                              if by_kind else None),
        "cache_hits": sum(r.get("cache_hits") or 0 for r in execs),
        "cache_misses": sum(r.get("cache_misses") or 0 for r in execs),
        "slowest": [
            {"name": r["name"], "compile_s": r["compile_s"],
             "compile_kind": r.get("compile_kind"),
             "fingerprint": r.get("fingerprint")}
            for r in sorted(
                (r for r in by_name.values()
                 if isinstance(r.get("compile_s"), (int, float))),
                key=lambda r: -r["compile_s"])[:3]],
    }
    mfus = [t["mfu_nominal"] for t in timings.values()
            if isinstance(t.get("mfu_nominal"), (int, float))]
    if mfus:
        out["mfu_nominal_max"] = round(max(mfus), 6)
    return out


#: diff_ledgers' default bounds — overridable from tools/ledger_diff.py
#: and `tail --ledger-*` flags.
DEFAULT_COMPILE_FACTOR = 2.0
DEFAULT_COMPILE_FLOOR_S = 1.0
DEFAULT_MEMORY_FACTOR = 1.2


def _footprint(row: dict) -> int | None:
    vals = [row.get(k) for k in ("argument_bytes", "output_bytes",
                                 "temp_bytes")]
    vals = [v for v in vals if isinstance(v, int)]
    return sum(vals) if vals else None


def diff_ledgers(baseline: list[dict], run: list[dict],
                 compile_factor: float = DEFAULT_COMPILE_FACTOR,
                 compile_floor_s: float = DEFAULT_COMPILE_FLOOR_S,
                 memory_factor: float = DEFAULT_MEMORY_FACTOR) -> dict:
    """The regression sentinel: a live run's ledger vs a committed
    baseline, per executable name (newest row per name on both sides).

    Four failure classes, each a list of {name, baseline, run} entries:

      fingerprint_drift     the HLO changed — the computation is not
                            the one the baseline measured
      unexpected_recompiles the baseline's compile was a persistent-
                            cache hit but this run's missed — a silent
                            cold-start regression (cache key drift,
                            evicted cache, version skew). Rows whose
                            compile_kind is "artifact" (fingerprint- or
                            index-resolved fetches, including
                            cache_verdict="index_hit" rows) or
                            "deep_verify" (the background verifier's
                            post-serve re-lowering) never enter this
                            check on either side: a fetch is not a
                            compile and a deep verify is not a boot, so
                            their cache activity is healthy, not a
                            miss — no spurious rc 8 from booting off
                            the artifact plane
      compile_blowups       compile_s exceeded
                            max(compile_floor_s, baseline * factor) —
                            compared ONLY between rows whose
                            compile_kind matches: a warmup baseline's
                            pure lower+compile ("aot") never bounds a
                            live train run's first-step wall
                            ("first_step" = compile + one executed
                            step), which would fire a false rc 8 on a
                            healthy run
      memory_growth         argument+output+temp bytes exceeded
                            baseline * memory_factor

    `new` / `missing` names are reported but never fail the diff: a
    config can legitimately grow or shrink its lattice, and the warmup
    report covers per-entry coverage. `failed` = any failure-class list
    nonempty — tools/ledger_diff.py and `tail` map it to rc 8.
    """
    base = latest_by_name(baseline)
    live = latest_by_name(run)
    drift, recompiles, blowups, growth = [], [], [], []
    for name in sorted(set(base) & set(live)):
        b, r = base[name], live[name]
        bf, rf = b.get("fingerprint"), r.get("fingerprint")
        if bf and rf and bf != rf:
            drift.append({"name": name, "baseline": bf, "run": rf})
        if (b.get("compile_kind") not in ("artifact", "deep_verify")
                and r.get("compile_kind") not in ("artifact", "deep_verify")
                and (b.get("cache_hits") or 0) >= 1
                and (b.get("cache_misses") or 0) == 0
                and (r.get("cache_misses") or 0) >= 1):
            recompiles.append({
                "name": name,
                "baseline": {"hits": b.get("cache_hits"),
                             "misses": b.get("cache_misses")},
                "run": {"hits": r.get("cache_hits"),
                        "misses": r.get("cache_misses")}})
        bc, rc = b.get("compile_s"), r.get("compile_s")
        if (isinstance(bc, (int, float)) and isinstance(rc, (int, float))
                and b.get("compile_kind") == r.get("compile_kind")
                and rc > max(float(compile_floor_s),
                             bc * float(compile_factor))):
            blowups.append({"name": name, "baseline": bc, "run": rc})
        bm, rm = _footprint(b), _footprint(r)
        if (bm is not None and rm is not None and bm > 0
                and rm > bm * float(memory_factor)):
            growth.append({"name": name, "baseline": bm, "run": rm})
    out = {
        "executables": len(set(base) | set(live)),
        "compared": len(set(base) & set(live)),
        "new": sorted(set(live) - set(base)),
        "missing": sorted(set(base) - set(live)),
        "fingerprint_drift": drift,
        "unexpected_recompiles": recompiles,
        "compile_blowups": blowups,
        "memory_growth": growth,
        "bounds": {"compile_factor": float(compile_factor),
                   "compile_floor_s": float(compile_floor_s),
                   "memory_factor": float(memory_factor)},
    }
    out["failed"] = bool(drift or recompiles or blowups or growth)
    return out


def find_baseline(log_dir: str, explicit: str | None = None) -> str | None:
    """The baseline ledger path for a run dir: an explicit path wins;
    otherwise the committed-by-convention ``<log_dir>/
    ledger_baseline.jsonl`` when present; else None (no verdict)."""
    if explicit:
        return explicit
    cand = os.path.join(log_dir, "ledger_baseline.jsonl")
    return cand if os.path.isfile(cand) else None


def ledger_verdict(log_dir: str, baseline: str | None = None,
                   compile_factor: float = DEFAULT_COMPILE_FACTOR,
                   compile_floor_s: float = DEFAULT_COMPILE_FLOOR_S,
                   memory_factor: float = DEFAULT_MEMORY_FACTOR,
                   run_rows: list[dict] | None = None,
                   base_rows: list[dict] | None = None) -> dict | None:
    """tail/analyze's one-call entry: diff the run dir's ledger.jsonl
    against its baseline (find_baseline), or None when either side is
    absent/unreadable — no ledger, no verdict, never a crash in tail.
    Pass `run_rows`/`base_rows` when the caller already loaded a side
    (tail_summary loads the run's for the condensed block; ledger_drift
    loads the shared baseline once for a whole fleet) so a
    `tail --follow` tick parses each file once, not once per process."""
    path = find_baseline(log_dir, baseline)
    if path is None:
        return None
    try:
        if base_rows is None:
            base_rows = load_ledger(path)
        if run_rows is None:
            run_rows = load_ledger(log_dir)
    except OSError:
        return None
    if not base_rows or not run_rows:
        return None
    return diff_ledgers(base_rows, run_rows,
                        compile_factor=compile_factor,
                        compile_floor_s=compile_floor_s,
                        memory_factor=memory_factor)
