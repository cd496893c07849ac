"""The artifact plane (port of `deepof_tpu/serve/artifacts.py`): a
fingerprint-keyed store of what a serving process would otherwise build,
its trace-free index, and their verify and gc.

What the store holds. The JAX package serializes each AOT-compiled XLA
executable of the serving lattice, and a replica deserializes it in
place of an XLA compile. This package compiles nothing per call: it runs
eager PyTorch over cuDNN and three CUDA libraries, each built once by
`nvcc` under a sha256 of its source, its headers and its flags
(`ops/cuda/build.py::library_path`). So an entry is one lattice
executable's row of the executable ledger (`obs/ledger.py`): its
fingerprint (the normalized op trace of its first call, `trace_call`),
the libraries that call launched, and each library's `.so` file:

    <root>/<fingerprint>/manifest.json
    <root>/<fingerprint>/lib<name>-<hash>.so      one a library it launched
    <root>/index.json                             the trace-free index

The manifest holds `schema`, `fingerprint`, `name`, `backend` ("cuda" or
"cpu"), the `torch`, `cuda` and `cudnn` versions, the card's
`capability`, `created` and `compile_s`, and for each library its
`name`, its 16-hex source `hash`, its `file`, `size` and `crc32`.

The gate is the source hash. JAX's gate is the fingerprint that the
consumer recomputes from its own lowering: drifted code lowers to
another fingerprint and misses. Here a call cannot be traced before its
libraries are loaded (tracing runs it), so the consumer computes each
library's hash locally with `library_path` (pure: no build, no trace)
and takes from the store only a `.so` whose manifest hash equals it. A
stale library can never load. Every other fault is a loud
``reject:<why>`` (a warning on stderr, a ledger counter, and the row's
verdict): ``source_hash_mismatch``, ``size_mismatch``, ``crc_mismatch``,
``schema_mismatch``, ``backend_mismatch``, ``torch_version_mismatch``,
``cuda_version_mismatch``, ``capability_mismatch``,
``fingerprint_mismatch`` (a manifest that disagrees with its directory)
and ``manifest_unreadable``; the names shared with JAX's gates are
JAX's. After a miss or a reject the caller builds the same library from
its source in this checkout, as the JAX engine compiles after one; it
never falls back to a kernel's plain version. A JAX entry found here
rejects as a schema mismatch (this store's schema is its own).

Installing a fetched library copies it into `build.BUILD_DIR` under its
own name (`ops/cuda/build.py::install`: a temporary sibling, then
`os.rename`, under the build lock): a later `build.load` finds it built,
and `build.built_names()` does not count it.

Publishing keeps JAX's discipline: one writer (`warmup --serve`), each
entry staged in a ``.tmp-<pid>-*`` directory and renamed into place,
first writer wins; `index.json` is merged and renamed over.

The index maps a resolution key to an entry's fingerprint and libraries,
with JAX's entry keys (``torch`` in place of ``jax``). The key is
sha256-16 over the exec name, `serve_config_digest(cfg)`, a parameter
signature (`params_signature`: the sorted (state-dict name, shape,
dtype) rows plus the input batch's (max_batch, H, W, 6) float32 row),
the backend and the torch version: both computed without a trace. With
the index, a replica's `InferenceEngine.warm()` resolves every lattice
entry with no trace (the index's fingerprint stands for the row's) and
runs each entry's warm-up dispatch untraced.

Deep verify. After serving starts, the engine re-traces each
index-resolved entry with `trace_call` on one zero batch, paced by
`serve.deep_verify_interval_s`, on its dispatch path between batches,
and compares the fingerprint with the index's; a mismatch is demoted
(`exec_deep_verify_demoted`, a warning and a warn record). Eager
PyTorch always runs the current code, and every library was checked by
its source hash, so a demotion reports drift (the index describes
another computation than the one served): there is nothing stale to
swap out, and JAX's "recompile swap-in" has no counterpart here.

What the store does not save. On a host or tree whose `build/` is cold
it saves each library's `nvcc` run (seconds each: PERF.md §6), and with
the index the boot-time trace of each lattice entry. It cannot
save cuDNN's choice of algorithms (made at the first call of each shape,
which `warm()` still makes), the torch import or the checkpoint's
restore, which are most of a replica's boot (PERF.md §5).

The default root is `<repo>/artifacts/exec_torch` (the JAX store's is
`artifacts/exec`: the two never meet). Stdlib-only at import, so the
`artifacts` verb needs no torch; torch is imported where a gate reads
the local environment.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import time
import zlib

#: manifest schema: this package's own, so a JAX entry (schema 1)
#: rejects as a schema mismatch instead of being read as a library entry
SCHEMA = "torch-1"

#: index schema: a JAX index (schema 1) reads as empty here
INDEX_SCHEMA = "torch-1"

MANIFEST = "manifest.json"
INDEX = "index.json"

#: default store root, beside the JAX store under artifacts/ (listed in
#: .gitignore)
DEFAULT_STORE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "artifacts", "exec_torch")


def _is_fingerprint(name: str) -> bool:
    return (len(name) == 16
            and all(c in "0123456789abcdef" for c in name))


def store_entries(root: str) -> list[str]:
    """Fingerprint directory names present in the store (sorted); tmp
    staging dirs and strangers are not entries."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(n for n in names
                  if _is_fingerprint(n)
                  and os.path.isdir(os.path.join(root, n)))


def _read_manifest(root: str, fingerprint: str) -> dict:
    with open(os.path.join(root, fingerprint, MANIFEST)) as f:
        man = json.load(f)
    if not isinstance(man, dict):
        raise ValueError("manifest is not a JSON object")
    return man


def verify_entry(root: str, fingerprint: str) -> dict:
    """Structural verdict for one entry (JAX's keys): the manifest
    parses, its schema is this store's, its fingerprint agrees with the
    directory name, and every library file's size and crc32 agree with
    the manifest. `size` is the libraries' bytes, `crc32` the crc32 run
    over them in manifest order. Torch-free: the environment and source
    hash gates are the consumer's (`ArtifactStore.fetch`)."""
    entry = {"fingerprint": fingerprint, "ok": False, "why": None,
             "name": None, "backend": None, "size": None, "crc32": None,
             "created": None}
    try:
        man = _read_manifest(root, fingerprint)
    except (OSError, ValueError) as e:
        entry["why"] = f"manifest_unreadable: {e}"
        return entry
    entry["name"] = man.get("name")
    entry["backend"] = man.get("backend")
    entry["created"] = man.get("created")
    if man.get("schema") != SCHEMA:
        entry["why"] = f"schema_mismatch: {man.get('schema')!r}"
        return entry
    if man.get("fingerprint") != fingerprint:
        entry["why"] = (f"fingerprint_mismatch: manifest says "
                        f"{man.get('fingerprint')!r}")
        return entry
    libs = man.get("libraries")
    if not isinstance(libs, list) or not all(
            isinstance(lib, dict) and isinstance(lib.get("file"), str)
            for lib in libs):
        entry["why"] = "manifest_malformed: libraries"
        return entry
    size, crc = 0, 0
    for lib in libs:
        path = os.path.join(root, fingerprint, os.path.basename(lib["file"]))
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            entry["why"] = f"payload_unreadable: {e}"
            return entry
        size += len(blob)
        crc = zlib.crc32(blob, crc)
        if lib.get("size") != len(blob):
            entry["why"] = (f"size_mismatch: {lib.get('name')} manifest "
                            f"{lib.get('size')} != {len(blob)}")
            entry["size"] = size
            return entry
        if lib.get("crc32") != zlib.crc32(blob):
            entry["why"] = f"crc_mismatch: {lib.get('name')}"
            entry["size"] = size
            return entry
    entry["size"] = size
    entry["crc32"] = crc
    entry["ok"] = True
    return entry


def verify_store(root: str) -> dict:
    """Whole-store structural report (JAX's keys): every entry's verdict,
    the corrupt/ok split and leftover tmp staging (a publisher that
    died mid-stage)."""
    fps = store_entries(root)
    entries = [verify_entry(root, fp) for fp in fps]
    tmp = []
    try:
        tmp = sorted(n for n in os.listdir(root) if n.startswith(".tmp-"))
    except OSError:
        pass
    return {
        "dir": root,
        "entries": entries,
        "total": len(entries),
        "ok": sum(1 for e in entries if e["ok"]),
        "corrupt": [e["fingerprint"] for e in entries if not e["ok"]],
        "tmp_dirs": tmp,
    }


def gc_store(root: str, older_than_days: float | None = None,
             roots: set[str] | frozenset[str] | None = None) -> dict:
    """Garbage-collect the store, as JAX's: corrupt entries and orphaned
    tmp staging always go; with ``older_than_days``, valid entries whose
    manifest ``created`` is older go too, unless pinned. ``roots`` pins
    fingerprints against the age sweep, and so do the index's targets
    (a retirement's sweep never collects what the next boot resolves).
    Index entries whose target was removed are pruned."""
    report = verify_store(root)
    pinned = set(roots or ())
    pinned |= index_targets(root)
    removed, kept = [], []
    now = time.time()
    for e in report["entries"]:
        drop = not e["ok"]
        if (not drop and older_than_days is not None
                and e["fingerprint"] not in pinned
                and isinstance(e["created"], (int, float))
                and now - e["created"] > older_than_days * 86400.0):
            drop = True
        if drop:
            shutil.rmtree(os.path.join(root, e["fingerprint"]),
                          ignore_errors=True)
            removed.append(e["fingerprint"])
        else:
            kept.append(e["fingerprint"])
    for t in report["tmp_dirs"]:
        p = os.path.join(root, t)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.remove(p)
            except OSError:
                pass
    pruned = _prune_index(root, set(removed))
    return {"dir": root, "removed": removed, "kept": kept,
            "tmp_removed": report["tmp_dirs"], "index_pruned": pruned}


# ------------------------------------------------- executable index
# resolution_key and serve_config_digest are copies of the JAX module's:
# the same inputs give the same keys and digests


def resolution_key(name: str, config_digest: str, aval_sig: str,
                   backend: str, jax_version: str) -> str:
    """The pure index key: sha256-16 over the canonical JSON of the five
    components (here the fifth is the torch version)."""
    payload = json.dumps(
        [name, config_digest, aval_sig, backend, jax_version],
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def serve_config_digest(cfg) -> str:
    """Digest of the config fields that shape the serving lattice (model
    topology, buckets, batch, tiers, warm session); ports, log dirs and
    fleet knobs vary per replica and stay out."""
    sub = {
        "model": cfg.model,
        "width_mult": cfg.width_mult,
        "corr_max_disp": cfg.corr_max_disp,
        "corr_stride": cfg.corr_stride,
        "time_step": cfg.data.time_step,
        "image_size": list(cfg.data.image_size),
        "max_batch": cfg.serve.max_batch,
        "buckets": [list(b) for b in (cfg.serve.buckets or ())],
        "precisions": list(cfg.serve.precisions or ()),
        "warm_start": cfg.serve.session.warm_start,
        "warm_width": cfg.serve.session.warm_width,
    }
    payload = json.dumps(sub, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def params_signature(state_dict, x_shape) -> str:
    """sha256-16 of the sorted (state-dict name, shape, dtype) rows plus
    the input batch's ("__x__", `x_shape`, "float32") row: the place of
    JAX's `params_aval_sig`. Reads `.shape` and `.dtype` only, so the
    engine (restored weights) and warmup (a seeded init) agree without a
    trace; a width or dtype drift misses."""
    rows = [[str(k), list(v.shape), str(v.dtype)]
            for k, v in state_dict.items()]
    rows.append(["__x__", list(x_shape), "float32"])
    rows.sort()
    payload = json.dumps(rows, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _empty_index() -> dict:
    return {"schema": INDEX_SCHEMA, "updated": None, "entries": {}}


def load_index(root: str) -> dict:
    """Read ``index.json`` tolerantly: an absent, torn or wrong-schema
    index reads as empty (every resolve misses; never an exception on
    the boot path)."""
    path = os.path.join(root, INDEX)
    try:
        with open(path) as f:
            idx = json.load(f)
    except (OSError, ValueError):
        return _empty_index()
    if (not isinstance(idx, dict)
            or idx.get("schema") != INDEX_SCHEMA
            or not isinstance(idx.get("entries"), dict)):
        return _empty_index()
    return idx


def _write_index_file(root: str, idx: dict) -> None:
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp-{os.getpid()}-index.json")
    with open(tmp, "w") as f:
        json.dump(idx, f, indent=2, sort_keys=True)
    os.rename(tmp, os.path.join(root, INDEX))


def write_index(root: str, entries: dict) -> dict:
    """The single writer's atomic index publish: merge ``entries`` (key
    -> entry) over the existing index, stage to a ``.tmp-`` sibling,
    rename over ``index.json``."""
    idx = load_index(root)
    idx["entries"].update(entries)
    idx["updated"] = time.time()
    _write_index_file(root, idx)
    return idx


def index_targets(root: str) -> set[str]:
    """Fingerprints the index maps to: the gc's root set."""
    idx = load_index(root)
    out = set()
    for ent in idx["entries"].values():
        fp = (ent or {}).get("fingerprint")
        if isinstance(fp, str) and _is_fingerprint(fp):
            out.add(fp)
    return out


def _prune_index(root: str, removed_fps: set[str]) -> list[str]:
    """Drop index entries whose target was just removed, so a later boot
    takes a clean miss instead of a stale-target reject."""
    if not removed_fps or not os.path.isfile(os.path.join(root, INDEX)):
        return []
    idx = load_index(root)
    stale = [k for k, ent in idx["entries"].items()
             if (ent or {}).get("fingerprint") in removed_fps]
    if not stale:
        return []
    for k in stale:
        del idx["entries"][k]
    idx["updated"] = time.time()
    _write_index_file(root, idx)
    return sorted(stale)


# --------------------------------------------------------- torch half


def _smi_capability() -> list[int] | None:
    """The first card's compute capability as `nvidia-smi` reports it
    (no CUDA context), or None when it cannot be read."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_cap",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split()[0]
        major, minor = out.split(".")
        return [int(major), int(minor)]
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def local_environment(device, context: bool = True) -> dict:
    """This process's side of the environment gates: backend, torch,
    CUDA and cuDNN versions, and the card's capability (None on the
    CPU). Without `context` (the fleet's supervisor, which creates no
    CUDA context) the capability is `nvidia-smi`'s."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    cap = None
    if cuda:
        cap = (list(torch.cuda.get_device_capability(device)) if context
               else _smi_capability())
    return {"backend": device.type, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "cudnn": torch.backends.cudnn.version() if cuda else None,
            "capability": cap}


def _source_hash(name: str) -> str:
    """The 16-hex hash of this checkout's `csrc/<name>.cu` (with its
    headers and flags), as its library's file name carries it."""
    from ..ops.cuda.build import library_path

    return library_path(name).stem.rsplit("-", 1)[-1]


class ArtifactStore:
    """The store under `root`, as the process on `device` reads and
    writes it.

    ``fetch(fingerprint)`` -> ``(libraries | None, verdict)``: libraries
    is {name: path of the store's `.so`}; verdict ``"hit"``, ``"miss"``
    (no entry) or ``"reject:<why>"`` (an entry that failed a gate;
    warned on stderr). ``fetch_libraries(names)`` finds each library at
    this checkout's source hash in any entry and installs it.
    ``resolve(key)`` is the index's trace-free path; ``publish`` the
    single writer's. None of them raises into a boot or a warmup."""

    def __init__(self, root: str, device="cuda", context: bool = True):
        self.root = str(root)
        self.device = device
        self.context = context
        self._env: dict | None = None
        self._index: dict | None = None  # one load a store object

    @property
    def env(self) -> dict:
        if self._env is None:
            self._env = local_environment(self.device, self.context)
        return self._env

    # gates -----------------------------------------------------------

    def _gate(self, man: dict) -> str | None:
        """The environment and source gates of a verified manifest: None
        when it may load here, else the reject's why."""
        env = self.env
        if man.get("backend") != env["backend"]:
            return (f"backend_mismatch: artifact is for "
                    f"{man.get('backend')!r}, we run {env['backend']!r}")
        if man.get("torch") != env["torch"]:
            return (f"torch_version_mismatch: artifact from "
                    f"{man.get('torch')!r}, we run {env['torch']!r}")
        if env["backend"] == "cuda":
            if man.get("cuda") != env["cuda"]:
                return (f"cuda_version_mismatch: artifact from "
                        f"{man.get('cuda')!r}, we run {env['cuda']!r}")
            if man.get("capability") != env["capability"]:
                return (f"capability_mismatch: artifact for "
                        f"{man.get('capability')!r}, this card is "
                        f"{env['capability']!r}")
        for lib in man.get("libraries") or ():
            want = _source_hash(lib.get("name", ""))
            if lib.get("hash") != want:
                return (f"source_hash_mismatch: {lib.get('name')} built "
                        f"from {lib.get('hash')!r}, this checkout's "
                        f"source is {want!r}")
        return None

    @staticmethod
    def _reject(fingerprint: str, why: str) -> str:
        print(f"artifacts: REJECT {fingerprint}: {why} — building from "
              f"source instead", file=sys.stderr)
        return f"reject:{why.split(':', 1)[0]}"

    # consumers -------------------------------------------------------

    def fetch(self, fingerprint: str):
        """The entry of `fingerprint` through every gate: (libraries,
        "hit"), (None, "miss") or (None, "reject:<why>")."""
        if not os.path.isfile(os.path.join(self.root, fingerprint,
                                           MANIFEST)):
            return None, "miss"
        entry = verify_entry(self.root, fingerprint)
        if not entry["ok"]:
            return None, self._reject(fingerprint, entry["why"])
        try:
            man = _read_manifest(self.root, fingerprint)
            why = self._gate(man)
        except (OSError, ValueError) as e:
            why = f"manifest_unreadable: {e}"
        if why is not None:
            return None, self._reject(fingerprint, why)
        return ({lib["name"]: os.path.join(self.root, fingerprint,
                                           os.path.basename(lib["file"]))
                 for lib in man["libraries"]}, "hit")

    def fetch_libraries(self, names) -> dict[str, str]:
        """Install each library of `names` that this checkout has not
        built yet from an entry holding it at the local source hash (the
        index's targets first). Returns {name: verdict}: "present" (built
        here already: nothing fetched), "hit" (installed from the store),
        "miss" (no entry holds it: the caller builds it from source) or
        "reject:<why>" (every entry holding it failed a gate; loud)."""
        from ..ops.cuda import build

        out: dict[str, str] = {}
        wanted = [n for n in names if not build.library_path(n).exists()]
        for n in names:
            if n not in wanted:
                out[n] = "present"
        if not wanted:
            return out
        targets = index_targets(self.root)
        order = sorted(store_entries(self.root),
                       key=lambda fp: (fp not in targets, fp))
        for name in wanted:
            want = _source_hash(name)
            verdict = "miss"
            for fp in order:
                try:
                    man = _read_manifest(self.root, fp)
                except (OSError, ValueError):
                    continue
                if not any(isinstance(lib, dict)
                           and lib.get("name") == name
                           and lib.get("hash") == want
                           for lib in man.get("libraries") or ()):
                    continue
                libs, v = self.fetch(fp)
                if libs is None:
                    verdict = v  # another entry may still hold a good copy
                    continue
                build.install(name, libs[name])
                verdict = "hit"
                break
            out[name] = verdict
        return out

    def resolve(self, key: str):
        """Trace-free resolution: index key -> ``(libraries | None,
        fingerprint | None, verdict)``, verdict ``"index_hit"``,
        ``"index_miss"`` or ``"index_reject:<why>"``. A forged entry
        (its components do not hash back to its key), a cross-wired one
        (its target's manifest names another executable), a stale target
        (gone from the store), a version or backend skew, or a target
        that fails `fetch`'s gates never resolves, and every reject is
        loud."""
        ent = self.index_entry(key)
        if ent is None:
            return None, None, "index_miss"
        try:
            want = resolution_key(ent["name"], ent["config_digest"],
                                  ent["aval_sig"], ent["backend"],
                                  ent["torch"])
        except (KeyError, TypeError):
            return None, None, self._index_reject(key, "entry_malformed")
        if want != key:
            return None, None, self._index_reject(
                key, f"entry_forged: components hash to {want}")
        fp = ent.get("fingerprint")
        if not (isinstance(fp, str) and _is_fingerprint(fp)):
            return None, None, self._index_reject(
                key, f"bad_fingerprint: {fp!r}")
        env = self.env
        if ent["backend"] != env["backend"]:
            return None, fp, self._index_reject(
                key, f"backend_mismatch: index entry is for "
                     f"{ent['backend']!r}, we run {env['backend']!r}")
        if ent["torch"] != env["torch"]:
            return None, fp, self._index_reject(
                key, f"torch_version_mismatch: index entry from "
                     f"{ent['torch']!r}, we run {env['torch']!r}")
        if not os.path.isfile(os.path.join(self.root, fp, MANIFEST)):
            return None, fp, self._index_reject(
                key, f"stale_target: {fp} not in store")
        try:
            man = _read_manifest(self.root, fp)
        except (OSError, ValueError) as e:
            return None, fp, self._index_reject(
                key, f"target_manifest_unreadable: {e}")
        if man.get("name") != ent["name"]:
            return None, fp, self._index_reject(
                key, f"name_mismatch: target manifest says "
                     f"{man.get('name')!r}, index entry is "
                     f"{ent['name']!r}")
        libs, verdict = self.fetch(fp)
        if libs is None:
            why = verdict.split(":", 1)[1] if ":" in verdict else verdict
            return None, fp, self._index_reject(key, f"target_{why}")
        return libs, fp, "index_hit"

    def index_entry(self, key: str) -> dict | None:
        """The raw index entry of `key`, or None (one index load a store
        object, shared with `resolve`)."""
        if self._index is None:
            self._index = load_index(self.root)
        return self._index["entries"].get(key)

    @staticmethod
    def _index_reject(key: str, why: str) -> str:
        print(f"artifacts: INDEX REJECT {key}: {why} — falling back to "
              f"the traced path", file=sys.stderr)
        return f"index_reject:{why.split(':', 1)[0]}"

    # the single writer -----------------------------------------------

    def publish(self, fingerprint: str, libraries=(), *, name: str = "",
                compile_s: float | None = None, meta: dict | None = None
                ) -> str:
        """Stage the entry of `fingerprint` (a copy of each library of
        `libraries` as this checkout built it) and rename it into place:
        "published", "exists" (an entry was there first) or
        "error:<type>" (never raises)."""
        final = os.path.join(self.root, fingerprint)
        if os.path.isfile(os.path.join(final, MANIFEST)):
            return "exists"
        tmp = os.path.join(self.root, f".tmp-{os.getpid()}-{fingerprint}")
        try:
            from ..ops.cuda.build import library_path

            os.makedirs(tmp, exist_ok=True)
            libs = []
            for lib in sorted(libraries):
                src = library_path(lib)
                with open(src, "rb") as f:
                    blob = f.read()
                with open(os.path.join(tmp, src.name), "wb") as f:
                    f.write(blob)
                libs.append({"name": lib, "hash": _source_hash(lib),
                             "file": src.name, "size": len(blob),
                             "crc32": zlib.crc32(blob)})
            man = {"schema": SCHEMA, "fingerprint": fingerprint,
                   "name": name, **self.env, "compile_s": compile_s,
                   "created": time.time(), "libraries": libs}
            if meta:
                man.update(meta)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(man, f, indent=2, sort_keys=True)
            try:
                os.rename(tmp, final)
            except OSError:
                # another writer won the rename; its entry stands
                shutil.rmtree(tmp, ignore_errors=True)
                return "exists"
            return "published"
        except Exception as e:  # noqa: BLE001 - publish is best-effort
            shutil.rmtree(tmp, ignore_errors=True)
            print(f"artifacts: publish {fingerprint} failed: {e}",
                  file=sys.stderr)
            return f"error:{type(e).__name__}"


def store_root(cfg) -> str | None:
    """`serve.artifacts_dir` as an absolute path (a replica's cwd never
    decides which store it reads), or None when the plane is off."""
    root = getattr(cfg.serve, "artifacts_dir", "")
    if not root:
        return None
    return os.path.abspath(os.path.expanduser(root))


def store_for_config(cfg, device="cuda", context: bool = True
                     ) -> ArtifactStore | None:
    """The store a serve config asks for, as the process on `device`
    reads it, or None when `serve.artifacts_dir` is empty."""
    root = store_root(cfg)
    return None if root is None else ArtifactStore(root, device, context)
