"""The artifact plane (`deepof_tpu_torch/serve/artifacts.py`, the engine's
index boot and deep verify, the `artifacts` verb, the fleet's handoff
and gc) against the JAX package's (`deepof_tpu/serve/artifacts.py`,
`tests/test_artifacts.py`).

Held to JAX: the pure key algebra (`resolution_key`,
`serve_config_digest`: the same keys and digests for the same inputs),
the structural reports of `verify_store` and `gc_store` (their keys and
`why` prefixes on entries with the same faults; JAX's store half needs
no XLA executable), the `artifacts` verb's exit codes, and JAX's
`load_ledger`/`diff_ledgers` reading the port's rows. The port's own
planes run on the CPU at a tiny size: a thin FlowNet-C lattice (one
bucket, f32/bf16/int8, warm start, quality on) published by
`warmup_serve` and resolved by a second engine with no trace, the deep
verify's demotion, the index's trust gates, and the library fetch on
fake library files (the card's install, load and bit-equal kernel are
`tests/test_torch_cuda.py -k library`).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from deepof_tpu import cli as jax_cli
from deepof_tpu.core.config import config_from_dict as jax_config_from_dict
from deepof_tpu.core.config import get_config as jax_get_config
from deepof_tpu.obs import ledger as jax_ledger
from deepof_tpu.serve import artifacts as jax_art
from deepof_tpu_torch import cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ObsConfig, ServeConfig,
                                          SessionConfig, TrainConfig,
                                          config_from_dict)
from deepof_tpu_torch.obs import ledger
from deepof_tpu_torch.ops.cuda import build
from deepof_tpu_torch.serve import artifacts as art
from deepof_tpu_torch.serve.artifacts import (INDEX, MANIFEST,
                                              ArtifactStore, gc_store,
                                              index_targets, load_index,
                                              resolution_key,
                                              serve_config_digest,
                                              store_entries, verify_entry,
                                              verify_store, write_index)

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- helpers


def _lib_name(name="corr") -> str:
    return build.library_path(name).name


def _port_entry(root, fp, payload=b"x" * 64, lib="corr", **overrides):
    """A hand-built port entry holding one library file (stdlib only),
    self-consistent unless an override breaks it."""
    d = os.path.join(root, fp)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, _lib_name(lib)), "wb") as f:
        f.write(payload)
    man = {"schema": art.SCHEMA, "fingerprint": fp, "name": "fake",
           "backend": "cpu", "torch": torch.__version__,
           "cuda": torch.version.cuda, "cudnn": None, "capability": None,
           "compile_s": 0.1, "created": 123.0,
           "libraries": [{"name": lib,
                          "hash": build.library_path(lib).stem[-16:],
                          "file": _lib_name(lib), "size": len(payload),
                          "crc32": zlib.crc32(payload)}]}
    man.update(overrides)
    with open(os.path.join(d, MANIFEST), "w") as f:
        json.dump(man, f)


def _jax_entry(root, fp, payload=b"x" * 64, **overrides):
    """The JAX test suite's hand-built entry (tests/test_artifacts.py)."""
    d = os.path.join(root, fp)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, jax_art.BLOB), "wb") as f:
        f.write(payload)
    man = {"schema": 1, "fingerprint": fp, "name": "fake",
           "backend": "cpu", "jax": "0.0.0", "compile_s": 0.1,
           "created": 123.0,
           "payload": {"file": jax_art.BLOB, "size": len(payload),
                       "crc32": zlib.crc32(payload) & 0xFFFFFFFF}}
    man.update(overrides)
    with open(os.path.join(d, jax_art.MANIFEST), "w") as f:
        json.dump(man, f)


def _payload(root, fp, jax_side: bool) -> str:
    return os.path.join(root, fp, jax_art.BLOB if jax_side else _lib_name())


def _index_entry(name, fp, config_digest="d" * 16, aval_sig="s" * 16,
                 backend="cpu", version=None, **over):
    ent = {"name": name, "fingerprint": fp, "config_digest": config_digest,
           "aval_sig": aval_sig, "backend": backend,
           "torch": version or torch.__version__, "libraries": [],
           "created": 123.0, **over}
    return resolution_key(name, config_digest, aval_sig, backend,
                          ent["torch"]), ent


def _published(tmp_path, name="demo", fp="0123456789abcdef"):
    """A CPU store with one published entry (no library) and an index
    entry for it: (store root, key, entry)."""
    store = ArtifactStore(str(tmp_path / "exec"), "cpu")
    assert store.publish(fp, (), name=name) == "published"
    assert store.publish(fp, (), name=name) == "exists"
    key, ent = _index_entry(name, fp)
    write_index(store.root, {key: ent})
    return store.root, key, ent


def _tiny_cfg(tmp_path) -> ExperimentConfig:
    """A thin FlowNet-C at 32x48, batch 2: three tiers, warm start and
    quality scoring, so the lattice has 3 x 2 serving entries and one
    scorer."""
    return ExperimentConfig(
        model="flownet_c", width_mult=0.25, corr_max_disp=4, corr_stride=1,
        data=DataConfig(image_size=(32, 48)),
        serve=ServeConfig(max_batch=2, precisions=("f32", "bf16", "int8"),
                          session=SessionConfig(warm_start=True),
                          artifacts_dir=str(tmp_path / "exec")),
        obs=ObsConfig(quality_sample_rate=0.5),
        train=TrainConfig(log_dir=str(tmp_path / "publish")))


LATTICE = 7


@pytest.fixture
def trace_calls(monkeypatch):
    """The `trace_call`s made anywhere (the engine and the ledger), by
    thread name: warm() runs on this thread, a deep verify on the
    engine's batcher."""
    from deepof_tpu_torch.serve import engine

    calls = []
    orig = ledger.trace_call

    def counting(*a, **k):
        calls.append(threading.current_thread().name)
        return orig(*a, **k)

    monkeypatch.setattr(ledger, "trace_call", counting)
    monkeypatch.setattr(engine, "trace_call", counting)
    return calls


@pytest.fixture
def cold_build(tmp_path, monkeypatch):
    """An empty BUILD_DIR: a library file there came from the store."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    return build


# ------------------------------------------------- stdlib half vs JAX

FAULTS = {
    "ok": None,
    "crc": lambda root, fp, jax_side: _rewrite(
        _payload(root, fp, jax_side), b"y" * 64),
    "size": lambda root, fp, jax_side: _rewrite(
        _payload(root, fp, jax_side), b"x" * 65),
    "fingerprint": "d" * 16,
    "schema": 99,
    "unreadable": lambda root, fp, jax_side: _rewrite(
        os.path.join(root, fp, MANIFEST), b"{not json"),
}


def _rewrite(path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_verify_entry_and_store_report_as_jax_does(tmp_path, fault):
    """The same fault in a port entry and in a JAX entry: the same
    verdict, the same `why` prefix, the same report keys; a JAX entry
    with no fault is itself a schema mismatch here."""
    fp = "c" * 16
    reports = {}
    for side, make in (("jax", _jax_entry), ("port", _port_entry)):
        root = str(tmp_path / side)
        how = FAULTS[fault]
        over = ({"fingerprint": how} if fault == "fingerprint"
                else {"schema": how} if fault == "schema" else {})
        make(root, fp, **over)
        if callable(how):
            how(root, fp, side == "jax")
        mod = jax_art if side == "jax" else art
        reports[side] = (mod.verify_entry(root, fp), mod.verify_store(root))
    (je, js), (pe, ps) = reports["jax"], reports["port"]
    assert set(pe) == set(je) and set(ps) == set(js)
    assert pe["ok"] == je["ok"]
    prefix = (lambda e: (e["why"] or "").split(":", 1)[0])
    assert prefix(pe) == prefix(je)
    assert (ps["total"], ps["ok"], ps["corrupt"]) \
        == (js["total"], js["ok"], js["corrupt"])
    if fault == "ok":
        assert pe["size"] == 64 and pe["crc32"] == zlib.crc32(b"x" * 64)
        assert verify_entry(str(tmp_path / "jax"), fp)["why"].startswith(
            "schema_mismatch")


def test_gc_removes_corrupt_and_tmp_as_jax_does(tmp_path):
    """gc on twin stores: corrupt entries and tmp staging go, valid and
    fresh ones stay, old ones go under --older-than-days; the same
    report keys and lists on both sides."""
    out = {}
    for side, make, mod in (("jax", _jax_entry, jax_art),
                            ("port", _port_entry, art)):
        root = str(tmp_path / side)
        make(root, "a" * 16, created=time.time())
        make(root, "b" * 16, created=time.time())
        make(root, "f" * 16, created=time.time() - 40 * 86400)
        _rewrite(_payload(root, "b" * 16, side == "jax"), b"y" * 64)
        os.makedirs(os.path.join(root, ".tmp-999-deadbeef"))
        out[side] = mod.gc_store(root, older_than_days=30)
        assert mod.store_entries(root) == ["a" * 16]
    assert out["port"] == {**out["jax"], "dir": str(tmp_path / "port")}
    assert out["port"]["removed"] == ["b" * 16, "f" * 16]
    assert out["port"]["tmp_removed"] == [".tmp-999-deadbeef"]


def test_artifacts_verb_rcs_equal_the_jax_verbs(tmp_path, capsys):
    """The rc contract on twin stores: 2 on an empty store, 0 when every
    entry verifies, 1 with a corrupt one; gc 0 and removes it; list 2
    again. The port's verb imports no torch (the import guard is
    test_torch_imports.py)."""
    roots = {s: str(tmp_path / s) for s in ("jax", "port")}
    for r in roots.values():
        os.makedirs(r)

    def both(*argv):
        rcs = {}
        for side, main in (("jax", jax_cli.main), ("port", cli.main)):
            rcs[side] = main(["artifacts", *argv, "--dir", roots[side]])
            out = capsys.readouterr()
        return rcs, out

    rcs, out = both("list")
    assert rcs == {"jax": 2, "port": 2} and "empty store" in out.err
    _jax_entry(roots["jax"], "a" * 16)
    _port_entry(roots["port"], "a" * 16)
    rcs, out = both("verify")
    assert rcs == {"jax": 0, "port": 0}
    assert json.loads(out.out)["ok"] == 1
    for side in roots:
        with open(_payload(roots[side], "a" * 16, side == "jax"), "ab") as f:
            f.write(b"junk")
    rcs, out = both("verify")
    assert rcs == {"jax": 1, "port": 1}
    assert json.loads(out.out)["corrupt"] == ["a" * 16]
    rcs, out = both("gc")
    assert rcs == {"jax": 0, "port": 0}
    assert json.loads(out.out)["removed"] == ["a" * 16]
    assert both("list")[0] == {"jax": 2, "port": 2}


def test_the_artifacts_verb_imports_no_torch(tmp_path):
    """list, verify and gc run where importing torch raises (the store is
    read from any machine, as JAX's verb reads it without jax)."""
    root = str(tmp_path / "exec")
    _port_entry(root, "a" * 16)
    script = textwrap.dedent(f"""
        import contextlib, io, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "deepof_tpu"):
                    raise ImportError(f"blocked import: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        from deepof_tpu_torch import cli

        codes = []
        for action in ("list", "verify", "gc"):
            with contextlib.redirect_stdout(io.StringIO()):
                codes.append(cli.main(["artifacts", action, "--dir",
                                       {root!r}]))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax"))
        print(codes, leaked)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[0, 0, 0] []"


# --------------------------------------------------- keys vs JAX


@pytest.mark.parametrize("preset,over", [
    ("flyingchairs", {}),
    ("sintel", {"width_mult": 0.5}),
    ("flyingchairs", {"model": "flownet_c",
                      "serve": {"buckets": [[384, 512], [192, 256]],
                                "precisions": ["f32", "int8"]}}),
    ("flyingchairs", {"model": "flownet_cs", "serve": {
        "max_batch": 4, "session": {"warm_start": True,
                                    "warm_width": 0.25}}}),
])
def test_resolution_key_and_config_digest_equal_jaxs(preset, over):
    """Both pure functions give JAX's values for the same inputs: the
    digest of a JAX config and of the port's config of its dict, and
    the key of the same five components."""
    jcfg = jax_get_config(preset)
    d = dataclasses.asdict(jcfg)
    for k, v in over.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                if isinstance(v2, dict):
                    d[k][k2].update(v2)
                else:
                    d[k][k2] = v2
        else:
            d[k] = v
    jcfg = jax_config_from_dict(d)
    with pytest.warns(UserWarning):
        pcfg = config_from_dict(d)
    digest = serve_config_digest(pcfg)
    assert digest == jax_art.serve_config_digest(jcfg)
    args = ("serve:384x512:f32:cold", digest, "5" * 16, "cuda", "2.5.1")
    assert resolution_key(*args) == jax_art.resolution_key(*args)
    # replica plumbing leaves the digest alone; the lattice moves it
    moved = pcfg.replace(serve=dataclasses.replace(
        pcfg.serve, port=9, artifacts_dir="/s",
        max_batch=pcfg.serve.max_batch + 1))
    assert serve_config_digest(moved) != digest
    assert serve_config_digest(pcfg.replace(serve=dataclasses.replace(
        pcfg.serve, port=9, artifacts_dir="/s"))) == digest


# ------------------------------------------------------- the index


def test_index_write_merges_atomically_and_loads_tolerantly(tmp_path):
    root = str(tmp_path / "exec")
    k1, e1 = _index_entry("a", "1" * 16)
    write_index(root, {k1: e1})
    k2, e2 = _index_entry("b", "2" * 16)
    assert set(write_index(root, {k2: e2})["entries"]) == {k1, k2}
    assert index_targets(root) == {"1" * 16, "2" * 16}
    assert not [n for n in os.listdir(root) if n.startswith(".tmp-")]
    _rewrite(os.path.join(root, INDEX), b'{"schema": "torch-1", "entr')
    assert load_index(root)["entries"] == {}
    # a JAX index (schema 1) reads as empty here: every key misses
    jax_art.write_index(root, {k1: e1})
    assert load_index(root)["entries"] == {}
    assert index_targets(str(tmp_path / "missing")) == set()


def test_an_index_hit_is_trace_free_counted_and_rowed(tmp_path):
    """record_index: an honest entry resolves with no trace, runs the
    call untraced, writes the "index_hit" row with the index's
    fingerprint and queues one deep verify; another config digest is
    another key: a clean miss, nothing run, no row."""
    root, key, ent = _published(tmp_path)
    led = ledger.ExecutableLedger(str(tmp_path / "run"), backend="cpu")
    ran = []
    out, row, verdict = led.record_index(
        "demo", ArtifactStore(root, "cpu"), key,
        lambda: ran.append(1) or 5, "cpu")
    assert (out, verdict, ran) == (5, "index_hit", [1])
    assert row["compile_kind"] == "artifact"
    assert row["cache_verdict"] == "index_hit"
    assert row["fingerprint"] == ent["fingerprint"]
    assert row["resolve_s"] is not None and set(row) == set(ledger.ROW_KEYS)
    st = led.stats()
    assert (st["exec_index_hits"], st["exec_index_misses"],
            st["exec_deep_verify_pending"]) == (1, 0, 1)
    led.note_deep_verify(True)
    st = led.stats()
    assert (st["exec_deep_verify_pending"], st["exec_deep_verify_ok"]) \
        == (0, 1)
    k_drift, _ = _index_entry("demo", ent["fingerprint"],
                              config_digest="f" * 16)
    assert led.record_index("demo", ArtifactStore(root, "cpu"), k_drift,
                            lambda: ran.append(1), "cpu") \
        == (None, None, "index_miss")
    assert ran == [1] and led.stats()["exec_index_misses"] == 1


def test_the_index_trust_gates_reject_loudly(tmp_path, capsys):
    """A forged entry, a stale target, a cross-wired name, a torch
    version skew and a tampered library behind an honest entry each
    refuse to resolve, warn on stderr and count; none raises."""
    root, key, ent = _published(tmp_path)
    fp = ent["fingerprint"]
    led = ledger.ExecutableLedger(None, backend="cpu")

    def resolve(k):
        return led.record_index("demo", ArtifactStore(root, "cpu"), k,
                                lambda: None, "cpu")[2]

    write_index(root, {key: dict(ent, name="other")})
    assert resolve(key) == "index_reject:entry_forged"
    k2, e2 = _index_entry("demo", "0" * 16)
    write_index(root, {k2: e2})
    assert resolve(k2) == "index_reject:stale_target"
    k3, e3 = _index_entry("other", fp)
    write_index(root, {k3: e3})
    assert resolve(k3) == "index_reject:name_mismatch"
    k4, e4 = _index_entry("demo", fp, version="0.0.0")
    write_index(root, {k4: e4})
    assert resolve(k4) == "index_reject:torch_version_mismatch"
    _port_entry(root, "e" * 16, name="demo")
    k5, e5 = _index_entry("demo", "e" * 16, aval_sig="t" * 16)
    write_index(root, {k5: e5})
    _rewrite(_payload(root, "e" * 16, False), b"tampered" * 8)
    assert resolve(k5) == "index_reject:target_crc_mismatch"
    st = led.stats()
    assert (st["exec_index_rejects"], st["exec_index_hits"]) == (5, 0)
    assert "INDEX REJECT" in capsys.readouterr().err


def test_gc_pins_roots_and_index_targets_and_prunes_stale(tmp_path):
    root = str(tmp_path / "exec")
    old = time.time() - 40 * 86400
    for fp in ("a", "b", "c", "e"):
        _port_entry(root, fp * 16, created=old)
    _rewrite(_payload(root, "e" * 16, False), b"tampered" * 8)
    kb, eb = _index_entry("fake", "b" * 16)
    ke, ee = _index_entry("fake2", "e" * 16)
    write_index(root, {kb: eb, ke: ee})
    _rewrite(os.path.join(root, ".tmp-42-index.json"), b"{}")
    gc = gc_store(root, older_than_days=30, roots={"a" * 16})
    assert sorted(gc["removed"]) == ["c" * 16, "e" * 16]
    assert sorted(gc["kept"]) == ["a" * 16, "b" * 16]
    assert ".tmp-42-index.json" in gc["tmp_removed"]
    assert gc["index_pruned"] == [ke]
    assert set(load_index(root)["entries"]) == {kb}


def test_a_jax_entry_in_the_port_store_rejects(tmp_path, capsys):
    """The two stores never meet, and where a JAX entry lands in the
    port's anyway it is a loud schema mismatch, never read as one."""
    root = str(tmp_path / "exec")
    _jax_entry(root, "a" * 16, name="serve:64x64:f32:cold")
    assert verify_store(root)["corrupt"] == ["a" * 16]
    store = ArtifactStore(root, "cpu")
    assert store.fetch("a" * 16) == (None, "reject:schema_mismatch")
    assert "REJECT" in capsys.readouterr().err
    assert art.DEFAULT_STORE_DIR != jax_art.DEFAULT_STORE_DIR


# ------------------------------------------------ the ledger's rows


def test_jax_reads_the_port_rows_and_a_fetch_is_not_a_recompile(tmp_path):
    """JAX's load_ledger and diff_ledgers read the port's "aot" and
    "index_hit" rows; a baseline whose call found its libraries built
    against a live index hit is no recompile, while the same cache shape
    without the artifact kind still trips the sentinel."""
    run = str(tmp_path / "run")
    led = ledger.ExecutableLedger(run, backend="cpu")
    x = torch.ones(4, 4)
    _, aot = led.record_aot("serve:4x4:f32:cold", lambda: x @ x, "cpu",
                            inputs=(x,))
    assert aot["compile_kind"] == "aot"
    root, key, _ = _published(tmp_path, name="serve:4x4:f32:cold",
                              fp=aot["fingerprint"])
    _, hit, _ = led.record_index("serve:4x4:f32:cold",
                                 ArtifactStore(root, "cpu"), key,
                                 lambda: x @ x, "cpu")
    rows = jax_ledger.load_ledger(run)
    assert [r["cache_verdict"] for r in rows] == [None, "index_hit"]
    base = dict(aot, cache_requests=1, cache_hits=1, cache_misses=0)
    live = dict(hit, cache_requests=1, cache_hits=0, cache_misses=1)
    for run_rows, recompiles in (([live], False),
                                 ([dict(live, compile_kind="aot")], True)):
        rep = jax_ledger.diff_ledgers([base], run_rows)
        assert bool(rep["unexpected_recompiles"]) == recompiles
        assert ledger.diff_ledgers([base], run_rows) == rep


# ------------------------------------------- the lattice, end to end


def _boot(cfg, ledger_dir):
    from deepof_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(cfg, device="cpu", ledger_dir=ledger_dir)


def test_warmup_publishes_the_lattice_and_an_engine_boots_trace_free(
        tmp_path, trace_calls):
    """`warmup_serve` traces and publishes every lattice entry (3 tiers x
    {cold, warm} and the scorer) and writes their index; a second engine
    resolves all of them through it with no trace, deep-verifies each
    after warm() (one trace each, every fingerprint ok), and serves
    bitwise what an engine without the store serves. A rerun of warmup
    finds every entry in the store."""
    from deepof_tpu_torch.train.warmup import warmup_serve

    cfg = _tiny_cfg(tmp_path)
    rep = warmup_serve(cfg, device="cpu")
    assert rep["artifacts"]["published"] == rep["artifacts"][
        "index_entries"] == len(rep["buckets"]) == LATTICE
    assert {b["mode"] for b in rep["buckets"]} == {"cold", "warm", "quality"}
    del trace_calls[:]
    with _boot(cfg, str(tmp_path / "a")) as eng:
        eng.warm()
        assert eng.deep_verify_join(60)
        st = eng.stats()
        a = np.random.RandomState(0).randint(0, 255, (32, 48, 3), np.uint8)
        got = eng.submit(a, a[::-1].copy(), precision="int8").result(60)
    assert trace_calls == ["serve-batcher"] * LATTICE
    assert (st["exec_index_hits"], st["exec_index_rejects"],
            st["exec_artifact_rejects"], st["exec_deep_verify_ok"],
            st["exec_deep_verify_demoted"],
            st["exec_deep_verify_pending"]) == (LATTICE, 0, 0, LATTICE, 0, 0)
    rows = ledger.load_ledger(str(tmp_path / "a"))
    assert sorted(r["cache_verdict"] for r in rows if r["kind"] == "exec") \
        == ["deep_verify_ok"] * LATTICE + ["index_hit"] * LATTICE
    off = cfg.replace(serve=dataclasses.replace(cfg.serve, artifacts_dir=""))
    with _boot(off, None) as eng:
        want = eng.submit(a, a[::-1].copy(), precision="int8").result(60)
    assert np.array_equal(got["flow"], want["flow"])
    rep = warmup_serve(cfg, device="cpu")
    assert rep["artifacts"]["hits"] == LATTICE


def test_without_the_index_the_fingerprint_is_found_in_the_store(tmp_path):
    """`serve.artifacts_index` off: every entry is traced, and its
    fingerprint found in the store ("artifact_hit"); nothing is queued
    for a deep verify."""
    from deepof_tpu_torch.train.warmup import warmup_serve

    cfg = _tiny_cfg(tmp_path)
    warmup_serve(cfg, device="cpu")
    cfg = cfg.replace(serve=dataclasses.replace(cfg.serve,
                                                artifacts_index=False))
    with _boot(cfg, str(tmp_path / "b")) as eng:
        eng.warm()
        st = eng.stats()
    assert (st["exec_artifact_hits"], st["exec_index_hits"],
            st["exec_deep_verify_pending"]) == (LATTICE, 0, 0)
    assert {r["cache_verdict"] for r in ledger.load_ledger(
        str(tmp_path / "b")) if r["kind"] == "exec"} == {"artifact_hit"}


def test_deep_verify_demotes_a_cross_wired_index_entry(tmp_path, capsys):
    """The f32 cold entry cross-wired to the bf16 cold entry's target,
    with the target's manifest forged to agree on the name: every boot
    gate passes, so the index hit serves; the deep verify re-traces,
    finds another fingerprint and demotes it loudly (counter, row, warn
    record in the run's metrics.jsonl). Eager PyTorch ran the current
    code all along: there is nothing stale to swap out."""
    from deepof_tpu_torch.train.warmup import warmup_serve

    cfg = _tiny_cfg(tmp_path)
    warmup_serve(cfg, device="cpu")
    root = cfg.serve.artifacts_dir
    by_name = {e["name"]: (k, e)
               for k, e in load_index(root)["entries"].items()}
    k32, e32 = by_name["serve:32x48:f32:cold"]
    victim = by_name["serve:32x48:bf16:cold"][1]["fingerprint"]
    assert victim != e32["fingerprint"]
    write_index(root, {k32: dict(e32, fingerprint=victim)})
    path = os.path.join(root, victim, MANIFEST)
    with open(path) as f:
        man = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(man, name=e32["name"]), f)
    run = str(tmp_path / "c")
    with _boot(cfg, run) as eng:
        eng.warm()
        assert eng.deep_verify_join(60)
        st = eng.stats()
    # the forged name costs the bf16 entry its own resolution (a loud
    # name_mismatch: it is traced instead)
    assert (st["exec_index_hits"], st["exec_index_rejects"],
            st["exec_deep_verify_demoted"], st["exec_deep_verify_ok"]) \
        == (LATTICE - 1, 1, 1, LATTICE - 2)
    assert "DEMOTE serve:32x48:f32:cold" in capsys.readouterr().err
    rows = ledger.load_ledger(run)
    assert [r["name"] for r in rows
            if r.get("cache_verdict") == "deep_verify_demoted"] \
        == ["serve:32x48:f32:cold"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        warns = [json.loads(line) for line in f]
    assert [w["kind"] for w in warns] == ["warn"]
    assert "DEMOTE" in warns[0]["message"]


def test_artifacts_verify_deep_rc_contract(tmp_path, capsys):
    """`artifacts verify --deep` (the publishing config's flags, on the
    CPU): 0 when every indexed entry traces to its fingerprint, 1 on
    drift (a tampered index fingerprint, named), 2 with no index."""
    root = str(tmp_path / "exec")
    flags = ["--model", "flownet_s", "--set", "width_mult=0.125",
             "--set", "data.image_size=(32,48)", "--set", "serve.max_batch=2",
             "--device", "cpu"]
    assert cli.main(["warmup", "--serve-only", "--artifacts", root,
                     "--log-dir", str(tmp_path / "w"), *flags]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["artifacts"]["index_entries"] == 1
    deep = ["artifacts", "verify", "--deep", "--dir", root, *flags]
    assert cli.main(deep) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] == rep["total"] == 1 and not rep["unindexed"]
    key, ent = next(iter(load_index(root)["entries"].items()))
    write_index(root, {key: dict(ent, fingerprint="9" * 16)})
    assert cli.main(deep) == 1
    assert json.loads(capsys.readouterr().out)["drift"] == [ent["name"]]
    os.remove(os.path.join(root, INDEX))
    assert cli.main(deep) == 2


def test_serve_takes_the_artifacts_flag(tmp_path, monkeypatch):
    """`serve --artifacts DIR` is `serve.artifacts_dir`, no longer
    refused (an explicit --set still wins)."""
    got = []
    monkeypatch.setattr(cli, "_serve",
                        lambda cfg, args, boot: got.append(cfg) or 0)
    assert cli.main(["serve", "--artifacts", "/s", "--device", "cpu"]) == 0
    assert cli.main(["serve", "--artifacts", "/s", "--set",
                     "serve.artifacts_dir=/t", "--device", "cpu"]) == 0
    assert [c.serve.artifacts_dir for c in got] == ["/s", "/t"]


# ------------------------------------------------ the library fetch


def test_the_library_fetch_installs_only_this_checkouts_source(
        tmp_path, cold_build, capsys):
    """On fake library files: a library at this checkout's source hash is
    installed into the empty build directory (not counted as built), one
    already there is "present", one no entry holds is a "miss", one held
    at another hash is never taken, and a corrupted copy is a loud
    reject that the ledger counts."""
    root = str(tmp_path / "exec")
    _port_entry(root, "a" * 16, payload=b"corr-bytes")
    _port_entry(root, "b" * 16, payload=b"old-warp", lib="warp")
    man_path = os.path.join(root, "b" * 16, MANIFEST)
    with open(man_path) as f:
        man = json.load(f)
    man["libraries"][0]["hash"] = "0" * 16
    with open(man_path, "w") as f:
        json.dump(man, f)
    store = ArtifactStore(root, "cpu")
    built = build.built_count()
    assert store.fetch_libraries(["corr", "warp", "corr_bwd"]) == {
        "corr": "hit", "warp": "miss", "corr_bwd": "miss"}
    assert build.library_path("corr").read_bytes() == b"corr-bytes"
    assert build.built_count() == built
    assert not build.install("corr", os.path.join(root, "a" * 16,
                                                  _lib_name()))
    assert store.fetch_libraries(["corr"]) == {"corr": "present"}
    assert store.fetch("b" * 16) == (None, "reject:source_hash_mismatch")
    os.remove(build.library_path("corr"))
    _rewrite(_payload(root, "a" * 16, False), b"corr-bytez")
    verdicts = store.fetch_libraries(["corr"])
    assert verdicts == {"corr": "reject:crc_mismatch"}
    assert "REJECT" in capsys.readouterr().err
    led = ledger.ExecutableLedger(None, backend="cuda")
    led.note_library_fetch(verdicts)
    assert led.stats()["exec_artifact_rejects"] == 1


def test_an_engine_counts_a_rejected_library_fetch(tmp_path):
    """A fetch the server made before the engine existed: warm() counts
    its reject in exec_artifact_rejects and fetches nothing again."""
    cfg = _tiny_cfg(tmp_path)
    cfg = cfg.replace(serve=dataclasses.replace(
        cfg.serve, precisions=("f32",), session=SessionConfig()),
        obs=ObsConfig())
    from deepof_tpu_torch.serve.engine import InferenceEngine

    with InferenceEngine(cfg, device="cpu",
                         library_fetch={"corr": "reject:crc_mismatch"}) as eng:
        out = eng.warm()
        st = eng.stats()
    assert out["libraries"] == {"corr": "reject:crc_mismatch"}
    assert st["exec_artifact_rejects"] == 1
    assert st["exec_index_misses"] == 1  # nothing published: traced


# ------------------------------------------------------- the fleet


def test_the_fleet_readies_only_the_libraries_its_replicas_launch(
        tmp_path, monkeypatch, cold_build):
    """The supervisor builds what serving launches (never the
    correlation's backward), and with a store takes what it holds."""
    from deepof_tpu_torch.serve import fleet

    asked = []

    def fake_build(name):
        asked.append(name)
        return {"built": True}

    monkeypatch.setattr(build, "build", fake_build)
    base = ExperimentConfig(model="flownet_c")
    assert fleet.prebuild_libraries(base) == {"corr": "built"}
    q = base.replace(obs=ObsConfig(quality_sample_rate=0.1))
    assert fleet.prebuild_libraries(q) == {"corr": "built", "warp": "built"}
    assert sorted(asked) == ["corr", "corr", "warp"]
    root = str(tmp_path / "exec")
    _port_entry(root, "a" * 16, payload=b"corr-bytes", backend="cuda",
                capability=None)
    monkeypatch.setattr(art, "_smi_capability", lambda: None)
    stored = base.replace(serve=dataclasses.replace(base.serve,
                                                    artifacts_dir=root))
    del asked[:]
    assert fleet.prebuild_libraries(stored) == {"corr": "hit"}
    assert asked == []


def test_fleet_handoff_and_retirement_gc(tmp_path, monkeypatch):
    """A replica's config names the store by its absolute path; the
    retirement's and the close's sweep pins every fingerprint of a
    replica's ledger (and the index's targets) and logs one warn line."""
    from deepof_tpu_torch.core import supervise
    from deepof_tpu_torch.serve.fleet import Fleet

    root = str(tmp_path / "exec")
    old = time.time() - 40 * 86400
    _port_entry(root, "a" * 16, created=old)   # a live ledger's
    _port_entry(root, "b" * 16, created=old)   # unpinned: swept
    fleet_dir = str(tmp_path / "fleet")
    rdir = os.path.join(fleet_dir, "replica-0")
    os.makedirs(rdir)
    with open(os.path.join(rdir, "ledger.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "exec", "name": "x",
                            "fingerprint": "a" * 16}) + "\n")
    cfg = ExperimentConfig(
        serve=ServeConfig(artifacts_dir="exec", fake_exec_ms=1.0),
        train=TrainConfig(log_dir=fleet_dir))
    cfg = cfg.replace(serve=dataclasses.replace(
        cfg.serve, fleet=dataclasses.replace(cfg.serve.fleet,
                                             artifacts_gc_days=30.0)))
    monkeypatch.chdir(tmp_path)
    fleet = Fleet(cfg, 1, device="cpu")
    fleet._artifacts_gc("test")
    assert store_entries(root) == ["a" * 16]
    with open(os.path.join(fleet_dir, "metrics.jsonl")) as f:
        assert any("artifacts gc (test)" in json.loads(line)["message"]
                   for line in f)

    def no_spawn(*a, **k):
        raise OSError("not spawned here")

    monkeypatch.setattr(supervise, "spawn_child", no_spawn)
    fleet._spawn(fleet._replicas[0])
    with open(os.path.join(rdir, "config.json")) as f:
        assert json.load(f)["serve"]["artifacts_dir"] == root
