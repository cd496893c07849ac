"""The PyTorch port stands alone: it imports no JAX, flax, optax, cv2 or PIL,
and nothing of the JAX package, and its entry points do not fall back
to the CPU when no card is present."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepof_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "deepof_tpu")


def _modules():
    import deepof_tpu_torch

    return ["deepof_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(deepof_tpu_torch.__path__,
                                              "deepof_tpu_torch.")]


def test_port_imports_with_jax_and_reference_blocked():
    script = textwrap.dedent(f"""
        import importlib, sys
        BLOCKED = {BLOCKED!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        for mod in {_modules()!r} + ["chip_smoke"]:
            importlib.import_module(mod)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


@pytest.mark.parametrize("module", [
    "deepof_tpu_torch.obs.trace", "deepof_tpu_torch.obs.heartbeat",
    "deepof_tpu_torch.obs.telemetry", "deepof_tpu_torch.resilience.faults",
    "deepof_tpu_torch.obs.export", "deepof_tpu_torch.serve.server",
    "deepof_tpu_torch.serve.engine", "deepof_tpu_torch.serve.buckets",
    "deepof_tpu_torch.train.metrics_log", "deepof_tpu_torch.train.state",
    "deepof_tpu_torch.train.schedule", "deepof_tpu_torch.train.step",
    "deepof_tpu_torch.train.loop", "deepof_tpu_torch.io.png",
    "deepof_tpu_torch.io.ppm", "deepof_tpu_torch.native",
    "deepof_tpu_torch.core.config", "deepof_tpu_torch.cli",
    "deepof_tpu_torch.analyze", "deepof_tpu_torch.obs.aggregate",
    "deepof_tpu_torch.data.mixture", "deepof_tpu_torch.train.recipe",
    "deepof_tpu_torch.serve.artifacts", "deepof_tpu_torch.train.warmup",
    "deepof_tpu_torch.parallel", "deepof_tpu_torch.parallel.mesh",
    "deepof_tpu_torch.train.elastic",
    "deepof_tpu_torch.tools.elastic_drill"])
def test_the_observability_and_fault_modules_are_covered(module):
    """The training loop's observability and fault modules, the serving
    plane and the fetchers are copies or ports of JAX-package modules:
    each is among the modules imported with JAX and the JAX package
    blocked above, and its source names no blocked import."""
    assert module in _modules()
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    if not os.path.exists(path):  # a package
        path = os.path.join(ROOT, *module.split("."), "__init__.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in BLOCKED]


def test_port_source_has_no_jax_or_reference_imports():
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    # a relative import climbing out of the package
                    # (from ..deepof_tpu...) names the module like an
                    # absolute one
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    if name.split(".")[0] in BLOCKED:
                        offenders.append(f"{path}:{node.lineno} {name}")
    assert not offenders, offenders


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deepof_tpu_torch import cli
    from deepof_tpu_torch.core.config import DataConfig, ExperimentConfig
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.predict import predict_pairs
    from deepof_tpu_torch.serve.engine import InferenceEngine
    from deepof_tpu_torch.train.loop import Trainer

    cfg = ExperimentConfig()
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("flownet_s", width_mult=0.25)
    with pytest.raises(RuntimeError, match="cuda"):
        predict_pairs(cfg, [], str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg.replace(data=DataConfig(dataset="synthetic")))
    for verb in ("train", "eval"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main([verb, "--synthetic", "--model", "flownet_s",
                      "--log-dir", str(tmp_path / verb)])
    assert not (tmp_path / "train").exists()  # nothing written first


def test_serve_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deepof_tpu_torch import cli
    from deepof_tpu_torch.core.config import ExperimentConfig, ServeConfig
    from deepof_tpu_torch.serve.server import run_offline, run_server

    cfg = ExperimentConfig(serve=ServeConfig(fake_exec_ms=1.0, port=0))
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(2):
        (frames / f"f{i}.ppm").write_bytes(b"P6\n2 2\n255\n" + bytes(12))
    with pytest.raises(RuntimeError, match="cuda"):
        run_server(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_offline(cfg, str(frames), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["serve", "--set", "serve.fake_exec_ms=1.0", "--set",
                  "serve.port=0", "--log-dir", str(tmp_path / "srv")])
