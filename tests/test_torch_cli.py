"""The PyTorch port's command line, on the CPU at width 0.25 and batch 2
(the --synthetic smoke size otherwise): train, resume, eval, predict and
config, FlowNet-C at a correlation geometry set on the command line, the
flag combinations and mesh axes the port refuses, the elastic pool's
dispatch, `tail`'s executable ledger gate, and TF32 turned off by every
verb."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from deepof_tpu_torch import cli
from deepof_tpu_torch.core.config import config_from_dict, get_config
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.io.flo import read_flo
from deepof_tpu_torch.io.png import read_png_bgr
from deepof_tpu_torch.io.ppm import write_ppm_bgr
from deepof_tpu_torch.resilience.verify import verify_run
from deepof_tpu_torch.train.checkpoint import CheckpointManager
from deepof_tpu_torch.utils.flowviz import flow_to_color

SMOKE = ["--synthetic", "--model", "flownet_s", "--device", "cpu",
         "--set", "width_mult=0.25", "--set", "data.batch_size=2"]


def _run(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 3-step run, resumed to step 5."""
    log_dir = str(tmp_path_factory.mktemp("cli"))
    assert cli.main(["train", *SMOKE, "--steps", "3",
                     "--log-dir", log_dir]) == 0
    assert cli.main(["train", *SMOKE, "--steps", "2",
                     "--log-dir", log_dir]) == 0
    return log_dir


def test_train_then_resume(run_dir):
    infos = [r["message"] for r in _records(run_dir) if r["kind"] == "info"]
    assert "resumed from step 3" in infos
    report = verify_run(run_dir)
    assert report["ok"] and report["valid_steps"] == [0, 3, 5]


def test_resumed_stream_is_drawn_from_the_resume_step(run_dir, tmp_path,
                                                      monkeypatch):
    """A fit from step s draws batch i from derive_batch_rng([seed, s],
    i): the CLI's resume continues the stream of the JAX loop."""
    from deepof_tpu_torch.data.datasets import SyntheticData

    log_dir = str(tmp_path / "run")
    shutil.copytree(run_dir, log_dir)
    drawn = []
    sample = SyntheticData.sample_train

    def recording(self, batch_size, iteration=None, rng=None, **kw):
        drawn.append(rng.get_state()[1][:4].copy())
        return sample(self, batch_size, iteration, rng, **kw)

    monkeypatch.setattr(SyntheticData, "sample_train", recording)
    assert cli.main(["train", *SMOKE, "--steps", "1", "--set",
                     "data.prefetch=1", "--log-dir", log_dir]) == 0
    np.testing.assert_array_equal(
        drawn[0], derive_batch_rng(np.array([0, 5], np.uint32),
                                   0).get_state()[1][:4])


def test_eval_reports_finite_metrics(run_dir, capsys):
    out = _run(capsys, "eval", *SMOKE, "--log-dir", run_dir)
    for k in ("aee", "aae", "val_loss"):
        assert np.isfinite(out[k]), k


def test_predict_writes_flo_at_native_size(run_dir, tmp_path, capsys):
    rs = np.random.RandomState(0)
    pairs = []
    for i, hw in enumerate([(48, 80), (64, 64)]):
        a, b = (rs.randint(0, 256, (*hw, 3), np.uint8) for _ in range(2))
        np.save(tmp_path / f"a{i}.npy", a)
        write_ppm_bgr(tmp_path / f"b{i}.ppm", b)
        pairs.append(f"{tmp_path}/a{i}.npy:{tmp_path}/b{i}.ppm")
    out = _run(capsys, "predict", *SMOKE, "--log-dir", run_dir,
               "--out", str(tmp_path / "out"), "--pairs", *pairs)
    assert [os.path.basename(p) for p in out["written"]] == [
        "0000_a0_flow.flo", "0000_a0_flow.png", "0001_a1_flow.flo",
        "0001_a1_flow.png"]
    for i, hw in enumerate([(48, 80), (64, 64)]):
        flow = read_flo(out["written"][2 * i])
        assert flow.shape == (*hw, 2) and np.isfinite(flow).all()
        # the flow's colours beside it, as the JAX package writes them
        np.testing.assert_array_equal(read_png_bgr(out["written"][2 * i + 1]),
                                      flow_to_color(flow))


def test_predict_at_a_precision_tier_writes_flo(run_dir, tmp_path, capsys):
    rs = np.random.RandomState(1)
    a, b = (rs.randint(0, 256, (48, 80, 3), np.uint8) for _ in range(2))
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    pair = f"{tmp_path}/a.npy:{tmp_path}/b.npy"
    tiers = ["--set", "serve.precisions=('f32','bf16','int8')"]
    flows = {}
    for tier in ("f32", "bf16", "int8"):
        out = _run(capsys, "predict", *SMOKE, *tiers, "--precision", tier,
                   "--log-dir", run_dir, "--out", str(tmp_path / tier),
                   "--pairs", pair)
        flows[tier] = read_flo(out["written"][0])
        assert flows[tier].shape == (48, 80, 2)
        assert np.isfinite(flows[tier]).all()
    assert not np.array_equal(flows["int8"], flows["f32"])
    assert not np.array_equal(flows["bf16"], flows["f32"])
    with pytest.raises(SystemExit, match="not in serve.precisions"):
        cli.main(["predict", *SMOKE, "--precision", "int8", "--log-dir",
                  run_dir, "--out", str(tmp_path / "x"), "--pairs", pair])


def test_predict_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cli.main(["predict", *SMOKE, "--log-dir", str(tmp_path),
                  "--out", str(tmp_path / "o"), "--pairs", "a.npy:b.npy"])


def test_flownet_c_trains_and_evaluates_at_its_set_geometry(tmp_path,
                                                            capsys):
    log_dir = str(tmp_path)
    argv = ["--synthetic", "--model", "flownet_c", "--device", "cpu",
            "--set", "width_mult=0.25", "--set", "data.batch_size=2",
            "--set", "corr_max_disp=4", "--set", "corr_stride=1",
            "--log-dir", log_dir]
    _run(capsys, "train", *argv, "--steps", "2", "--set",
         "train.log_every=1")
    train = [r for r in _records(log_dir) if r["kind"] == "train"]
    assert train[-1]["step"] == 2
    assert all(np.isfinite(r["loss"]) for r in train)
    out = _run(capsys, "eval", *argv)
    for k in ("aee", "aae", "val_loss"):
        assert np.isfinite(out[k]), k
    # the checkpoint's model reads a cost volume of (2 * 4 + 1)**2 maps:
    # conv3_1 takes 81 + 8 (conv_redir) channels
    sd = CheckpointManager(os.path.join(log_dir, "ckpt"),
                           create=False).restore_raw(subtree="model")
    assert sd["conv3_1.conv.weight"].shape[1] == 81 + 8


def test_config_prints_a_dict_that_reads_back(capsys):
    assert cli.main(["config", "--preset", "sintel", "--set",
                     "train.log_every=7"]) == 0
    cfg = config_from_dict(json.loads(capsys.readouterr().out))
    want = get_config("sintel")
    assert cfg == want.replace(train=dataclasses.replace(want.train,
                                                         log_every=7))


@pytest.mark.parametrize("argv,error,match", [
    # every flag is ported (item 10: --elastic, --multihost); what the
    # JAX command line refuses, the port refuses: an elastic run without
    # an absolute target, or with --multihost or --epochs
    (["train", "--elastic", "4"], SystemExit, "absolute target step"),
    (["train", "--multihost", "--elastic", "2", "--max-steps", "3"],
     SystemExit, "exclusive"),
    (["train", "--synthetic", "--model", "flownet_s", "--elastic", "2",
      "--epochs", "1", "--max-steps", "3"], SystemExit, "--max-steps"),
    # and the mesh's spatial and time axes, item 10's last slice
    (["serve", "--set", "mesh.spatial=2"], NotImplementedError,
     "item 10"),
    (["eval", "--synthetic", "--set", "mesh.time=2"], NotImplementedError,
     "item 10")])
def test_jax_only_flags_raise(argv, error, match):
    with pytest.raises(error, match=match):
        cli.main(argv + ["--device", "cpu"])


def _ledger_dir(d, **row):
    """A run dir of one train record and one ledger row: a baseline's
    values, with `row` over them."""
    from deepof_tpu_torch.obs.ledger import ROW_KEYS

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        f.write(json.dumps({"kind": "train", "step": 1, "time": 1.0,
                            "loss": 1.0}) + "\n")
    base = {**dict.fromkeys(ROW_KEYS), "kind": "exec", "schema": 1,
            "name": "train_step", "fingerprint": "0123456789abcdef",
            "compile_s": 2.0, "compile_kind": "first_step",
            "argument_bytes": 60, "output_bytes": 20, "temp_bytes": 20}
    with open(os.path.join(d, "ledger.jsonl"), "w") as f:
        f.write(json.dumps({**base, **row}) + "\n")
    return d


@pytest.mark.parametrize("flag,value,row,clears", [
    # each flag moves its bound past a run that fails at the default
    ("--ledger-baseline", None, {"fingerprint": "fedcba9876543210"},
     None),
    ("--ledger-compile-factor", "3", {"compile_s": 5.0}, "compile_blowups"),
    ("--ledger-compile-floor-s", "6", {"compile_s": 5.0},
     "compile_blowups"),
    ("--ledger-memory-factor", "1.5", {"temp_bytes": 50}, "memory_growth")])
def test_tail_ledger_flags_bound_the_verdict(tmp_path, capsys, flag, value,
                                             row, clears):
    """`tail --ledger-*`: rc 8 on the run's drift against the baseline,
    rc 0 once the flag's bound admits it; a missing or empty baseline
    is an error, never rc 0."""
    base = _ledger_dir(str(tmp_path / "base"))
    run = _ledger_dir(str(tmp_path / "run"), **row)
    gate = ["tail", "--log-dir", run, "--ledger-baseline", base]
    assert cli.main(gate) == 8
    verdict = json.loads(capsys.readouterr().out)["ledger_diff"]
    assert verdict["failed"] and verdict["compared"] == 1
    if value is None:  # the baseline's own errors
        assert verdict["fingerprint_drift"][0]["run"] == "fedcba9876543210"
        assert cli.main(["tail", "--log-dir", run, "--ledger-baseline",
                         base + "/ledger.jsonl"]) == 8
        with pytest.raises(SystemExit, match="does not exist"):
            cli.main(["tail", "--log-dir", run, "--ledger-baseline",
                      str(tmp_path / "missing.jsonl")])
        open(tmp_path / "empty.jsonl", "w").close()
        with pytest.raises(SystemExit, match="no ledger rows"):
            cli.main(["tail", "--log-dir", run, "--ledger-baseline",
                      str(tmp_path / "empty.jsonl")])
        # a run that recorded no ledger gives no verdict: an error too
        bare = _ledger_dir(str(tmp_path / "bare"))
        os.remove(os.path.join(bare, "ledger.jsonl"))
        with pytest.raises(SystemExit, match="no verdict"):
            cli.main(["tail", "--log-dir", bare, "--ledger-baseline", base])
        return
    assert [e["name"] for e in verdict[clears]] == ["train_step"]
    # the rc-8 call kept its verdict as a critical ledger_drift bundle,
    # which holds rc 9 once the drift is admitted, until acknowledged
    assert cli.main(gate + [flag, value]) == 9
    summary = json.loads(capsys.readouterr().out)
    assert not summary["ledger_diff"]["failed"]
    assert summary["ledger_diff"][clears] == []
    assert summary["incidents"]["by_kind"] == {"ledger_drift": 1}
    assert cli.main(["incidents", "ack", "--log-dir", run]) == 0
    capsys.readouterr()
    assert cli.main(gate + [flag, value]) == 0


def test_the_command_line_computes_float32_in_float32(capsys):
    """`cli.main` turns TF32 off for cuDNN and cuBLAS before it builds
    anything (PyTorch's default lets cuDNN compute float32 convolutions
    in TF32 on the card); the cheapest verb shows it."""
    import torch

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        assert cli.main(["config"]) == 0
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    capsys.readouterr()


def test_unported_model_raises_naming_its_item(tmp_path, capsys):
    # every model is ported: the ucf101 preset's st_single trains (item
    # 9.4; the synthetic dataset's labels), a step at 32x32; a setting
    # still unported raises, naming its item
    assert cli.main(["train", "--preset", "ucf101", "--synthetic",
                     "--device", "cpu", "--steps", "1",
                     "--set", "data.image_size=[32,32]",
                     "--set", "data.batch_size=2",
                     "--set", "train.eval_every=0",
                     "--set", "train.nan_guard=false",
                     "--log-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.strip()
    shutil.rmtree(tmp_path / "ckpt")  # 0.4 GB: fc7 and the trunk
    # (the recipe is ported, item 9.5, and the elastic pool, item 10:
    # spatial context parallelism is not)
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["train", "--preset", "ucf101", "--synthetic",
                  "--device", "cpu", "--set", "mesh.spatial=2",
                  "--log-dir", str(tmp_path / "r")])


@pytest.mark.parametrize("flags,device", [
    ([], "cuda"), (["--device", "cuda"], "cuda"),
    (["--device", "cpu"], "cpu")])
def test_train_elastic_hands_its_device_to_the_pool(tmp_path, monkeypatch,
                                                    flags, device):
    """`train --elastic N` gives the coordinator its own --device (cuda
    by default, as every entry point), whatever elastic.virtual_devices
    says (1 by default)."""
    from deepof_tpu_torch.train import elastic

    calls = []
    monkeypatch.setattr(elastic, "run_elastic",
                        lambda cfg, hosts, max_steps, device:
                        calls.append(device) or 0)
    assert cli.main(["train", "--synthetic", "--model", "flownet_c",
                     "--elastic", "3", "--max-steps", "100", *flags,
                     "--set", "elastic.virtual_devices=1",
                     "--log-dir", str(tmp_path / "el")]) == 0
    assert calls == [device]


def test_an_elastic_config_raises_naming_item_10(tmp_path, monkeypatch):
    """F24, closed by the elastic pool's port (item 10): the JAX `train`
    reads `elastic.hosts` as the world size when `--elastic` is absent,
    and so does the port's: a config of 2 hosts starts the coordinator
    (`train/elastic.py::run_elastic`, stubbed here), hosts 0 and 1 load
    and train one process, and the section is carried, not dropped."""
    from deepof_tpu_torch.train import elastic

    calls = []
    monkeypatch.setattr(elastic, "run_elastic",
                        lambda cfg, hosts, max_steps, device: calls.append(
                            (cfg.elastic.hosts, hosts, max_steps, device))
                        or 0)
    assert config_from_dict({"elastic": {"hosts": 4}}).elastic.hosts == 4
    path = tmp_path / "elastic.json"
    path.write_text(json.dumps({"model": "flownet_s",
                                "elastic": {"hosts": 2}}))
    assert cli.main(["train", "--config-json", str(path), "--synthetic",
                     "--device", "cpu", "--max-steps", "5",
                     "--log-dir", str(tmp_path / "r")]) == 0
    assert calls == [(2, 2, 5, "cpu")]
    for hosts in (0, 1):
        assert config_from_dict(
            {"elastic": {"hosts": hosts}}).elastic.hosts == hosts
    # an elastic child (--host-index) trains itself, on its --device,
    # to its absolute target step; it never coordinates
    path.write_text(json.dumps({
        "model": "flownet_s", "width_mult": 0.25,
        "elastic": {"hosts": 2, "num_hosts": 2, "target_step": 1,
                    "virtual_devices": 1}}))
    assert cli.main(["train", "--config-json", str(path), "--synthetic",
                     "--host-index", "0", "--device", "cpu",
                     "--set", "data.batch_size=2",
                     "--set", "obs.heartbeat=false",
                     "--log-dir", str(tmp_path / "c")]) == 0
    assert calls == [(2, 2, 5, "cpu")]
    assert verify_run(str(tmp_path / "c"))["valid_steps"][-1] == 1
