"""`python -m deepof_tpu_torch serve` on the CPU: the HTTP server in a
process of its own (a checkpoint of a small FlowNet-C written first),
its "serving" line, one request, /metrics, and SIGTERM draining to exit
code 0 with the serve heartbeat and the final serve record written; and
offline mode's `.flo` files against `predict`'s for the same pairs
(bit for bit: the same engine on the same weights)."""

import base64
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from deepof_tpu_torch import cli
from deepof_tpu_torch.io.flo import read_flo
from deepof_tpu_torch.io.png import png_bytes, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--model", "flownet_c", "--device", "cpu", "--set",
         "width_mult=0.25", "--set", "corr_max_disp=4", "--set",
         "corr_stride=1", "--set", "data.image_size=[64,64]", "--set",
         "obs.heartbeat_period_s=0.1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("serve_run")
    assert cli.main(["train", "--synthetic", *SMALL, "--steps", "1",
                     "--log-dir", str(log_dir)]) == 0
    return log_dir


def test_serve_answers_and_drains_on_sigterm(run):
    import http.client

    proc = subprocess.Popen(
        [sys.executable, "-m", "deepof_tpu_torch", "serve", *SMALL,
         "--set", "serve.port=0", "--log-dir", str(run)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line: dict = {}
        while "serving" not in line:  # the first JSON line it prints
            text = proc.stdout.readline()
            assert text, f"serve exited: {proc.wait()} {proc.stderr.read()}"
            line = json.loads(text) if text.startswith("{") else {}
        host, port = line["serving"][len("http://"):].split(":")
        assert line["buckets"] == [[64, 64]] and line["precisions"] == ["f32"]
        rs = np.random.RandomState(0)
        img = [base64.b64encode(png_bytes(rs.randint(
            0, 256, (48, 80, 3), dtype=np.uint8))).decode()
            for _ in range(2)]
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("POST", "/v1/flow", json.dumps(
            {"prev": img[0], "next": img[1]}), {"X-Request-Id": "q1"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["shape"] == [48, 80, 2]
        assert body["request_id"] == "q1"
        conn.request("GET", "/metrics")
        assert b"deepof_serve_responses 1" in conn.getresponse().read()
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(run / "heartbeat.json") as f:
        hb = json.load(f)
    assert hb["serve_responses"] == 1 and not hb["wedged"]
    recs = [json.loads(ln) for ln in open(run / "metrics.jsonl")]
    assert recs[-1]["kind"] == "serve" and recs[-1]["serve_responses"] == 1


def test_offline_flo_files_equal_predicts(run, tmp_path, capsys):
    frames = tmp_path / "frames"
    frames.mkdir()
    rs = np.random.RandomState(1)
    for i in range(4):
        write_png(frames / f"f{i}.png",
                  rs.randint(0, 256, (64, 64, 3), dtype=np.uint8))
    assert cli.main(["serve", *SMALL, "--log-dir", str(run), "--input",
                     str(frames), "--out", str(tmp_path / "off"),
                     "--no-png"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (summary["pairs"], summary["errors"], summary["written"]) == \
        (3, 0, 3)
    names = sorted(os.listdir(frames))
    pairs = [f"{frames / a}:{frames / b}" for a, b in zip(names, names[1:])]
    assert cli.main(["predict", *SMALL, "--log-dir", str(run), "--pairs",
                     *pairs, "--out", str(tmp_path / "pred"),
                     "--no-png"]) == 0
    off, pred = sorted(os.listdir(tmp_path / "off")), sorted(
        os.listdir(tmp_path / "pred"))
    assert off == pred and len(off) == 3
    for name in off:
        assert np.array_equal(read_flo(tmp_path / "off" / name),
                              read_flo(tmp_path / "pred" / name)), name
