"""The port's synthetic-fit tool (`python -m
deepof_tpu_torch.tools.synthetic_fit`) against the JAX package's
`tools/synthetic_fit.py`, at a tiny size on the CPU (FlowNet-S width
0.25, 64x64, batch 2, 3 steps, an eval every 2): the `meta`, `eval` and
`outcome` records carry the JAX tool's keys (read off its committed
artifact), the zero-flow EPE is the one the JAX `SyntheticData` gives
on the same val seeds, a rerun resumes from the checkpoint of the last
eval, and another setting starts the lineage afresh."""

import json
import os

import numpy as np
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSyntheticData
from deepof_tpu_torch.tools import synthetic_fit

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: an artifact of the JAX tool: its records' keys
JAX_ARTIFACT = os.path.join(ROOT, "artifacts",
                            "synthetic_fit_cpu_inc_affine.jsonl")
TINY = ["--device", "cpu", "--model", "flownet_s", "--width-mult", "0.25",
        "--batch", "2", "--steps", "3", "--eval-every", "2", "--style",
        "affine", "--blobs", "40", "--num-train", "64"]


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _keys(records):
    return {r["kind"]: set(r) for r in records}


def test_the_tool_writes_the_jax_records_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "fit.jsonl")
    # the budget ends before the target: rc 1, as the JAX tool exits
    assert synthetic_fit.main([*TINY, "--out", out]) == 1
    recs = _records(out)
    assert [r["kind"] for r in recs] == ["meta", "eval", "eval", "outcome"]
    assert _keys(recs) == _keys(_records(JAX_ARTIFACT))
    meta, ev0, ev2, outcome = recs
    assert (ev0["step"], ev2["step"], outcome["stopped_at_step"]) == (0, 2, 3)
    assert meta["resumed_from"] == 0 and meta["width_mult"] == 0.25
    assert outcome["best_aee"] == min(ev0["aee"], ev2["aee"])
    assert outcome["note"] == "step budget exhausted before target"
    # the zero-flow baseline is the JAX dataset's on the same val seeds
    jax_ds = JaxSyntheticData(
        JaxDataConfig(dataset="synthetic", image_size=(64, 64),
                      gt_size=(64, 64), batch_size=2),
        num_train=64, max_shift=4.0, style="affine", n_blobs=40,
        feature_scale=16)
    flows = np.concatenate([jax_ds.sample_val(8, i)["flow"]
                            for i in range(2)])
    want = float(np.sqrt((flows ** 2).sum(-1)).mean())
    assert meta["zero_flow_epe"] == outcome["zero_flow_epe"] == \
        round(want, 4)
    assert os.path.isfile(out + ".ckpt/config_fingerprint.json")

    # a rerun resumes from step 2's checkpoint and appends
    assert synthetic_fit.main([*TINY, "--out", out]) == 1
    more = _records(out)[4:]
    assert [r["kind"] for r in more] == ["meta", "eval", "outcome"]
    assert more[0]["resumed_from"] == 2 and more[1]["step"] == 2
    assert more[1]["aee"] == ev2["aee"]  # the restored weights
    assert more[2]["best_aee"] == outcome["best_aee"]  # the lineage's
    # another setting starts afresh; a target met removes the lineage
    assert synthetic_fit.main([*TINY, "--out", out, "--lr", "1e-4",
                               "--target-epe", "1e9"]) == 0
    fresh = _records(out)
    assert fresh[0]["resumed_from"] == 0 and len(fresh) == 3
    assert fresh[-1]["note"] == "target 1000000000.0 px reached"
    assert not os.path.exists(out + ".ckpt")
    capsys.readouterr()
