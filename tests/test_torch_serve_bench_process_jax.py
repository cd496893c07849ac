"""The port's serving bench's process modes and autoscaling drill
(`deepof_tpu_torch/tools/serve_bench.py`, `tools/autoscale_drill.py`)
against the JAX package's tools of the same names, loaded by importlib
as the JAX package's own tests load `tools/serve_bench.py` (the drill's
keys read from its source: importing it puts the repo's `tools/` on
`sys.path`), on the CPU:

  - the four `*_REQUIRED_KEYS` tuples of the process modes and the
    drill's `REQUIRED_KEYS`: equal;
  - each mode's function's defaults: equal to the JAX function's, but
    the port's own `device` and `overrides`;
  - `_flow_body`: the port writes its PNGs with `io/png.py` where the
    JAX tool calls `cv2.imencode`; the bytes differ, the two images of
    each body decode (cv2) to the same pixels, bit for bit.
"""

import ast
import base64
import importlib.util
import inspect
import json
import os

import cv2
import numpy as np
import pytest

from deepof_tpu_torch.tools import autoscale_drill
from deepof_tpu_torch.tools import serve_bench as sb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("FLEET_REQUIRED_KEYS", "RAMP_REQUIRED_KEYS",
        "ARTIFACT_COLD_REQUIRED_KEYS", "BROWNOUT_REQUIRED_KEYS")
MODES = ("fleet_bench", "ramp_bench", "brownout_bench",
         "artifact_cold_bench")


@pytest.fixture(scope="module")
def jsb():
    path = os.path.join(ROOT, "tools", "serve_bench.py")
    spec = importlib.util.spec_from_file_location("serve_bench_jax_p", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", KEYS)
def test_required_keys_equal_jax(jsb, name):
    assert getattr(sb, name) == getattr(jsb, name)


def test_drill_required_keys_equal_jax():
    with open(os.path.join(ROOT, "tools", "autoscale_drill.py")) as f:
        tree = ast.parse(f.read())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "REQUIRED_KEYS")
    assert autoscale_drill.REQUIRED_KEYS == want


@pytest.mark.parametrize("name", MODES)
def test_mode_defaults_equal_jax(jsb, name):
    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()}

    got, want = defaults(getattr(sb, name)), defaults(getattr(jsb, name))
    assert {k: v for k, v in got.items()
            if k not in ("device", "overrides")} == want


@pytest.mark.parametrize("hw", [(30, 60), (48, 96)])
def test_flow_body_decodes_to_the_jax_pixels(jsb, hw):
    got, want = (json.loads(mod._flow_body(hw)) for mod in (sb, jsb))
    for key in ("prev", "next"):
        a, b = (cv2.imdecode(np.frombuffer(base64.b64decode(d[key]),
                                           np.uint8), cv2.IMREAD_COLOR)
                for d in (got, want))
        assert a.shape == (*hw, 3)
        np.testing.assert_array_equal(a, b)
