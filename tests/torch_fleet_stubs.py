"""Shared stubs of the fleet tests (`tests/test_torch_router.py`,
`test_torch_degrade.py`, `test_torch_fleet.py`): a duck-typed Fleet with
fixed slots, replica-shaped HTTP servers, and one config built for both
packages from the same settings."""

import base64
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu_torch.core import config as port_config
from deepof_tpu_torch.io.png import png_bytes


class StubFleet:
    """Fixed (idx, port) slots, None = not ready; `retire` drops a slot
    from both the ready set and the size, as a scale-down does."""

    def __init__(self, ports, host="127.0.0.1"):
        self.host = host
        self.ports = dict(enumerate(ports))
        self.failures = []

    @property
    def size(self):
        return len(self.ports)

    def retire(self, idx):
        del self.ports[idx]

    def ready_replicas(self):
        return [SimpleNamespace(idx=i, port=p)
                for i, p in sorted(self.ports.items()) if p is not None]

    def note_failure(self, idx):
        self.failures.append(idx)

    def stats(self):
        return {"fleet_replicas": self.size,
                "fleet_ready": len(self.ready_replicas())}

    def describe(self):
        return []


def stub_replica(delay_s=0.0, status=200, payload=None, healthz=None):
    """A replica-shaped HTTP server on port 0: POST -> optional sleep ->
    `status` with `payload` (default: who served and the deadline and
    level headers it saw); GET /healthz -> `healthz`; DELETE -> 200."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if delay_s:
                time.sleep(delay_s)
            self._reply(status, payload if payload is not None else {
                "served_by": self.server.server_address[1],
                "deadline_ms_seen": self.headers.get("X-Deadline-Ms"),
                "level_seen": self.headers.get("X-Degrade-Level")})

        def do_GET(self):  # noqa: N802
            self._reply(200, healthz or {})

        def do_DELETE(self):  # noqa: N802
            self._reply(200, {"deleted": True})

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


def both_configs(log_dir, image_size=(32, 64), serve=None, fleet=None,
                 degrade=None, faults=None):
    """(JAX config, port config) of the same settings: the JAX one built
    from its defaults, the port's read from its asdict (the keys the
    port does not read are dropped with the warning)."""
    import warnings

    cfg = JaxConfig()
    cfg = cfg.replace(
        model="flownet_s", width_mult=0.25,
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 image_size=image_size, gt_size=image_size),
        serve=dataclasses.replace(
            cfg.serve, host="127.0.0.1", port=0, **(serve or {}),
            fleet=dataclasses.replace(cfg.serve.fleet, **(fleet or {})),
            degrade=dataclasses.replace(cfg.serve.degrade,
                                        **(degrade or {}))),
        resilience=dataclasses.replace(
            cfg.resilience, faults=dataclasses.replace(
                cfg.resilience.faults, **(faults or {}))),
        train=dataclasses.replace(cfg.train, log_dir=str(log_dir),
                                  eval_amplifier=1.0,
                                  eval_clip=(-1e6, 1e6)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = port_config.config_from_dict(dataclasses.asdict(cfg))
    return cfg, port


def b64png(rs, hw=(30, 60)):
    return base64.b64encode(png_bytes(
        rs.randint(1, 255, (*hw, 3), dtype=np.uint8))).decode()


def flow_body(rs, hw=(30, 60), **extra) -> bytes:
    return json.dumps({"prev": b64png(rs, hw), "next": b64png(rs, hw),
                       **extra}).encode()
