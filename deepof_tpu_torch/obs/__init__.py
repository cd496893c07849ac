"""Observability of training and serving (port of `deepof_tpu/obs/`):

  trace.py      ring-buffered span tracer writing a Chrome trace-event
                timeline (a copy; stdlib-only);
  heartbeat.py  heartbeat.json rewritten in the background, and the
                wedge watchdog (a copy, with its device memory from
                telemetry.py);
  telemetry.py  process RSS, CUDA memory, and FLOPs per optimizer step
                counted by `torch.utils.flop_counter.FlopCounterMode`;
  export.py     fixed-bucket latency histograms, Prometheus text and the
                SLO arithmetic of the serving engine (a copy);
  registry.py   the merge kind of each serve, quality, fleet,
                autoscale, degrade and incident key, by which the
                fleet's router merges its replicas' stats (a copy,
                trimmed);
  quality.py    label-free quality scoring of sampled served requests
                (warp, census, smoothness proxies; the drift verdict);
  incident.py   the incident plane: evidence bundles committed when a
                verdict fires, alert rules, and the `incidents` verb's
                triage (a copy; stdlib-only);
  aggregate.py  one merged Chrome trace of a supervised run's process
                tree, requests chained by id across processes (a copy;
                stdlib-only; `analyze` and `tail --fleet` read the tree
                through `discover_processes`).

The executable ledger is not ported (ROADMAP Queue A item 8).
"""
