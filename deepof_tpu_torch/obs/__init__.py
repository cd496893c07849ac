"""Observability of the training loop (port of the training half of
`deepof_tpu/obs/`):

  trace.py      ring-buffered span tracer writing a Chrome trace-event
                timeline (a copy; stdlib-only);
  heartbeat.py  heartbeat.json rewritten in the background, and the
                wedge watchdog (a copy, with its device memory from
                telemetry.py);
  telemetry.py  process RSS, CUDA memory, and FLOPs per optimizer step
                counted by `torch.utils.flop_counter.FlopCounterMode`;
  export.py     fixed-bucket latency histograms, Prometheus text and the
                SLO arithmetic of the serving engine (a copy);
  registry.py   the merge kind of each serve, fleet, autoscale and
                degrade key, by which the fleet's router merges its
                replicas' stats (a copy, trimmed).

The ledger, the incident recorder, aggregate and quality are not ported
(ROADMAP Queue A item 11).
"""
