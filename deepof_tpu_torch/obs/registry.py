"""The observability schema of the serving fleet: ONE declaration per
counter key (a copy of `deepof_tpu/obs/registry.py`, trimmed to the
planes this package has).

Every key of the replicas' engine block (`serve_*`, `deadline_*`,
`degrade_*` downgrades), the router's and supervisor's `fleet_*` block,
the autoscaler's `fleet_autoscale_*` block and the brownout
controller's `degrade_*` block declares its **merge kind** (how N
processes' values combine into one fleet-wide value) and its **owner**
(which subsystem writes it). `Router.scrape_replicas` merges the
replicas' `/healthz` blocks by these kinds (`merge_stats_blocks`), so
a registered counter joins the fleet's `/metrics` with no edit there.
The quality (`serve_quality_*`) and incident (`incident_*`, `alert_*`)
keys are declared too, and so are the training-resilience keys (whose
`resilience` flag makes them the `resilience` block of `analyze` and
`tail`, in declaration order: `resilience_keys`), the `fault_*` family,
the executable ledger's `exec_*` keys (`obs/ledger.py`, with the
artifact plane's artifact, index and deep-verify counters,
`serve/artifacts.py`), the elastic coordinator's `elastic_*` block
(`train/elastic.py`), the input pipeline's `data_*` keys
(`train/loop.py::resilience_stats`) and the staged recipe's `recipe_*`
keys. This package's keys are the JAX package's, one for one: none of
them is its own and none is missing.

Merge kinds:

  sum      additive event counter — fleet value = sum of processes'
  max      high-water mark — fleet value = max of processes'
  gauge    per-process configuration or instantaneous reading (replica
           count, queue depth ceiling) — never merged; a 2-replica
           fleet does not have max_batch 16
  bool     flag — never merged (summing booleans exports nonsense)
  hist     fixed-bucket LatencyHistogram snapshot (obs/export.py) —
           merged EXACTLY bucket-wise via merge_hists, per key
  map      dict of numeric sub-counters (per-tier, per-replica) —
           merged key-wise by sum
  state    dict of string states (replica state machines) — never
           merged (states are per-process identity)
  derived  computed from other keys (percentiles, rates, means, SLO
           blocks) — never merged; the honest fleet figure is
           re-derived from the merged histogram/counters

Stdlib-only: the supervisor imports it.
"""

from __future__ import annotations

from dataclasses import dataclass

MERGE_KINDS: frozenset[str] = frozenset((
    "sum", "max", "gauge", "bool", "hist", "map", "state", "derived"))


@dataclass(frozen=True)
class Key:
    """One observability key's schema entry.

    name: the full key as written into stats dicts ("serve_requests");
        for a prefix family, the shared prefix ("fault_").
    kind: merge kind (see module docstring).
    owner: the subsystem that writes it — engine | session | router |
        fleet | degrade | quality | incident | train | data | ckpt |
        faults | ledger | elastic | recipe.
    prefix: True = family entry: every key starting with `name`
        resolves here (the per-site fault counts). Exact entries win.
    resilience: True = part of the resilience-counter surface analyze/
        tail show as the `resilience` block (nonzero values only).
    """

    name: str
    kind: str
    owner: str
    prefix: bool = False
    resilience: bool = False


def _keys(owner: str, kind: str, *names: str, **kw) -> list[Key]:
    return [Key(n, kind, owner, **kw) for n in names]


_ENTRIES: list[Key] = [
    # ------------------------------------------ serve_* (engine core)
    *_keys("engine", "sum",
           "serve_requests", "serve_responses", "serve_errors",
           "serve_server_errors", "serve_batches",
           "serve_dispatch_failures", "serve_bucket_splits",
           "serve_tier_splits", "serve_warm_splits",
           "serve_timeout_flushes",
           # instantaneous per-replica depth, but the sum IS the honest
           # fleet figure: total requests queued across the pool
           "serve_queue_depth"),
    Key("serve_max_queue_depth", "max", "engine"),
    *_keys("engine", "gauge",
           "serve_max_batch", "serve_buckets", "serve_tiers",
           "serve_last_occupancy"),
    *_keys("engine", "map",
           "serve_requests_by_tier", "serve_responses_by_tier"),
    *_keys("engine", "derived",
           "serve_occupancy_mean", "serve_latency_p50_ms",
           "serve_latency_p99_ms", "serve_requests_per_s", "serve_slo"),
    Key("serve_latency_hist", "hist", "engine"),
    # ------------------------------- serve_sessions_* (session store)
    *_keys("session", "sum",
           "serve_sessions_active", "serve_sessions_created",
           "serve_sessions_resumed", "serve_sessions_expired",
           "serve_sessions_evicted", "serve_sessions_deleted",
           "serve_sessions_rebucketed", "serve_sessions_frames",
           "serve_sessions_steps", "serve_sessions_decode_saved",
           "serve_sessions_warm_steps", "serve_sessions_cold_fallbacks"),
    Key("serve_sessions_warm_start", "bool", "session"),
    Key("serve_session_latency_hist", "hist", "session"),
    *_keys("session", "derived",
           "serve_session_latency_p50_ms", "serve_session_latency_p99_ms"),
    # --------------------- serve_quality_* (label-free flow quality,
    # obs/quality.py: sampled photometric/census/smoothness proxies)
    *_keys("quality", "sum",
           "serve_quality_sampled", "serve_quality_dropped",
           "serve_quality_scored", "serve_quality_errors",
           "serve_quality_breaches"),
    Key("serve_quality_sample_rate", "gauge", "quality"),
    *_keys("quality", "map",
           "serve_quality_scored_by_key", "serve_quality_photo_sum_by_key",
           "serve_quality_smooth_sum_by_key",
           "serve_quality_census_sum_by_key"),
    *_keys("quality", "hist",
           "serve_quality_photo_hist", "serve_quality_smooth_hist",
           "serve_quality_census_hist"),
    *_keys("quality", "derived",
           "serve_quality", "serve_quality_photo_p50",
           "serve_quality_smooth_p50", "serve_quality_census_p50"),
    # ------------------------------ serve_* written by the fleet scrape
    *_keys("router", "sum",
           "serve_replicas_scraped", "serve_replicas_scrape_failed"),
    # --------------------------------------- fleet_* (router half)
    *_keys("router", "sum",
           "fleet_requests", "fleet_responses", "fleet_errors",
           "fleet_server_errors", "fleet_failovers", "fleet_retries",
           "fleet_shed", "fleet_unavailable",
           "fleet_session_primes", "fleet_session_steps",
           "fleet_session_lost", "fleet_session_evicted",
           "fleet_session_expired"),
    *_keys("router", "gauge", "fleet_in_flight", "fleet_sessions_sticky"),
    # routed counts folded out of the per-index map when a slot retires
    # (autoscale scale-down): keeps fleet_routed bounded by the active
    # pool while the total stays monotonic
    Key("fleet_routed_retired", "sum", "router"),
    Key("fleet_routed", "map", "router"),
    Key("fleet_draining", "bool", "router"),
    Key("fleet_latency_hist", "hist", "router"),
    Key("fleet_slo", "derived", "router"),
    # load trend from the router's per-second completion buckets (the
    # predictive autoscaler's signal): recent requests/s and its
    # least-squares slope (req/s per second) — instantaneous, per-router
    *_keys("router", "gauge", "fleet_load_rps", "fleet_load_slope"),
    # ----------------------------------- fleet_* (supervisor half)
    *_keys("fleet", "gauge", "fleet_replicas", "fleet_ready"),
    Key("fleet_states", "state", "fleet"),
    *_keys("fleet", "sum",
           "fleet_evictions", "fleet_crashes", "fleet_clean_exits",
           "fleet_wedge_evictions", "fleet_stale_evictions",
           "fleet_spawn_failures", "fleet_respawns", "fleet_broken",
           "fleet_kill_escalations",
           # graceful scale-down departures (autoscaler): deliberately
           # NOT an eviction — evictions stay about sickness,
           # retirement is the pool doing its job
           "fleet_retired"),
    # ---------------------- fleet_autoscale_* (serve/autoscale.py):
    # the SLO-driven load-follower's own block — scale events, streak
    # ticks, and the pool bounds it scales between
    Key("fleet_autoscale_enabled", "bool", "fleet"),
    *_keys("fleet", "gauge",
           "fleet_autoscale_min", "fleet_autoscale_max",
           "fleet_autoscale_last_event_s"),
    *_keys("fleet", "sum",
           "fleet_autoscale_up", "fleet_autoscale_down",
           "fleet_autoscale_blocked_max",
           "fleet_autoscale_pressure_ticks", "fleet_autoscale_idle_ticks",
           # ticks where the PREDICTIVE load-slope signal
           # (fleet.autoscale_up_slope) was the pressure source before
           # any shed/breach landed — how often the pool scaled ahead
           # of the load instead of behind it
           "fleet_autoscale_slope_ticks"),
    # -------------- deadline_* / degrade_* (the brownout plane:
    # serve/degrade.py + the deadline gates in engine/server/router).
    # Names are DISJOINT by owner on purpose: the /metrics surface
    # dict-merges router.stats() with the replica scrape, so a name two
    # owners both wrote would silently clobber.
    # engine-owned (per-replica, summed by the fleet scrape): budgeted
    # arrivals, where expired budgets died, and requests actually served
    # on a downgraded operating point
    *_keys("engine", "sum",
           "deadline_requests", "deadline_enqueue_expired",
           "deadline_flush_expired", "deadline_wait_expired",
           "degrade_tier_downgrades", "degrade_bucket_downgrades"),
    # router-owned: admission/failover expiries + L3 low-priority sheds
    *_keys("router", "sum",
           "deadline_admission_expired", "degrade_shed_low"),
    # controller-owned (serve/degrade.py stats block)
    Key("degrade_enabled", "bool", "degrade"),
    *_keys("degrade", "gauge", "degrade_level", "degrade_l3_age_s"),
    Key("degrade_level_name", "state", "degrade"),
    *_keys("degrade", "sum",
           "degrade_transitions", "degrade_escalations",
           "degrade_recoveries", "degrade_l3_entries"),
    # sustained-L3 verdict (L3 held past degrade.l3_sustained_s)
    Key("degrade_l3_sustained", "bool", "degrade"),
    Key("degrade_last_reason", "state", "degrade"),
    # ------------------------------ fault_* (resilience/faults.py):
    # per-site injection counts are dynamically named — one family
    Key("fault_", "sum", "faults", prefix=True, resilience=True),
    # ------------------- the resilience surface (train records and the
    # heartbeat; analyze/tail's `resilience` block). Declaration order
    # is the block's key order (resilience_keys), the JAX package's
    *_keys("train", "sum", "skipped_updates", "rollbacks",
           resilience=True),
    *_keys("data", "sum",
           "data_sample_retries", "data_quarantined", "data_substituted",
           "data_retries", resilience=True),
    Key("pipeline_fetch_retries", "sum", "data", resilience=True),
    *_keys("ckpt", "sum",
           "ckpt_save_failures", "ckpt_restore_failures",
           "ckpt_restore_fallbacks", "ckpt_verify_failures",
           resilience=True),
    # non-resilience ckpt counter (rides the same ckpt_ stats prefix)
    Key("ckpt_saves", "sum", "ckpt"),
    # ------------------- exec_* (obs/ledger.py, the executable ledger:
    # the op-trace fingerprint, first-call seconds, library builds and
    # memory of each executable's first call). Counters ride every
    # stats surface that
    # carries the engine block (heartbeat, /metrics, the fleet scrape,
    # analyze/tail); the fingerprint map is per-process identity and the
    # MFU is re-derived, never merged.
    *_keys("ledger", "sum",
           "exec_lowerings", "exec_recompiles", "exec_compile_s",
           "exec_cache_hits", "exec_cache_misses", "exec_dispatches",
           "exec_dispatch_s",
           # artifact plane (serve/artifacts.py): traced executables
           # whose fingerprint the store holds (hits) or not (misses),
           # and store entries or libraries that failed a gate, the
           # library then built from source (rejects: always loud)
           "exec_artifact_hits", "exec_artifact_misses",
           "exec_artifact_rejects",
           # the index (trace-free boot): executables resolved by key
           # with no trace (hits), no entry for the key (misses: the
           # traced path), an entry that failed a trust gate: forged,
           # cross-wired, stale target, version skew, a target failing
           # the store's gates (rejects: always loud)
           "exec_index_hits", "exec_index_misses", "exec_index_rejects",
           # deep verify: re-traces after serving starts that confirmed
           # an index-resolved executable's fingerprint (ok) or not
           # (demoted, loudly). Each replica verifies its own boot once,
           # so the fleet's sum stays honest.
           "exec_deep_verify_ok", "exec_deep_verify_demoted"),
    # index-resolved executables still awaiting their re-trace; a
    # fleet sum is the pool's unverified count
    Key("exec_deep_verify_pending", "sum", "ledger"),
    Key("exec_executables", "gauge", "ledger"),
    Key("exec_fingerprints", "state", "ledger"),
    Key("exec_mfu_nominal", "derived", "ledger"),
    # ------------------ elastic_* (train/elastic.py, the coordinator's
    # stats block)
    *_keys("elastic", "gauge",
           "elastic_hosts", "elastic_live", "elastic_done",
           "elastic_generation", "elastic_resumed_step",
           "elastic_target_step", "elastic_last_reform_s"),
    *_keys("elastic", "sum",
           "elastic_reforms", "elastic_lost_hosts", "elastic_preemptions",
           "elastic_steps_lost", "elastic_spawns", "elastic_respawns",
           "elastic_kill_escalations"),
    Key("elastic_max_step", "max", "elastic"),
    Key("elastic_states", "state", "elastic"),
    # --------------------- data_* (the pipeline, prefetch and healer
    # blocks, prefixed by train/loop.py::resilience_stats)
    Key("data_num_workers", "gauge", "data"),
    *_keys("data", "sum",
           "data_batches", "data_assemble_s", "data_waits", "data_wait_s"),
    *_keys("data", "derived", "data_assemble_s_mean", "data_worker_util"),
    *_keys("data", "gauge", "data_queue_depth", "data_staged_depth"),
    *_keys("data", "max", "data_max_queue_depth", "data_max_staged_depth"),
    # the decoded-image cache's counters, under the same data_ prefix
    Key("data_decode_cache_", "sum", "data", prefix=True),
    # ------------------- recipe_* (train/recipe.py, the staged recipe):
    # the active stage (per-process identity, never merged), advances,
    # the mixture's draws by member dataset and the newest advance's
    # cause ("steps" | "plateau"); the Trainer's extra_stats hook puts
    # them in the heartbeat, the train records and the fit summary
    *_keys("recipe", "gauge", "recipe_stage", "recipe_stages"),
    Key("recipe_advances", "sum", "recipe"),
    Key("recipe_draws_by_dataset", "map", "recipe"),
    Key("recipe_last_trigger", "state", "recipe"),
    Key("recipe_stage_name", "state", "recipe"),
    # --------------- incident_*/alert_* (obs/incident.py, the flight
    # recorder): capture, dedup and rate-limit accounting and the alert
    # rules
    *_keys("incident", "sum",
           "incident_captured", "incident_collected",
           "incident_deduped", "incident_rate_limited",
           "incident_capture_errors"),
    Key("incident_by_kind", "map", "incident"),
    Key("incident_last_kind", "state", "incident"),
    Key("alert_rules", "gauge", "incident"),
    Key("alert_firings", "sum", "incident"),
    Key("alert_errors", "sum", "incident"),
]

#: name -> Key for exact entries (validated no-duplicate below).
REGISTRY: dict[str, Key] = {}
#: prefix families, longest prefix first (most specific wins).
FAMILIES: list[Key] = []

for _k in _ENTRIES:
    if _k.kind not in MERGE_KINDS:
        raise ValueError(f"registry: bad kind {_k.kind!r} for {_k.name!r}")
    if _k.prefix:
        FAMILIES.append(_k)
    else:
        if _k.name in REGISTRY:
            raise ValueError(f"registry: duplicate key {_k.name!r}")
        REGISTRY[_k.name] = _k
FAMILIES.sort(key=lambda k: -len(k.name))


def lookup(name: str) -> Key | None:
    """The schema entry for a stats key: exact match first, then the
    longest matching prefix family. None = unregistered."""
    hit = REGISTRY.get(name)
    if hit is not None:
        return hit
    for fam in FAMILIES:
        if name.startswith(fam.name):
            return fam
    return None


def merge_kind(name: str) -> str | None:
    """The key's merge kind, or None when unregistered."""
    hit = lookup(name)
    return hit.kind if hit is not None else None


def resilience_keys() -> tuple[str, ...]:
    """The exact-named resilience-surface counters, in declaration order
    (`analyze`'s `resilience` block; the fault_* family is surfaced by
    its prefix there)."""
    return tuple(k.name for k in _ENTRIES
                 if k.resilience and not k.prefix)


# ------------------------------------------------- generic dict merging


def merge_stats_blocks(blocks: list[dict], prefix: str = "") -> dict:
    """Registry-driven merge of N processes' flat stats dicts into one
    fleet-wide dict — the aggregation primitive behind
    `Router.scrape_replicas` and `analyze.aggregate_processes`.

    prefix: keys in `blocks` may be stored stripped of their registry
    prefix; lookups prepend it.

    Per key, by registry kind: sum adds, max takes the maximum, map
    merges key-wise by sum, hist merges exactly (foreign-bucket
    snapshots are skipped, never a crash), gauge/bool/state/derived are
    dropped (their fleet-wide value is meaningless or re-derived).
    UNREGISTERED keys fall back to the historical suffix heuristic —
    numeric values sum unless they look derived (_p50_ms/_p99_ms/
    _per_s/_mean) — so scraping a newer replica that exports a key this
    process's registry predates degrades to the old behavior instead of
    dropping data silently.
    """
    from .export import is_hist_snapshot, merge_hists

    sums: dict = {}
    maxima: dict = {}
    maps: dict[str, dict] = {}
    hists: dict[str, list] = {}
    for block in blocks:
        if not block:
            continue
        for k, v in block.items():
            kind = merge_kind(prefix + k)
            if kind is None:  # unregistered: the historical heuristic
                if is_hist_snapshot(v):
                    kind = "hist"
                elif isinstance(v, bool):
                    kind = "bool"
                elif isinstance(v, (int, float)):
                    kind = ("derived" if k.endswith(
                        ("_p50_ms", "_p99_ms", "_per_s", "_mean"))
                        else "sum")
                elif isinstance(v, dict):
                    kind = "map"
                else:
                    continue
            if kind == "sum" and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                sums[k] = sums.get(k, 0) + v
            elif kind == "max" and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                maxima[k] = max(maxima.get(k, 0), v)
            elif kind == "map" and isinstance(v, dict):
                tgt = maps.setdefault(k, {})
                for sub, n in v.items():
                    if isinstance(n, (int, float)) \
                            and not isinstance(n, bool):
                        tgt[sub] = tgt.get(sub, 0) + n
            elif kind == "hist" and is_hist_snapshot(v):
                hists.setdefault(k, []).append(v)
            # gauge / bool / state / derived: deliberately dropped
    out = {**sums, **maxima}
    # a map with no numeric sub-values merged (e.g. an unregistered
    # state-style dict from a newer replica) is dropped, not exported
    # as a meaningless empty {} — matching the retired implementation
    out.update({k: dict(v) for k, v in maps.items() if v})
    for k, hs in hists.items():
        try:
            out[k] = merge_hists(hs)
        except ValueError:
            pass  # foreign/old-format snapshot: skip, never crash
    return out
