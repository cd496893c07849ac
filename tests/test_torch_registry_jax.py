"""The port's observability registry (`deepof_tpu_torch/obs/registry.py`)
against the JAX package's (`deepof_tpu/obs/registry.py`).

Every key the JAX package declares is declared in the port with the same
merge kind, owner, prefix flag and resilience flag, and the port declares
no key of its own. The elastic coordinator's `elastic_*` block
(`train/elastic.py::ElasticCoordinator.stats`) and the input pipeline's
`data_*` keys (`train/loop.py`'s `resilience_stats`) are what the port
writes and must find there: an alert rule on them loads
(`obs/incident.py::parse_alert_rules`), and `merge_stats_blocks` combines
two processes' blocks as JAX does (maxima for the high-water marks, sums
for the events, the gauges and states dropped). Exact comparisons: no
tolerance.
"""

import inspect
import re

import pytest

from deepof_tpu.obs import incident as jax_incident
from deepof_tpu.obs import registry as jax_registry
from deepof_tpu_torch.obs import incident
from deepof_tpu_torch.obs import registry

#: two processes' elastic and pipeline blocks: the gauges agree, the
#: high-water marks and the event counts differ
TWO_PROCESSES = [
    {"elastic_generation": 3, "elastic_max_step": 40,
     "data_max_staged_depth": 2, "data_num_workers": 4,
     "elastic_reforms": 1},
    {"elastic_generation": 3, "elastic_max_step": 38,
     "data_max_staged_depth": 3, "data_num_workers": 4,
     "elastic_reforms": 1},
]


def _schema(mod) -> dict:
    return {k.name: (k.kind, k.owner, k.prefix, k.resilience)
            for k in mod._ENTRIES}


def test_entries_equal_jax_name_for_name():
    want, got = _schema(jax_registry), _schema(registry)
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {n: got[n] for n in want if got[n] != want[n]} == {}
    assert got == want and len(got) == len(want) == 198
    # none of the elastic or data keys is a resilience key: the
    # resilience block is JAX's, in JAX's order
    assert registry.resilience_keys() == jax_registry.resilience_keys()


@pytest.mark.parametrize("key", [
    "elastic_hosts", "elastic_reforms", "elastic_max_step", "elastic_states",
    "data_num_workers", "data_batches", "data_worker_util",
    "data_max_staged_depth", "data_decode_cache_hits",
    "data_decode_cache_evictions"])
def test_lookup_and_merge_kind_equal_jax(key):
    got, want = registry.lookup(key), jax_registry.lookup(key)
    assert got is not None and want is not None
    assert (got.name, got.kind, got.owner, got.prefix) \
        == (want.name, want.kind, want.owner, want.prefix)
    assert registry.merge_kind(key) == jax_registry.merge_kind(key)


def test_every_key_the_elastic_coordinator_writes_is_declared():
    from deepof_tpu_torch.train.elastic import ElasticCoordinator

    # the keys of ElasticCoordinator.stats, read off its source (a
    # coordinator needs hosts and a run dir to build)
    keys = set(re.findall(r'"(elastic_[a-z_]+)"',
                          inspect.getsource(ElasticCoordinator.stats)))
    assert len(keys) == 16
    assert sorted(k for k in keys if registry.lookup(k) is None) == []


@pytest.mark.parametrize("spec", [
    "elastic_reforms > 0",
    "rate(elastic_lost_hosts) > 0 critical",
    "data_batches < 1",
    "staged: data_max_staged_depth >= 4 warn",
])
def test_alert_rules_on_elastic_and_data_keys_load_as_in_jax(spec):
    fields = ("spec", "name", "counter", "rate", "op", "threshold",
              "severity")
    (want,) = jax_incident.parse_alert_rules([spec])
    (got,) = incident.parse_alert_rules([spec])
    assert [getattr(got, f) for f in fields] \
        == [getattr(want, f) for f in fields]


def test_merge_of_two_processes_equals_jax():
    got = registry.merge_stats_blocks(TWO_PROCESSES)
    want = jax_registry.merge_stats_blocks(TWO_PROCESSES)
    assert got == want == {"elastic_max_step": 40,
                           "data_max_staged_depth": 3,
                           "elastic_reforms": 2}


def test_prefixed_pipeline_blocks_merge_as_jax():
    # the pipeline's own stats() keys, stripped of the data_ prefix the
    # loop adds, with the decoded-image cache's family beside them
    blocks = [{"batches": 10, "max_queue_depth": 2, "queue_depth": 1,
               "num_workers": 4, "worker_util": 0.5, "wait_s": 0.25,
               "decode_cache_hits": 7},
              {"batches": 12, "max_queue_depth": 5, "queue_depth": 0,
               "num_workers": 4, "worker_util": 0.75, "wait_s": 0.5,
               "decode_cache_hits": 1}]
    got = registry.merge_stats_blocks(blocks, prefix="data_")
    want = jax_registry.merge_stats_blocks(blocks, prefix="data_")
    assert got == want == {"batches": 22, "max_queue_depth": 5,
                           "wait_s": 0.75, "decode_cache_hits": 8}
