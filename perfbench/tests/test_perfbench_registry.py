"""Every configuration, cell, traffic mix, driver and metric is found by
name, and an unknown name is refused with the names that exist."""

import json

import pytest

from perfbench import registry
from perfbench.tests import small

BENCH = small.bench()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(cell):
    entry = registry.workload(BENCH, cell)
    config = registry.config(BENCH, entry["config"])
    traffic = registry.traffic(entry["traffic"])
    assert config["name"] == entry["config"]
    assert hasattr(registry.driver(traffic["driver"]), "Driver")
    assert isinstance(registry.limits(cell), dict)
    kinds = [m["name"] for kind in ("end_to_end", "per_layer")
             for m in registry.metrics_of(BENCH, cell, kind)]
    assert "setup_s" in kinds and len(kinds) >= 3
    for name in kinds:
        assert callable(registry.metric_reader(name))


@pytest.mark.parametrize("lookup", [
    lambda: registry.workload(BENCH, "no.such.cell"),
    lambda: registry.config(BENCH, "no-such-config"),
    lambda: registry.traffic("no.such.mix"),
    lambda: registry.limits("no.such.cell"),
    lambda: registry.driver("no_such_driver"),
    lambda: registry.metric_reader("no_such_metric"),
])
def test_unknown_names_are_refused_with_the_known_ones(lookup):
    with pytest.raises(LookupError, match="unknown .*known: "):
        lookup()


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        reported = {m["name"] for m in registry.metrics_of(BENCH, cell["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.metrics_of(BENCH, cell["name"], "per_layer")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  registry.metrics_of(BENCH, cell, "end_to_end")}
    assert len(json.dumps(BENCH)) < 64 * 1024
