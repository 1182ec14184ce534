"""Every file the benchmark names is there, parses and is found by name,
and BENCHMARK.json keeps to the contract's shapes."""

import re

import pytest

from perfbench import core
from perfbench import trace as tracing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(bench, section, keys):
    for entry in bench[section]:
        extra = set(entry) - keys
        assert keys <= set(entry), (entry["name"], keys - set(entry))
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer")
                         else set()), (entry["name"], extra)
    for entry in bench["configs"] + bench["workloads"]:
        why = entry["why"]
        assert 1 <= len(why) <= 200 and "\n" not in why and "\t" not in why


def test_names_units_and_sources(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = ([m["name"] for m in metrics] + [c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in SOURCES for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in bench["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_configs_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = core.load_json("configs", c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_every_config_names_a_family_that_exports_the_contract(bench):
    for c in bench["configs"]:
        cfg = core.load_json("configs", c["name"])
        assert NAME.match(cfg["arch"]), c["name"]
        assert (core.HERE / "archs" / f"{cfg['arch']}.py").is_file()
        arch = core.arch(cfg)
        assert all(callable(getattr(arch, n)) for n in core.ARCH_EXPORTS
                   if n != "COUNTED"), c["name"]
        assert isinstance(arch.COUNTED, dict)
        assert not set(arch.COUNTED) & set(tracing.COUNTED)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_drivers_found_by_kind(kind):
    assert callable(core.load_module("drivers", kind).run)


def test_every_cell_loads_and_reports_enough(bench):
    for w in bench["workloads"]:
        cell = core.Cell.load(bench, w["name"])
        assert cell.chips == 1
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        assert cell.traffic["kind"] in ("train", "serve")
        assert cell.check["limits"], w["name"]
        assert all(v > 0 for v in cell.check["limits"].values())


def test_metric_readers_declare_what_benchmark_says(bench):
    layers = {}
    for m in bench["per_layer"]:
        reader = core.load_module("metrics", m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            m["unit"], m["layer"], m["moves"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_rooflines_are_named_so(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
