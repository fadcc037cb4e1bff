"""BENCHMARK.json against the benchmark's contract, and every file it names
found by that name."""

import json
import re

import pytest

from portbench.core import CHECKOUT, HERE, data, load, manifest, metrics_of, path_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAN = manifest()


def test_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["paths"] == ["portbench"] and 1 <= MAN["run_seconds"] <= 51
    assert MAN["command"][:3] == ["python3", "-m", "portbench.run"]


def test_names_units_and_lines():
    entries = MAN["configs"] + MAN["workloads"] + MAN["end_to_end"] + MAN["per_layer"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names)), section
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_cells_report_what_the_contract_asks():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        reported = {m["name"] for m in metrics_of(MAN, "end_to_end", w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = metrics_of(MAN, "per_layer", w["name"])
        assert layers and all(m["moves"] in reported for m in layers)
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    sizes = json.loads((CHECKOUT / c["file"]).read_text())
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert sizes["name"] == c["name"] and sizes["source"] == c["source"]
    assert sizes["reduced"] == c["reduced"]
    for fn in ("inputs", "noise", "program_problem"):
        assert callable(getattr(load("configs", c["name"]), fn))
    assert path_of("reference", c["name"], ".py").exists()


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_traffic_and_limit_files(w):
    t = data("traffic", w["traffic"])
    kind = load("traffic", t["kind"])
    for fn in ("setup", "before", "step", "after", "solved", "numbers"):
        assert callable(getattr(kind, fn)), fn
    assert t["batch"] >= 1 and t["sample_rows"] >= 2
    spec = data("limits", w["name"])
    assert spec["reference"] in ("float32", "float64")
    assert spec["limits"] and all(v is not None and v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(m):
    assert callable(load("metrics", m["name"]).read)


def test_no_stray_files():
    """Every configuration, mix, traffic kind, limit set and metric file is
    named in the manifest or by a mix (a later cell adds its files and its
    entries together)."""
    named = {("configs", c["name"]) for c in MAN["configs"]}
    named |= {("traffic", w["traffic"]) for w in MAN["workloads"]}
    named |= {("traffic", data("traffic", w["traffic"])["kind"]) for w in MAN["workloads"]}
    named |= {("limits", w["name"]) for w in MAN["workloads"]}
    named |= {("metrics", m["name"]) for m in MAN["end_to_end"] + MAN["per_layer"]}
    for kind in ("configs", "traffic", "limits", "metrics"):
        for f in (HERE / kind).iterdir():
            if f.suffix in (".py", ".json"):
                assert (kind, f.name[: -len(f.suffix)]) in named, f
