"""BENCHMARK.json against the contract's form: names, units, keys, and
that every name it gives resolves to a file of the benchmark."""

import json
import re

import pytest

from decode_bench import cache

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(cache.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_names_resolve_to_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        with open(cache.ROOT / c["file"]) as f:
            json.load(f)
    for w in manifest["workloads"]:
        assert w["config"] in configs
        assert (cache.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (cache.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in manifest["workloads"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        def here(m):
            return "workloads" not in m or w["name"] in m["workloads"]

        e2e = [m["name"] for m in manifest["end_to_end"] if here(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(here(m) for m in manifest["per_layer"])
