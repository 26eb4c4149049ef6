"""BENCHMARK.json and the benchmark's files against the benchmark
format's rules: names, units, sources, bounds, which cells report which metric,
and that every name finds its file."""
import json
import os
import re

import pytest

from h100_bench import core, spec as spec_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_token|channels)")


@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec()


@pytest.fixture(scope="module")
def manifest(spec):
    return spec.manifest


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["h100_bench"]
    assert manifest["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits in 43200 s
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(manifest):
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in manifest["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] == 1
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    pairs = [(c["config"], c["traffic"]) for c in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and c["file"].startswith("h100_bench/")
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_reports_what_it_must(spec, manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for c in spec.cell_names():
        mine = {m["name"] for m in spec.end_to_end(c)}
        assert "setup_s" in mine and len(mine) >= 2, c
        assert spec.per_layer(c), c
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", spec.cell_names()):
            assert m["moves"] in {x["name"] for x in spec.end_to_end(c)}, (
                m["name"], c)
    used = {c["config"] for c in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


def test_every_name_finds_its_file(spec, manifest):
    for c in manifest["configs"]:
        assert spec.config(c["name"])["precision"] in ("float32", "tf32")
    for w in manifest["workloads"]:
        mix = spec.traffic(w["traffic"])
        assert os.path.exists(os.path.join(
            spec.bench_dir, "drivers", f"{mix['driver']}.py"))
        assert spec.cell_file(w["name"])["limits"]
    for m in manifest["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_readers_read_nothing_from_nothing(spec, manifest):
    """A reader that finds nothing to read returns None (never 0)."""
    empty = core.Window(e2e={}, attempted=0, failed=0, program={},
                        trace=None, memory_peak_bytes=0, checks={},
                        seconds=1.0)
    for m in manifest["per_layer"]:
        w = manifest["workloads"][0]
        run = core.Run(w["name"], spec.config(w["config"]),
                       spec.traffic(w["traffic"]), empty)
        assert spec.reader(m["name"])(run) is None, m["name"]
