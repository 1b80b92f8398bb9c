"""``BENCHMARK.json`` against the benchmark's contract, the files the harness
finds by its names, and what a run's process may load."""

import json
import math
import os
import re
import subprocess
import sys

import pytest

import bench_port_cases
from bench_port import harness

ROOT = bench_port_cases.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench_port/") and PATH.match(c["file"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(name):
    cell = harness.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "bench_port", "metrics", m["name"] + ".py"))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_layer_metrics_list_cells_that_report_what_they_move():
    by_cell = {w["name"]: {m["name"] for m in harness.load_cell(w["name"]).end_to_end}
               for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", by_cell):
            assert m["moves"] in by_cell[w], (m["name"], w)
    assert math.isclose(next(m["bound"] for m in BENCH["end_to_end"]
                             if m["name"] == "setup_s"), 0.25)


def test_files_are_named_from_names():
    for base, _, files in os.walk(os.path.join(ROOT, "bench_port")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), ROOT)
            assert PATH.match(rel), rel


LOADER = r"""
import json, os, sys
sys.path.insert(0, %(root)r)
from bench_port import harness
bench = json.load(open(os.path.join(%(root)r, "BENCHMARK.json")))
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"])
for m in bench["per_layer"]:
    harness.load_module(os.path.join(%(root)r, "bench_port", "metrics", m["name"] + ".py"))
import bench_port.control, bench_port.run
%(extra)s
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _loaded(extra=""):
    out = subprocess.run([sys.executable, "-c", LOADER % {"root": ROOT, "extra": extra}],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    """Top-level module names compared whole: the port's name begins with
    the JAX package's."""
    tops = _loaded("import wlsqm_tpu_torch, wlsqm_tpu_torch.api")
    assert "wlsqm_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "wlsqm_tpu", "bench", "benchmarks",
                       "chip_smoke"}


def test_the_references_load_nothing_of_the_port():
    tops = _loaded()
    assert not tops & {"wlsqm_tpu_torch", "wlsqm_tpu", "jax"}
