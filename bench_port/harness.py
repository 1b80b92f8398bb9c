"""The benchmark harness: finds a cell's files by the names in
``BENCHMARK.json``, runs its driver, reads its per-layer metrics and
assembles the result line.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
harness reads, all under ``bench_port/``:

* ``configs/<config>.json`` (the file the ``configs`` entry names): the
  deployment's sizes, and beside it ``configs/<config>_ref.py``, its plain
  reference;
* ``traffic/<traffic>.json``: the mix's parameters, and the name of the
  driver that runs it, ``drivers/<driver>.py``;
* ``cells/<workload>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
* ``metrics/<name>.py`` for each per-layer metric: ``read(ctx)`` returns
  the value, or None where it finds nothing to read.

A later cell, traffic mix or metric is a new file and a new entry; no file
here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "bench_port")

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "wlsqm_tpu", "bench", "benchmarks", "chip_smoke")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module from a file under the benchmark, by its path."""
    name = "bench_port._files." + os.path.relpath(path, HERE).replace(
        "/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: object
    reference: object
    end_to_end: list       # entries of BENCHMARK.json this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit("unknown workload %r; BENCHMARK.json has %s" % (name, sorted(cells)))
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_file = os.path.join(ROOT, cfg_entry["file"])
    config = load_json(cfg_file)
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "cells", name + ".json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, limits=limits,
                driver=load_module(os.path.join(HERE, "drivers", traffic["driver"] + ".py")),
                reference=load_module(cfg_file[:-len(".json")] + "_ref.py"),
                end_to_end=e2e, per_layer=layer)


@dataclasses.dataclass
class Context:
    """What a driver is given, and what it hands back to the readers."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float                 # the process's first clock reading
    judge: str = "program"         # or "control": the reference in f32 is judged
    overrides: dict = dataclasses.field(default_factory=dict)
    spans: object = None           # set by run(); the rest by the driver
    trace: object = None
    values: dict = dataclasses.field(default_factory=dict)     # end-to-end values
    checks: dict = dataclasses.field(default_factory=dict)     # name -> (value, limit)
    bounds: dict = dataclasses.field(default_factory=dict)     # kernel -> s a launch
    counts: dict = dataclasses.field(default_factory=dict)     # calls, steps, cases
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)

    def param(self, key: str):
        """A traffic parameter, or its override (tests run tiny sizes)."""
        return self.overrides.get(key, self.cell.traffic.get(key))

    def size(self, key: str):
        """A configuration size, or its override."""
        return self.overrides.get(key, self.cell.config[key])


def device_or_exit(chips: int) -> torch.device:
    """The card, or exit non-zero: a run never falls back to the CPU."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("bench_port: needs %d CUDA device(s); torch.cuda.is_available() = %s, "
              "device_count() = %d" % (chips, torch.cuda.is_available(),
                                        torch.cuda.device_count() if torch.cuda.is_available()
                                        else 0), file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def forbidden_loaded() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run(ctx: Context) -> dict:
    """Run the cell's driver and assemble the result line (a dict)."""
    from bench_port.lib import trace as trace_lib

    ctx.spans = trace_lib.Spans(ctx.traced)
    ctx.trace = trace_lib.Trace(ctx.traced)
    ctx.cell.driver.run(ctx)
    checks = ctx.checks
    correct = (ctx.attempted > 0 and ctx.failed == 0 and bool(checks)
               and all(v <= lim for v, lim in checks.values()))
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    metrics = {}
    if not ctx.traced:
        for m in ctx.cell.end_to_end:
            if m["name"] not in ctx.values:
                raise RuntimeError("the driver gave no %s" % m["name"])
            metrics[m["name"]] = {"value": ctx.values[m["name"]], "unit": units[m["name"]]}
    else:
        for m in ctx.cell.per_layer:
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": ctx.cell.chips, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": device}
    if ctx.traced:
        s = ctx.trace.summary or {}
        device["busy_s"] = s.get("busy_s", 0.0)
        device["window_s"] = s.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": s.get("device_ops", []),
                            "idle_gaps": s.get("idle_gaps", [])}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
