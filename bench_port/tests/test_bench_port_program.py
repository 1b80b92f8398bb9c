"""The readers of the program's own spans and counters, on one traced run
of each cell at the tiny size on the CPU: each reports a number in the
cells that list it, the program's counters agree with the benchmark's
outside ones, and a program without the registry reports nothing."""

import json
import os
import time

import pytest
import torch

import bench_port_cases
from bench_port import harness

BENCH = json.load(open(os.path.join(bench_port_cases.ROOT, "BENCHMARK.json")))
READERS = ("probe_host_ms", "ruiz_sweeps", "rows_passes_ms", "route_host_ms.fit",
           "route_host_ms.step")
#: the cells each reader lists; on the CPU every one of them takes the path
#: its reader reads (the kernels' plain versions carry the same spans)
LISTED = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in READERS}


def traced_run(name):
    """One traced run of a cell on the CPU at the tiny size, with the
    program's registry emptied first."""
    from wlsqm_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    profiling.reset()
    cell = harness.load_cell(name)
    ctx = harness.Context(cell=cell, seed=2**31 + 11, seconds=0.3, traced=True,
                          device=torch.device("cpu"), t_start=time.perf_counter(),
                          overrides=dict(bench_port_cases.TINY))
    return harness.run(ctx), ctx


@pytest.mark.parametrize("name", bench_port_cases.CELLS)
def test_each_reader_reads_the_cells_that_list_it(name):
    out, ctx = traced_run(name)
    assert out["correct"], out["checks"]
    listed = [r for r in READERS if name in LISTED[r]]
    assert listed
    for reader in listed:
        value = out["metrics"][reader]["value"]
        assert value > 0, (reader, value)
    for reader in set(READERS) - set(listed):
        assert reader not in out["metrics"]
    # no program span shares a name with one the benchmark records itself
    from wlsqm_tpu_torch.utils import profiling

    assert not set(profiling.totals()) & set(ctx.spans.totals())


def test_the_program_counts_what_the_benchmark_counts():
    """irregular: every tail the benchmark counted at ``engine.fit_batch``
    took at least one Ruiz sweep; the probe's parts fit inside the
    benchmark's span around it, once a call."""
    from wlsqm_tpu_torch.utils import profiling

    out, ctx = traced_run("fit2d_o4_k30.irregular")
    got, outside = profiling.counters(), ctx.spans.counters
    assert got["engine.ruiz_sweeps"] >= outside["engine.fit_batch.calls"] > 0
    spans = profiling.totals()
    parts = [n for n in spans if n.startswith("condprobe.")]
    assert set(parts) == {"condprobe.screen", "condprobe.host_copy", "condprobe.assemble",
                          "condprobe.svd"}
    assert sum(spans[n]["host_s"] for n in parts) <= ctx.spans.totals()["condprobe.probe"]
    assert all(spans[n]["calls"] == ctx.counts["calls"] for n in parts)


def test_a_program_without_the_registry_reports_nothing(monkeypatch):
    """An older checkout's program has no spans: the readers return None and
    the result line leaves their metrics out."""
    from wlsqm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "counters")
    out, _ = traced_run("fit2d_o4_k30.sens")
    assert out["correct"]
    assert not set(READERS) & set(out["metrics"])


def test_the_route_leaves_out_the_wrapper_passes():
    """sens: ``route_host_ms.fit`` is the route's host seconds less the rows
    wrapper's passes, which ``rows_passes_ms`` reads."""
    from wlsqm_tpu_torch.utils import profiling

    out, ctx = traced_run("fit2d_o4_k30.sens")
    spans = profiling.totals()
    host = {n: spans[n]["host_s"] for n in ("api.checks", "api.kernel", "fit_rows.prescale",
                                           "fit_rows.finish")}
    want = (host["api.checks"] + host["api.kernel"] - host["fit_rows.prescale"]
            - host["fit_rows.finish"]) * 1e3 / ctx.counts["calls"]
    assert out["metrics"]["route_host_ms.fit"]["value"] == pytest.approx(want, rel=1e-3)
    assert 0 < want
