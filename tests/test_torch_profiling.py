"""utils.profiling of the port: the synchronising Timer and the trace
wrapper (the cases of tests/test_profiling.py; the JAX package's Timer
reports the same kind of result for the same kind of block)."""

import json
import os

import numpy as np
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu.utils import profiling as jprofiling
from wlsqm_tpu_torch.utils.profiling import Timer, device_trace

torch.set_num_threads(1)


def test_timer_measures_and_prints(capsys):
    with Timer("work") as t:
        float(torch.arange(1000.0).sum())
    assert t.seconds is not None and t.seconds >= 0.0
    assert "[work]" in capsys.readouterr().out


def test_timer_quiet_and_nosync(capsys):
    with Timer(sync=False, quiet=True) as t:
        sum(range(100))
    assert t.seconds >= 0.0
    assert capsys.readouterr().out == ""
    with jprofiling.Timer(sync=False, quiet=True) as tj:
        sum(range(100))
    assert set(vars(t)) <= set(vars(tj)) | {"_t0"}


def test_device_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with device_trace(logdir) as prof:
        float(torch.ones((64, 64), dtype=torch.float64).sum())
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_timer_brackets_real_fit():
    rng = np.random.default_rng(42)
    xk = rng.uniform(-1, 1, (8, 20, 2))
    with Timer(quiet=True) as t:
        res = wtt.fit_many(xk, np.sin(xk[..., 0]), order=2, device="cpu")
        res.fi.numpy()
    assert t.seconds > 0.0
