"""The port's profiling utilities (utils/profiling.py) on the host: the
timer accumulates, the cProfile decorator dumps per rank, the torch
profiler region writes a trace."""
import json
import os
import time

import torch

from iifea_tpu_torch.utils.profiling import (
    Timings,
    device_trace,
    profile_separate,
    timed,
)


def test_torch_timed_accumulates():
    store = Timings()
    for _ in range(2):
        with timed(store, "phase"):
            time.sleep(0.01)
    with timed(store, "other", sync=False):
        pass
    assert store["phase"] >= 0.02 and set(store) == {"phase", "other"}
    assert "phase: " in store.report()


def test_torch_profile_separate_dumps_rank_file(tmp_path):
    name = str(tmp_path / "prof")

    @profile_separate(name)
    def work(n):
        return sum(range(n))

    assert work(1000) == 499500
    assert os.path.getsize(name + ".0") > 0


def test_torch_device_trace_writes_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.0.json"
    with open(path) as f:
        assert json.load(f)["traceEvents"]
