"""Profiling and tracing utilities (port of ``iifea_tpu/utils/profiling.py``).

* ``profile_separate``: cProfile around a function, dumped per process
  (the rank of ``torch.distributed`` when it is initialised, else 0);
* ``timed``: wall-clock a phase into a dict, waiting for the card's queued
  work before and after (``torch.cuda.synchronize``) when CUDA is in use,
  so that asynchronous launches are booked to the phase that made them;
* ``device_trace``: a ``torch.profiler`` region that writes a Chrome trace
  under ``logdir`` (the card's kernels when CUDA is in use).
"""
from __future__ import annotations

import contextlib
import cProfile
import os
import pstats
import time
from functools import wraps

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def profile_separate(filename: str | None = None):
    """Decorator: cProfile a function, dump '<filename>.<rank>' per
    process, or print the stats when no filename is given."""

    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            prof = cProfile.Profile()
            prof.enable()
            try:
                return fn(*args, **kwargs)
            finally:
                prof.disable()
                if filename:
                    prof.dump_stats(f"{filename}.{_rank()}")
                else:
                    pstats.Stats(prof).sort_stats("cumulative").print_stats(25)

        return wrapper

    return deco


class Timings(dict):
    def report(self) -> str:
        return "\n".join(f"{k}: {v:.4f}s" for k, v in self.items())


@contextlib.contextmanager
def timed(store: dict, key: str, sync: bool = True):
    """Wall-clock a phase into ``store[key]`` (accumulating); with sync=True
    and CUDA in use, the card's queue is drained first and at the end."""
    sync = sync and _cuda_in_use()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize()
        store[key] = store.get(key, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` region; its Chrome trace is written to
    ``logdir/trace.<rank>.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if _cuda_in_use():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace.{_rank()}.json"))
