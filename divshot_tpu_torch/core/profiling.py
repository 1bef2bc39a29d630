"""Profiling helpers (counterpart of ``divshot_tpu/core/profiling.py``):
the ``torch.profiler`` analog of the reference's Tracy macros
(``DS_PROFILE_SCOPE/FUNCTION/FRAMEMARKER``, ``core/profiler.h:16-20``):
named trace scopes (a ``record_function`` range, and on a card an NVTX
range too), a step timer with optional device fencing, and an on-demand
trace capture exported as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Any

import torch


@contextlib.contextmanager
def profile_scope(name: str):
    """Named scope visible in ``torch.profiler`` traces (DS_PROFILE_SCOPE);
    where a card is present also an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def profile_function(fn):
    """Decorator: wrap a function in a ``profile_scope`` named after it
    (DS_PROFILE_FUNCTION)."""

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with profile_scope(fn.__qualname__):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a host and device trace of the enclosed region into
    ``logdir/trace.json`` (open in Perfetto or ``chrome://tracing``);
    the device activity is recorded where a card is present. Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _fence(x: Any) -> None:
    """Wait for the card's work on every CUDA tensor in ``x`` (a tensor, a
    ``torch.device``, or a list, tuple or dict of them); CPU tensors need
    no wait."""
    if isinstance(x, torch.device):
        if x.type == "cuda":
            torch.cuda.synchronize(x)
    elif isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _fence(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _fence(v)


class StepTimer:
    """Wall-clock step statistics with optional device fencing: the FPS/UPS
    counter analog (``application.cpp:279-283``). Every ``fence_every``-th
    scope waits for the card's work on ``fence_on`` before it stops the
    clock."""

    def __init__(self, fence_every: int = 0):
        self.fence_every = fence_every
        self.times: dict[str, list[float]] = defaultdict(list)
        self._count = 0

    @contextlib.contextmanager
    def scope(self, name: str, fence_on: Any = None):
        t0 = time.perf_counter()
        yield
        if fence_on is not None and self.fence_every and \
                self._count % self.fence_every == 0:
            _fence(fence_on)
        self.times[name].append(time.perf_counter() - t0)
        self._count += 1

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            if not ts:
                continue
            out[name] = {
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "last_ms": 1e3 * ts[-1],
                "count": len(ts),
            }
        return out
