"""Tracing and step timing (counterpart of ``d2r_tpu/utils/profiling.py``;
SURVEY.md section 5.1).

The JAX package wraps ``jax.profiler``: a trace around training steps and
named annotations, viewed in TensorBoard or Perfetto. Here:

* :func:`maybe_profile` and :class:`Trace`: a ``torch.profiler`` trace of
  the host and, on the card, of its kernels (CUPTI), written as
  ``trace.json`` (Chrome trace format, which Perfetto reads) into the
  directory given; the trainer's ``--profile_dir`` uses :class:`Trace`.
* :func:`annotate`: a named range, ``torch.profiler.record_function`` (in a
  trace) plus an NVTX range on the card (in ``nsys``).
* :class:`StepTimer`: steady-state host-clock step timing, the first steps
  left out, as the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


class Trace:
    """A ``torch.profiler`` trace between :meth:`start` and :meth:`stop`,
    of the host and, with ``cuda``, the card's kernels; :meth:`stop` waits
    for the card and writes ``profile_dir/trace.json``."""

    def __init__(self, profile_dir: str, cuda: bool):
        self.profile_dir, self.cuda = profile_dir, cuda
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> str:
        """End the trace and write it; returns the file's path."""
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, TRACE_FILE)
        self.prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], cuda: Optional[bool] = None) -> Iterator[None]:
    """Trace the block into ``profile_dir`` when it is set (the card too
    when ``cuda``, by default when one is present), else nothing."""
    if not profile_dir:
        yield
        return
    trace = Trace(profile_dir, torch.cuda.is_available() if cuda is None else cuda)
    trace.start()
    try:
        yield
    finally:
        trace.stop()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range around host-side work: a ``record_function`` span in a
    ``torch.profiler`` trace and, where a card is present, an NVTX range."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class StepTimer:
    """Steady-state step timing on the host clock, the first ``skip_first``
    steps (compilation in JAX, the kernels' build and the captures here)
    left out."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times = []
        self._count = 0
        self._t = None

    def start(self):
        self._t = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t
        self._count += 1
        if self._count > self.skip_first:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def percentile(self, p: float) -> float:
        if not self._times:
            return float("nan")
        xs = sorted(self._times)
        return xs[min(int(len(xs) * p / 100.0), len(xs) - 1)]
