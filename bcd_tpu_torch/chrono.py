"""Timing and phase-profiling utilities (port of ``bcd_tpu/chrono.py``;
reference Chronometer.h/.cpp and the COMPUTE_DENOISING_STATS phase
chronometers, DenoisingUnit.h:35-65).

``Chronometer`` mirrors the reference's start/stop/elapsed wall-clock timer
with the same h/min/s/ms pretty-printing. ``PhaseStats`` is the analog of
``DenoisingStatistics``: named phase timers plus counters, aggregated and
printed as a tree — but always available (no compile-time gate) and usable
as context managers. For on-device tracing, ``trace`` wraps
``torch.profiler.record_function``. The phase timers read the host clock;
``device_phase`` ends a phase in a device synchronize, so that its timer
holds the phase's device work (the engine times its phases so only when
it is given a ``PhaseStats``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch


def format_time(seconds: float) -> str:
    """h / min / s / ms formatting in the reference's style."""
    if seconds >= 3600:
        h = int(seconds // 3600)
        m = int((seconds % 3600) // 60)
        return f"{h} h {m} min"
    if seconds >= 60:
        m = int(seconds // 60)
        s = seconds % 60
        return f"{m} min {s:.1f} s"
    if seconds >= 1:
        return f"{seconds:.3f} s"
    return f"{seconds * 1e3:.1f} ms"


class Chronometer:
    """start/stop/elapsed wall-clock timer (reference Chronometer.cpp)."""

    def __init__(self):
        self._started_at: Optional[float] = None
        self._elapsed = 0.0

    def start(self) -> None:
        self._started_at = time.perf_counter()

    def stop(self) -> None:
        if self._started_at is not None:
            self._elapsed += time.perf_counter() - self._started_at
            self._started_at = None

    def reset(self) -> None:
        self._started_at = None
        self._elapsed = 0.0

    @property
    def elapsed(self) -> float:
        running = (
            time.perf_counter() - self._started_at
            if self._started_at is not None
            else 0.0
        )
        return self._elapsed + running

    def __str__(self) -> str:
        return format_time(self.elapsed)


@dataclass
class PhaseStats:
    """Named phase timers + counters with tree printing (the always-on
    analog of the reference's DenoisingStatistics)."""

    timers: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counters: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] += time.perf_counter() - t0

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc

    def merge(self, other: "PhaseStats") -> "PhaseStats":
        for k, v in other.timers.items():
            self.timers[k] += v
        for k, v in other.counters.items():
            self.counters[k] += v
        return self

    def report(self) -> str:
        lines = []
        for name, c in sorted(self.counters.items()):
            lines.append(f"{name}: {c}")
        if self.timers:
            lines.append("Chronometers:")
            for name, t in sorted(self.timers.items()):
                depth = name.count("/")
                label = name.rsplit("/", 1)[-1]
                lines.append(f"  {'  ' * depth}{label:<32s} {format_time(t)}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_phase(stats: Optional[PhaseStats], name: str,
                 device) -> Iterator[None]:
    """``stats.phase(name)`` ending in a synchronize of ``device`` when it
    is a CUDA device, so that the timer holds the phase's device work;
    nothing at all when ``stats`` is None."""
    if stats is None:
        yield
        return
    with stats.phase(name):
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """A named range in ``torch.profiler`` captures."""
    with torch.profiler.record_function(name):
        yield
