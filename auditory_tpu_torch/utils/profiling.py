"""Tracing and observability utilities (counterpart of
``auditory_tpu/utils/profiling.py``).

- :func:`trace` -- a named span (``torch.profiler.record_function``) that
  shows up in a profiler trace;
- :func:`capture_trace` -- profile the block with ``torch.profiler`` (the
  CPU, and CUDA activity when a card is present) and write a Chrome trace
  (Perfetto / chrome://tracing) into a directory;
- :func:`memory_stats` -- per-device memory counters in MiB;
- :func:`debug_nans` -- scoped anomaly detection that raises where a
  backward pass produces NaN;
- :class:`StepTimer` -- wall-clock and real-time-factor accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator

import torch

__all__ = ["trace", "capture_trace", "debug_nans", "StepTimer", "memory_stats"]


def memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-CUDA-device memory counters in MiB (``torch.cuda.memory_stats``:
    the caching allocator's current and peak allocated and reserved bytes;
    the analog of sound.PrintMemUsage, sndenv.go:535-545, for device
    memory). Empty without a card."""
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            k: round(v / (1024 * 1024), 2)
            for k, v in stats.items()
            if k.endswith(".all.current") or k.endswith(".all.peak")
            if "bytes" in k
        }
    return out


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """Named span visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``trace.json`` (Chrome trace format)
    into ``log_dir``; yields the profiler (``key_averages()`` etc.)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Scoped ``torch.autograd.set_detect_anomaly(True, check_nan=True)``:
    a backward pass that produces NaN raises and names the forward op. It
    covers backward only -- PyTorch has no forward NaN trap, and the
    production pipeline *expects* NaN mel weights in some designs, so
    leave this off for such configs."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


@dataclass
class StepTimer:
    """Accumulates per-step wall time and audio-seconds for RTF reporting."""

    sample_rate: int
    steps: int = 0
    wall_seconds: float = 0.0
    audio_seconds: float = 0.0

    @contextlib.contextmanager
    def step(self, n_audio_samples: int) -> Iterator[None]:
        t0 = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            # count the WALL time even when the step raises -- dropping it
            # would inflate RTF -- but count the AUDIO only on success: a
            # caught-and-retried failure would otherwise count the same
            # audio twice while processing it once
            dt = time.perf_counter() - t0
            self.steps += 1
            self.wall_seconds += dt
            if ok:
                self.audio_seconds += n_audio_samples / self.sample_rate

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "steps": self.steps,
            "wall_seconds": round(self.wall_seconds, 4),
            "audio_seconds": round(self.audio_seconds, 3),
            "rtf": round(self.rtf, 1),
        }
