"""Metrics and observability: rays/sec counters, structured run logs.

The reference's only observability is stderr error prints and a
commented-out frame-time printf (``/root/reference/src/main.c:253-258``);
SURVEY.md SS5 mandates structured per-step metrics. This module provides a
tiny dependency-free metrics logger (JSONL) plus the throughput math used
by the benchmarks: a "ray" is one trace round of one pixel-sample —
``H * W * spp * (max_bounces + 1)`` per render, the wavefront analog of
the per-fragment ray budget derived in SURVEY.md SS3.1.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["rays_per_render", "Timer", "MetricsLogger", "throughput"]


def rays_per_render(height: int, width: int, spp: int, max_bounces: int) -> int:
    """Physical trace-rounds issued by the wavefront integrator.

    Every bounce iteration traces the full wavefront (masked lanes
    included), and there are ``max_bounces + 1`` rounds
    (models/integrator.py), so this is exact for the wavefront engines and an
    upper bound in the reference's early-terminating sense.
    """
    return height * width * spp * (max_bounces + 1)


def throughput(height, width, spp, max_bounces, seconds: float) -> float:
    """rays/sec for one timed render."""
    return rays_per_render(height, width, spp, max_bounces) / max(seconds, 1e-12)


@dataclass
class Timer:
    """Wall-clock block timer: ``with Timer() as t: ...; t.seconds``."""

    seconds: float = 0.0
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics stream (loss curves, rays/s, bounce stats).

    ``path=None`` keeps records in memory only (tests).
    """

    path: str | None = None
    records: list = field(default_factory=list)

    def log(self, kind: str, **fields) -> dict:
        rec = {"ts": time.time(), "kind": kind, **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @staticmethod
    def read(path):
        return [
            json.loads(line)
            for line in Path(path).read_text().splitlines()
            if line.strip()
        ]
