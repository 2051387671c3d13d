"""Tracing / profiling utilities.

The reference's observability is wall-clock prints and two append-only
files (``timings.txt``, ``averagestandard.txt`` — SURVEY §5.1).  This
module provides the structured counterpart:

* :class:`Timings` — named spans + counters, JSONL export (the
  timings.txt replacement used by the CLI and nodes);
* :func:`device_trace` — context manager around ``jax.profiler`` for
  device traces (TensorBoard-compatible), no-op if unavailable;
* :func:`bootstraps_per_sec` — the framework's headline counter.

Time device work by ending each span with ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import json
import time


class Timings:
    def __init__(self):
        self.spans = []
        self.counters = {}

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(
                {"name": name, "seconds": time.perf_counter() - t0, **meta}
            )

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def dump(self, path: str = "timings.txt"):
        with open(path, "a") as f:
            f.write(json.dumps(
                {"spans": self.spans, "counters": self.counters}
            ) + "\n")

    def total(self, name: str) -> float:
        return sum(s["seconds"] for s in self.spans if s["name"] == name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace (TensorBoard format); silently no-ops if the
    profiler is unsupported on the active platform."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def bootstraps_per_sec(gates: int, seconds: float) -> float:
    return gates / seconds if seconds > 0 else float("inf")
