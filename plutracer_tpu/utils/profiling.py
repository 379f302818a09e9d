"""Profiling and metrics.

The reference's observability is wall-clock phase prints + a watermark
(src/main.cpp:146-204) and per-thread tile counts (src/renderer.cpp:140-145).
Equivalents here:

- ``PhaseTimer``: phase wall-clock timing (init/render/postprocess parity)
  with a structured report.
- ``RenderStats``: samples/sec and rays/sec derived from batch shapes and
  the integrator's worst-case query count.
- ``profile_trace``: context manager around jax.profiler for device traces
  viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, Optional


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}
        self._start: Optional[float] = None
        self._name: Optional[str] = None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f"{k} took: {int(v * 1000)}ms" for k, v in self.phases.items())

    def as_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.phases.items()})


@dataclasses.dataclass
class RenderStats:
    """Throughput accounting for one render.

    A sample is a full camera path. Per sample the integrator issues at most
    1 + 3*(max_bounces-1) + ... closest-hit queries: 1 extension + 2 NEE
    visibility rays per shading vertex (renderer.cpp:16,41,86), max_bounces
    vertices -> 3*max_bounces queries per sample upper bound.
    """

    width: int
    height: int
    spp: int
    seconds: float
    max_bounces: int = 8

    @property
    def samples(self) -> int:
        return self.width * self.height * self.spp

    @property
    def samples_per_sec(self) -> float:
        return self.samples / max(self.seconds, 1e-12)

    @property
    def rays_per_sec_upper(self) -> float:
        return self.samples_per_sec * 3 * self.max_bounces

    def report(self) -> str:
        return (
            f"{self.samples} samples in {self.seconds:.2f}s = "
            f"{self.samples_per_sec / 1e6:.2f} Msamples/s "
            f"(<= {self.rays_per_sec_upper / 1e6:.1f} Mrays/s issued)"
        )


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler device trace around the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
