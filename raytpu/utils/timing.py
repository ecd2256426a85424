"""Frame timing + throughput meters.

The reference's only perf instrumentation is a 1-second-window FPS print
gated by ``TEST_FPS`` (``src/main.cpp:65-81,2969-2971``), which also uncaps
the present mode (``src/main.cpp:1214-1218``). raytpu keeps that counter
(API parity) and adds what a device renderer actually needs: per-stage wall
timers bracketed by ``block_until_ready`` and Mrays/s meters — the BASELINE
metric (SURVEY.md §5/§6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional


class FpsCounter:
    """1-second-window FPS print (``src/main.cpp:65-81``)."""

    def __init__(self, print_fn=print):
        self._frames = 0
        self._window_start = None
        self._print = print_fn
        self.last_fps: Optional[float] = None

    def frame(self) -> Optional[float]:
        now = time.perf_counter()
        if self._window_start is None:
            self._window_start = now
        self._frames += 1
        elapsed = now - self._window_start
        if elapsed >= 1.0:
            self.last_fps = self._frames / elapsed
            self._print(f"FPS: {self.last_fps:.1f}")
            self._frames = 0
            self._window_start = now
            return self.last_fps
        return None


@dataclasses.dataclass
class StageTimes:
    """Accumulated per-stage wall times (build / trace / shade / total)."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, block=None):
        """Time a stage; pass ``block`` = a device array (or callable) to
        bracket with ``block_until_ready`` for honest device timing."""
        t0 = time.perf_counter()
        yield
        if block is not None:
            obj = block() if callable(block) else block
            if hasattr(obj, "block_until_ready"):
                obj.block_until_ready()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts.get(name, 0), 1)

    def report(self) -> str:
        return " | ".join(
            f"{k}: {self.mean(k) * 1e3:.1f} ms" for k in sorted(self.totals)
        )


def mrays_per_sec(num_rays: int, seconds: float) -> float:
    return num_rays / max(seconds, 1e-12) / 1e6


def measure_frame(render_fn, *args, warmup: int = 1, iters: int = 5,
                  pipelined: bool = True):
    """Time a jitted frame function honestly (compile excluded, device
    blocked). Returns (mean_seconds, per-iter list); in pipelined mode the
    list has a single entry — the mean — since enqueue-all/block-once has
    no per-iteration resolution.

    ``pipelined`` (default) enqueues all iterations and blocks once — the
    per-frame device throughput a production host sees. Blocking on every
    frame instead adds the host→device dispatch latency per call; pass
    ``pipelined=False`` to measure that strict call-return latency (what
    an interactive loop that reads every frame back sees).
    """
    for _ in range(warmup):
        out = render_fn(*args)
        out.block_until_ready()
    if pipelined:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = render_fn(*args)
        out.block_until_ready()
        total = time.perf_counter() - t0
        return total / iters, [total / iters]
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = render_fn(*args)
        out.block_until_ready()
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), times
