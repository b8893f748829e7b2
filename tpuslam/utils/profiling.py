"""Tracing / profiling utilities.

The reference's only instrumentation is manual ``std::chrono`` wall-clock
timing inside tests (SURVEY §5).  Here: a ``jax.profiler`` trace context for
TensorBoard-consumable device traces, the reduction of such a trace to
device busy time, and a ``block_until_ready`` FPS harness used by the
benchmarks.
"""

from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path
from typing import Callable, Iterator

import jax


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler trace (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published peaks per device kind, dense, at the full 700 W power limit
# (NVIDIA H100 SXM data sheet).  A card set to a lower power limit cannot
# hold these; report shares with the card's limit beside them.
PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes": 3.35e12,
    },
}


def peaks_for(device_kind: str) -> dict[str, float]:
    """The peak rates of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add them to "
            "tpuslam.utils.profiling.PEAKS with their source"
        ) from None


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def busy_from_planes(planes, window_ns: int | None = None) -> dict[str, int]:
    """Busy time per GPU of profiler planes (``.name``, ``.lines``).

    Busy is the union of the intervals of the kernels and copies on the
    device's stream lines (``Stream #...``), taken over every plane that
    names the device, so an interval recorded twice counts once; the
    derived module and op lines repeat those intervals and are skipped.
    ``window_ns``, the length of the traced region, bounds each device's
    busy time: a busier device means the trace holds work from outside the
    region, and is an error.
    """
    spans: dict[str, list[tuple[int, int]]] = {}
    for plane in planes:
        device = re.match(r"/device:GPU:\d+", plane.name)
        if device is None:
            continue
        spans.setdefault(device.group(), []).extend(
            (ev.start_ns, ev.start_ns + ev.duration_ns)
            for line in plane.lines
            if line.name.startswith("Stream")
            for ev in line.events
        )
    busy = {device: _union_ns(s) for device, s in spans.items()}
    over = {d: b for d, b in busy.items() if window_ns is not None and b > window_ns}
    if over:
        raise ValueError(
            f"device busy {over} ns exceeds the traced window of {window_ns} ns"
        )
    return busy


def device_busy_ns(
    log_dir: str | Path, window_ns: int | None = None
) -> dict[str, int]:
    """:func:`busy_from_planes` over a trace written by :func:`device_trace`."""
    paths = sorted(Path(log_dir).glob("plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = [jax.profiler.ProfileData.from_file(str(p)) for p in paths]
    return busy_from_planes([pl for d in data for pl in d.planes], window_ns)


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> dict:
    """Steady-state timing of a jitted function (seconds + per-call ms)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"total_s": dt, "per_call_ms": dt / iters * 1e3, "iters": iters}


class StageTimer:
    """Accumulates named host-side stage timings (the FPS harness)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        return {
            k: {
                "total_s": self.totals[k],
                "mean_ms": self.totals[k] / max(self.counts[k], 1) * 1e3,
                "count": self.counts[k],
            }
            for k in self.totals
        }
