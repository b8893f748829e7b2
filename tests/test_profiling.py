"""Reduction of profiler planes to per-GPU busy time."""

from types import SimpleNamespace as NS

import pytest

from tpuslam.utils.profiling import busy_from_planes


def _line(name, spans):
    return NS(name=name, events=[NS(start_ns=a, duration_ns=b - a) for a, b in spans])


def _gpu_plane(name, spans):
    # a stream line, and the derived op line that repeats its intervals
    return NS(name=name, lines=[_line("Stream #13(Compute)", spans), _line("XLA Ops", spans)])


def test_busy_counts_a_plane_recorded_twice_once():
    spans = [(0, 100), (50, 150), (300, 400)]
    planes = [
        NS(name="/host:CPU", lines=[_line("python", [(0, 10_000)])]),
        _gpu_plane("/device:GPU:0", spans),
        _gpu_plane("/device:GPU:0", spans),  # the same device from a second file
    ]
    assert busy_from_planes(planes) == {"/device:GPU:0": 250}


def test_busy_is_per_device():
    planes = [
        _gpu_plane("/device:GPU:0", [(0, 100)]),
        _gpu_plane("/device:GPU:1", [(0, 40), (60, 100)]),
        _gpu_plane("/device:GPU:1 (second file)", [(30, 70)]),
    ]
    assert busy_from_planes(planes) == {"/device:GPU:0": 100, "/device:GPU:1": 100}


def test_busy_beyond_the_traced_window_raises():
    planes = [_gpu_plane("/device:GPU:0", [(0, 100), (200, 300)])]
    assert busy_from_planes(planes, window_ns=200) == {"/device:GPU:0": 200}
    with pytest.raises(ValueError, match="exceeds the traced window"):
        busy_from_planes(planes, window_ns=199)
