"""The trace reduction on a synthetic chrome trace."""
import pytest

from mvsbench import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", trace.WINDOW, 1000.0, 1000.0),
    ev("user_annotation", "Predictor.__call__", 1000.0, 700.0),
    ev("cpu_op", "aten::copy_", 1100.0, 100.0),
    ev("kernel", "void fused_cost_volume_kernel<2>(x)", 1050.0, 100.0),
    ev("kernel", "void sweep_view_kernel<true, 32, true>(y)", 1120.0, 80.0),
    ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1500.0, 100.0),
    ev("kernel", "outside", 2100.0, 50.0),            # after the window
]


def test_busy_union_gaps_and_copies():
    tr = trace.reduce_events(EVENTS, units=2)
    assert tr.window_s == pytest.approx(1e-3)
    # kernels 1050-1200 (overlapping) and the copy 1500-1600
    assert tr.busy_s == pytest.approx(250e-6)
    assert tr.memcpy_s == pytest.approx(100e-6)
    # idle: 1000-1050, 1200-1500 and 1600-2000
    assert sum(tr.idle_gaps.values()) == pytest.approx(750e-6)
    assert tr.idle_gaps["Predictor.__call__"] == pytest.approx(350e-6)
    assert tr.idle_gaps["no host record"] == pytest.approx(400e-6)


def test_roofline_share_reads_the_matching_kernels():
    tr = trace.reduce_events(EVENTS, units=2)
    tr.jobs = {"fused_cost_volume": 50e-6, "sweep_gwc": 40e-6}
    assert tr.roofline_pct("fused_cost_volume",
                           r"fused_cost_volume_kernel") == pytest.approx(50)
    assert tr.roofline_pct("sweep_gwc", r"sweep_view_kernel<true,\s*\d+,"
                           r"\s*true>") == pytest.approx(50)
    assert tr.roofline_pct("sweep_warp", r"sweep_view_kernel<false") is None
