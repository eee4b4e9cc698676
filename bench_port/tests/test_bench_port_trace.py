"""The traced run's reading of a profiler trace: device busy time as the
union of device intervals, idle gaps named by the host op around them,
and a render kernel's roofline share from its launches' grids."""
import pytest

from bench_port import flops
from bench_port.harness import traced


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_busy_idle_and_gaps():
    events = [
        ev("cpu_op", "aten::conv", 0, 100),
        ev("cpu_op", "aten::nonzero", 100, 50),
        ev("kernel", "k1", 10, 40, grid=[1, 1, 1]),
        ev("kernel", "k2", 30, 40, grid=[1, 1, 1]),    # overlaps k1
        ev("gpu_memcpy", "copy", 120, 10),
        ev("kernel", "k1", 140, 10, grid=[1, 1, 1]),
    ]
    r = traced.read_trace(events, 0.0)
    assert r["busy_s"] == pytest.approx((60 + 10 + 10) * 1e-6)
    assert r["window_s"] == pytest.approx(150e-6)
    ops = dict(map(tuple, r["breakdown"]["device_ops"]))
    assert ops["k1"] == pytest.approx(50e-6) and ops["k2"] == pytest.approx(
        40e-6)
    gaps = dict(map(tuple, r["breakdown"]["idle_gaps"]))
    # the gaps 0-10 and 70-120 have their middles in aten::conv, 130-140
    # in aten::nonzero
    assert gaps["aten::conv"] == pytest.approx(60e-6)
    assert gaps["aten::nonzero"] == pytest.approx(10e-6)


def test_render_roofline_by_name_and_grid():
    n, w = 4096, 192
    secs = flops.render_bytes(n, 6, w) / flops.PEAK_BYTES
    trace = {"kernels": [
        ("void raster_kernel<true>(Params)", 2 * secs, (300, n, 1)),
        ("_Z13raster_kernelILb0EEv6Params", 1.0, (300, n, 1)),
        ("other", 5.0, (1, 1, 1))]}
    assert traced.render_roofline(trace, "raster_kernel<true>", 6, w) == \
        pytest.approx(50.0)
    assert traced.render_roofline(trace, "raster_kernel<false>", 3, w) == \
        pytest.approx(100 * flops.render_bytes(n, 3, w) / flops.PEAK_BYTES)
    assert traced.render_roofline({"kernels": []}, "raster_kernel<true>", 6,
                                  w) is None
