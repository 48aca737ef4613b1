"""The traced sub-window's readings: busy time, and the idle share of the
untraced window it is scaled to."""

import pytest

from portbench import trace


def _rec(units, device, span=(0.0, 1000.0)):
    return {"span": span, "device": device, "host": [], "units": units}


def test_busy_is_the_union_of_device_ops_in_the_span():
    rec = _rec(2, [("a", 100.0, 300.0), ("b", 200.0, 400.0), ("c", 900.0, 1200.0)])
    assert trace.busy_and_window_s(rec) == pytest.approx((0.0004, 0.001))


def test_window_idle_share_scales_busy_a_unit_to_the_window():
    # 400 µs busy over 4 profiled units: 100 µs a unit; 3,000 units in 0.5 s
    prof = _rec(4, [("a", 0.0, 250.0), ("b", 500.0, 650.0)])
    rec = {"profile": prof, "counts": {"steps": 3000, "window_s": 0.5}}
    assert trace.window_idle_percent(rec, "steps") == pytest.approx(40.0)


@pytest.mark.parametrize("rec", [
    {"counts": {"steps": 10, "window_s": 1.0}},
    {"profile": _rec(4, []), "counts": {"steps": 10, "window_s": 1.0}},
    {"profile": _rec(4, [("a", 0.0, 10.0)]), "counts": {"steps": 0, "window_s": 1.0}},
])
def test_window_idle_share_is_none_with_nothing_to_read(rec):
    assert trace.window_idle_percent(rec, "steps") is None
