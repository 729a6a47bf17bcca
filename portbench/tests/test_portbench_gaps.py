"""The split of the device's idle time into host-bound and device-side
time (``gaps.py``), on synthetic profiler events: times in us, each device
event with the correlation id of its launch call."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import gaps, trace  # noqa: E402


def idle_of(device, stretch):
    """The idle time ``idle_share.*`` reads over ``stretch``: its length
    less the union of the device's events."""
    busy = trace.merged([(s, e) for s, e, _ in device])
    return (stretch[1] - stretch[0]) - sum(e - s for s, e in busy)


def test_a_kernel_queued_before_its_gap_leaves_a_device_side_gap():
    # a graph's two nodes, both launched at 5 by one cudaGraphLaunch
    device = [(10.0, 20.0, 1), (25.0, 30.0, 1)]
    g = gaps.split(device, {1: 5.0}, [("tsdiff.walk.replay", 4.0, 8.0)])
    assert g["host"] == {} and g["device_us"] == pytest.approx(5.0)


def test_a_kernel_launched_inside_its_gap_is_host_bound_to_the_innermost_span():
    device = [(10.0, 20.0, 1), (40.0, 50.0, 2)]
    spans = [("portbench.walk", 0.0, 60.0), ("tsdiff.walk.round", 1.0, 55.0),
             ("tsdiff.walk.start", 21.0, 35.0), ("tsdiff.walk.replay", 35.0, 55.0)]
    # the second kernel's launch call starts at 32, 12 us into the 20-us gap
    g = gaps.split(device, {1: 5.0, 2: 32.0}, spans)
    assert g["host"] == {"tsdiff.walk.round": pytest.approx(1.0),
                         "tsdiff.walk.start": pytest.approx(11.0)}
    assert g["device_us"] == pytest.approx(8.0)


def test_a_gap_under_no_program_span_goes_to_the_benchmarks_span_or_other():
    device = [(10.0, 20.0, 1), (30.0, 40.0, 2), (50.0, 60.0, 3)]
    spans = [("portbench.pack", 21.0, 26.0), ("tsdiff.pack.host", 41.0, 44.0)]
    g = gaps.split(device, {1: 5.0, 2: 28.0, 3: 49.0}, spans)
    assert g["host"] == {"portbench.pack": pytest.approx(5.0), "other": pytest.approx(9.0),
                         "tsdiff.pack.host": pytest.approx(3.0)}


@pytest.mark.parametrize("stretch", [None, (0.0, 100.0)])
def test_host_bound_and_device_side_add_up_to_the_idle_share(stretch):
    device = [(10.0, 20.0, 1), (15.0, 22.0, 2), (30.0, 40.0, 3), (41.0, 45.0, 4),
              (70.0, 80.0, 5)]
    launch = {1: 2.0, 2: 3.0, 3: 26.0, 4: 12.0, 5: 60.0}
    spans = [("tsdiff.train.step", 1.0, 95.0), ("tsdiff.train.data", 46.0, 58.0)]
    g = gaps.split(device, launch, spans, stretch)
    window = stretch or (10.0, 80.0)
    assert sum(g["host"].values()) + g["device_us"] == pytest.approx(idle_of(device, window))
    host = {"tsdiff.train.step": 4.0 + 3.0, "tsdiff.train.data": 12.0}
    if stretch is not None:     # before the first launch; after the last event
        host["tsdiff.train.step"] += 1.0 + 15.0
        host["other"] = 1.0 + 5.0
    assert g["host"] == pytest.approx(host)


def test_no_program_span_reads_none():
    ctx = {"gaps": gaps.split([(0.0, 1.0, 1), (5.0, 6.0, 2)], {2: 3.0},
                              [("portbench.walk", 0.0, 6.0)])}
    assert gaps.host_ms(ctx, "tsdiff.walk.", 1) is None
    ctx["gaps"]["names"].add("tsdiff.walk.round")
    assert gaps.host_ms(ctx, "tsdiff.walk.", 1) == 0.0
