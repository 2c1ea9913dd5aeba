"""The window's statistics and the trace's arithmetic, on made-up data."""

import math

from benchmark import harness, trace


def test_p95_nearest_rank_over_all_frames():
    values = list(range(1, 101))  # 100 frames: the 95th value
    assert harness.p95(values) == 95
    assert harness.p95([7.0]) == 7.0
    # Every frame counts: one slow frame in twenty is the 95th percentile.
    assert harness.p95([1.0] * 19 + [50.0]) == 1.0
    assert harness.p95([1.0] * 18 + [50.0, 60.0]) == 50.0
    assert harness.p95(list(reversed(values))) == 95


def test_union_of_device_intervals():
    # Overlapping streams count once; nested and touching intervals merge.
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_us([(0, 10), (2, 3), (10, 12)]) == 12
    assert trace.union_us([]) == 0


def test_idle_share_from_union():
    view = trace.TraceView(
        frames=2, device_ops=[("a", 10, 40), ("b", 30, 60), ("c", 80, 90)],
        stretch=(0, 100))
    assert view.busy_us() == 60
    from benchmark import cell
    idle = cell.reader("device_idle_pct")(view)
    assert math.isclose(idle, 40.0)
    # The sum of the durations would read 70 busy: the union reads 60.
    assert sum(e - s for _, s, e in view.device_ops) == 70


def test_idle_gaps():
    gaps = trace.gaps_us([(10, 40), (30, 60), (80, 90)], 0, 100)
    assert gaps == [(0, 10), (60, 80), (90, 100)]
    named = trace.name_gaps(
        gaps, [("bench.port", 55, 85)],
        [("aten::cat", 58, 70), ("aten::item", 58.5, 59.5)])
    assert named[0] == ("port:aten::cat", 20 / 1e6)
    assert [n for n, _ in named[1:]] == ["loop", "loop"]


def test_readers_without_a_trace_read_nothing():
    from benchmark import cell
    view = trace.TraceView(spans={}, config={})
    for name in ("host_ms", "launches_per_frame", "k2_roofline_pct",
                 "device_idle_pct"):
        assert cell.reader(name)(view) is None


def test_host_span_means():
    from benchmark import cell
    view = trace.TraceView(spans={"frame": [0.010, 0.012]})
    assert math.isclose(cell.reader("host_ms")(view), 11.0)


def test_end_to_end_readers():
    from benchmark import cell
    run = harness.Summary(frame_ms=12.5, intervals_ms=[1.0] * 18 + [50.0,
                                                                    60.0],
                          peak_bytes=3 * 2 ** 30, setup_s=9.5)
    assert cell.reader("frame_ms")(run) == 12.5
    assert cell.reader("frame_ms.device_bound")(run) == 12.5
    assert cell.reader("frame_ms_p95")(run) == 50.0
    assert cell.reader("frame_ms_p95.device_bound")(run) == 50.0
    assert cell.reader("peak_mem_gib")(run) == 3.0
    assert cell.reader("setup_s")(run) == 9.5
