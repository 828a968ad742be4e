"""The device's busy time is the union of its intervals over every stream,
not their sum."""

from gpubench import devtrace


def test_union_of_overlapping_streams():
    # Two streams: [0, 10) and [5, 15) overlap by 5; [20, 30) stands alone.
    intervals = [(0, 10), (5, 15), (20, 30)]
    assert devtrace.union_length(intervals, 0, 40) == 25
    assert devtrace.summed_length(intervals, 0, 40) == 30
    assert devtrace.gaps(devtrace.merge(intervals, 0, 40), 0, 40) == [(15, 20), (30, 40)]


def test_clipping_to_the_window():
    assert devtrace.union_length([(-5, 5), (8, 50)], 0, 10) == 7


def test_summary_idle_share_and_labels():
    events = [("kernel_a", 0, 10), ("Memcpy HtoD", 5, 15), ("kernel_b", 20, 30)]
    spans = devtrace.Spans()
    spans.add("tracker call", 14, 21)
    s = devtrace.summarize(events, 0, 40, spans, "outside")
    assert s.busy_s == 25e-9 and s.summed_s == 30e-9 and s.window_s == 40e-9
    assert s.kernels == 2  # the copy is not a kernel
    assert [label.split("@")[0] for label, _ in s.idle_gaps] == ["outside", "tracker call"]
    # The summed figure would read 25% idle where the union reads 37.5%.
    assert 1 - s.busy_s / s.window_s == 0.375
