"""The program's spans (`tt.<name>`, `torch.profiler.record_function`) in a
traced stretch, on made-up events: the trace's parse and the per-layer
readers read the same with and without them."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import cell, trace

CONFIG = {"engine": {"root_num": 16, "view_res": [32, 128]}}


def _ev(name, start, end, device=DeviceType.CPU, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def _events(program_spans):
    """Two spin kernels, then two frames: each a `bench.frame` holding
    `bench.port`, in it the program's launches (the logic step's kernel,
    K2's tile pass) and a synchronising copy; with `program_spans` the
    program's `tt.` spans around them on the host and their annotations
    on the device."""
    cuda = DeviceType.CUDA
    ev = [_ev("cudaLaunchKernel", 0, 1), _ev("cudaLaunchKernel", 1, 2),
          _ev("spin_kernel", 2, 3, cuda), _ev("spin_kernel", 3, 4, cuda)]
    for k in range(2):
        t = 10 + 100 * k
        ev += [_ev("bench.frame", t, t + 60),
               _ev("bench.port", t + 1, t + 59),
               _ev("cudaMemcpyAsync", t + 2, t + 3),
               _ev("cudaStreamSynchronize", t + 3, t + 20),
               _ev("cudaLaunchKernel", t + 25, t + 26),
               _ev("cudaLaunchKernel", t + 40, t + 41),
               _ev("Memcpy HtoD", t + 5, t + 6, cuda),
               _ev("elementwise_kernel", t + 26, t + 28, cuda),
               _ev("splat_tile_kernel(Params)", t + 45, t + 70, cuda),
               _ev("bench.frame", t, t + 60, cuda, annotation=True)]
        if program_spans:
            ev += [_ev("tt.frame", t + 1, t + 58),
                   _ev("tt.params", t + 2, t + 21),
                   _ev("tt.logic", t + 22, t + 35),
                   _ev("tt.draw", t + 36, t + 57),
                   _ev("tt.draw.sort", t + 37, t + 39),
                   _ev("tt.logic", t + 26, t + 28, cuda, annotation=True),
                   _ev("tt.draw", t + 45, t + 70, cuda, annotation=True)]
    return ev


def _view(program_spans):
    view = trace.parse(_events(program_spans), 2)
    assert view is not None, "the trace failed its completeness check"
    view.spans = {"frame": [0.010, 0.012]}
    view.counters = {"splat": 2}
    view.config = CONFIG
    return view


def test_device_annotations_leave_the_completeness_check():
    with_spans, without = _view(True), _view(False)
    assert with_spans.device_ops == without.device_ops
    assert with_spans.launch_calls == without.launch_calls == 4
    assert with_spans.stretch == without.stretch
    # A device event that is neither annotation nor asked for still fails
    # the check, with the program's spans as without them.
    for spans in (True, False):
        extra = _events(spans) + [_ev("stray_kernel", 300, 301,
                                      DeviceType.CUDA)]
        assert trace.parse(extra, 2) is None


@pytest.mark.parametrize("name", ["host_ms", "launches_per_frame",
                                  "k2_roofline_pct", "device_idle_pct"])
def test_readers_read_the_same_with_program_spans(name):
    read = cell.reader(name)
    got, want = read(_view(True)), read(_view(False))
    assert want is not None
    assert got == want


def test_idle_gaps_name_the_host_call_or_the_program_span():
    """The gap while the host waits in `params()`'s copy keeps the runtime
    call's name; a gap that opens between calls inside a program span
    reads that span."""
    with_spans, without = _view(True), _view(False)
    names = dict(with_spans.gaps)
    assert dict(without.gaps).get("port:cudaStreamSynchronize")
    assert names.get("port:cudaStreamSynchronize")
    assert "port:tt.logic" in names and "port" in dict(without.gaps)
    assert sorted(s for _, s in with_spans.gaps) == \
        sorted(s for _, s in without.gaps)


def test_spawn_device_ms_reads_what_the_spawn_span_launched():
    """The device time of the operations whose launch call began inside
    `bench.spawn` (matched by correlation id), over the spans; nothing to
    read in a stretch without one."""
    cuda = DeviceType.CUDA
    ev = _events(True)
    assert cell.reader("spawn_device_ms")(_view(True)) is None
    t = 10  # the first frame: a respawn before its entry
    ev += [_ev("bench.spawn", t + 1.5, t + 2.5),
           _ev("cudaLaunchKernel", t + 1.6, t + 1.7),
           _ev("cudaLaunchKernel", t + 1.8, t + 1.9),
           _ev("vectorized_elementwise_kernel", t + 3, t + 3.25, cuda),
           _ev("vectorized_elementwise_kernel", t + 3.25, t + 4, cuda)]
    for k, e in enumerate(ev[-4:]):
        e.id = 900 + k % 2
    view = trace.parse(ev, 2)
    assert view is not None
    assert view.span_calls["spawn"] == [1, 1.0]
    assert view.span_calls["frame"][0] == 2
    assert cell.reader("spawn_device_ms")(view) == 1.0 / 1e3
