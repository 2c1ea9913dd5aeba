"""frame_ms_p95.device_bound: `frame_ms_p95` in the cells whose frame the
device bounds, under a bound of their own (see `frame_ms.device_bound`)."""

from benchmark.cell import reader

read = reader("frame_ms_p95")
