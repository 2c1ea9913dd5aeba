"""frame_ms.device_bound: `frame_ms` in the cells whose frame the device
bounds, under a bound of their own: their runs spread far less than the
host-bound cells', whose spread sets `frame_ms`'s bound."""

from benchmark.cell import reader

read = reader("frame_ms")
