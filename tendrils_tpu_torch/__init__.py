"""tendrils_tpu_torch — the PyTorch + CUDA port of tendrils_tpu.

Self-advecting particles that rasterise their velocities into a flow field
they are in turn advected by (the WebGL `keeffEoghan/tendrils`), rebuilt on
PyTorch for one NVIDIA Hopper GPU. `tendrils_tpu` (JAX on a TPU) stays the
reference: the port keeps its module names, function names, argument order
and array layouts, and every Pallas kernel on its path is a hand-written
CUDA kernel here (`csrc/`, built with nvcc at first use). This package
imports `torch` and never `jax` or `triton`.
"""

from .const import INERT, PI, TAU
from .engine import EngineConfig, Tendrils, run_headless
from .flow_line import FlowLine, FlowLines
from .media import OpticalFlow, grid_to_image, image_to_grid
from .state import SimState, default_state, make_state
from .timer import Timer

__all__ = [
    "EngineConfig", "FlowLine", "FlowLines", "INERT", "OpticalFlow", "PI",
    "SimState", "TAU", "Tendrils", "Timer", "default_state", "grid_to_image",
    "image_to_grid", "make_state", "run_headless",
]

__version__ = "0.1.0"
