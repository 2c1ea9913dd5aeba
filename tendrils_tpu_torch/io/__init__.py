"""IO: image export, trajectory dumps, checkpoint/resume.

The port of `tendrils_tpu/io/`: `export` is a copy; the checkpoints
move the state through numpy and write the JAX package's npz layout.
"""

from .export import save_ppm, save_png, view_to_u8
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint", "save_png", "save_ppm",
           "view_to_u8"]
