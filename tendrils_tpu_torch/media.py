"""Media inputs: video-frame conversion and the optical-flow ring.

Mirrors `tendrils_tpu/media.py`: frames are numpy arrays pushed from any
source (camera client, video decoder, synthetic); the flow op is
`ops.optical_flow`. `OpticalFlow` double-buffers the frames on an explicit
device (`src/optical-flow/index.js:32-73`), "cuda" by default.
"""

import numpy as np
import torch

from .ops import optical_flow as of_ops


def image_to_grid(img, keep_u8=False):
    """`[H, W, 3|4]` uint8/float image (row 0 = top) -> engine grid
    `[4, H, W]` (row 0 = clip bottom), a host (numpy) array. `keep_u8`
    keeps a uint8 input as `u8[4, H, W]` (a quarter of the f32 upload
    bytes; the frame converts it to f32 on the device)."""
    img = np.asarray(img)
    u8 = img.dtype == np.uint8 and keep_u8
    if img.dtype == np.uint8 and not keep_u8:
        img = img.astype(np.float32) / 255.0
    img = img[::-1]  # flip to the engine's bottom-up rows
    if img.shape[-1] == 3:
        alpha = (np.full_like(img[..., :1], 255) if u8
                 else np.ones_like(img[..., :1]))
        img = np.concatenate([img, alpha], axis=-1)
    return np.ascontiguousarray(np.moveaxis(img, -1, 0),
                                np.uint8 if u8 else np.float32)


def grid_to_image(grid):
    """Engine grid `f32[4, H, W]` (array or tensor) -> `[H, W, 4]` float
    image, row 0 = top."""
    if isinstance(grid, torch.Tensor):
        grid = grid.cpu().numpy()
    return np.moveaxis(np.asarray(grid), 0, -1)[::-1]


class OpticalFlow:
    """Double-buffered optical-flow source — ref `src/optical-flow/index.js`.

    `set_pixels(frame)` uploads the newest frame; `update(...)` computes the
    flow payload between the two buffered frames; `step()` rotates them."""

    def __init__(self, uniforms=None, device="cuda"):
        self.uniforms = dict({
            "offset": 1.0, "lambda": 0.001, "speed": 1.0,
            "speedLimit": 1.0, "scaleUV": [1, -1],
        }, **(uniforms or {}))
        self.device = torch.device(device)
        self.buffers = [None, None]

    def set_pixels(self, frame):
        """Upload the new frame into buffer 0 (`optical-flow/index.js:
        64-66`). `frame`: `[H, W, C]` image or an engine grid `[4, H, W]`.
        uint8 frames stay uint8 across the copy (4x fewer bytes); the
        previous frame's device copy is reused from the ring, so each frame
        pays one upload."""
        grid = (frame if (hasattr(frame, "shape") and len(frame.shape) == 3
                          and frame.shape[0] == 4)
                else image_to_grid(frame, keep_u8=True))
        grid = np.asarray(grid)
        if grid.dtype != np.uint8:
            grid = grid.astype(np.float32)
        # scaleUV mirrors the lookup (`optical-flow/index.frag:56`) —
        # realised as flips of the host array relative to [1, -1].
        sx, sy = self.uniforms.get("scaleUV", [1, -1])
        if sx < 0:
            grid = grid[:, :, ::-1]
        if sy > 0:
            grid = grid[:, ::-1, :]
        dtype = torch.uint8 if grid.dtype == np.uint8 else torch.float32
        last = self.buffers[1]
        if last is None or tuple(last.shape) != grid.shape \
                or last.dtype != dtype:
            self.buffers[1] = torch.zeros(grid.shape, dtype=dtype,
                                          device=self.device)
        self.buffers[0] = torch.from_numpy(np.ascontiguousarray(grid)).to(
            self.device)
        return self

    def device_buffers(self):
        """(current, last) frames as device tensors (u8 or f32)."""
        return self.buffers[0], self.buffers[1]

    def update(self, time, **overrides):
        """The flow payload between the current and last frames."""
        u = dict(self.uniforms, **overrides)
        cur, last = self.device_buffers()
        return of_ops.optical_flow(
            cur, last, time, offset=u["offset"], lambda_=u["lambda"],
            speed=u["speed"], speed_limit=u["speedLimit"])

    def step(self):
        """Rotate the frame ring — ref `optical-flow/index.js:59-61`."""
        self.buffers = [self.buffers[1], self.buffers[0]]
        return self

    def resize(self, shape_hw):
        h, w = shape_hw
        self.buffers = [torch.zeros((4, h, w), device=self.device)
                        for _ in range(2)]
        return self
