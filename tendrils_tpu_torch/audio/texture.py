"""Audio data -> colour-map grid — ref `src/audio/data-texture.js:20-62`.

The reference uploads analyser bins to a float `[N, 1]` texture used as the
colour-map blend input; here the "texture" is an `f32[4, 1, N]` grid the
engine's colour-map path samples.

The port of `tendrils_tpu/audio/texture.py`: numpy, but for `grid()`, which
returns a CPU tensor that `Tendrils.step_draw_io` uploads with the other
colour maps.
"""

import numpy as np
import torch

# Ref `src/audio/utils.js:1-5`.
WAVEFORM_SCALE = 1.0 / 128.0
FREQUENCY_SCALE = 1.0 / 256.0


def waveform_map(v):
    return (np.asarray(v, np.float32) - 128.0) * WAVEFORM_SCALE


def frequency_map(v):
    return np.asarray(v, np.float32) * FREQUENCY_SCALE


class AudioTexture:
    def __init__(self, size):
        self.array = np.zeros(int(size), np.float32)

    def assign(self, data):
        self.array[:] = np.asarray(data, np.float32)[:self.array.shape[0]]
        return self

    def waveform(self, data):
        """Ref `data-texture.js:52-56`."""
        self.array[:] = waveform_map(data)[:self.array.shape[0]]
        return self

    def frequencies(self, data):
        """Ref `data-texture.js:58-62`."""
        self.array[:] = frequency_map(data)[:self.array.shape[0]]
        return self

    def grid(self):
        """As an engine colour-map grid `f32[4, 1, N]` (value replicated to
        RGB, alpha 1 — the reference texture is single-channel float used as
        luminance), a CPU tensor."""
        v = torch.tensor(self.array)[None, None, :]
        return torch.cat([v, v, v, torch.ones_like(v)])
