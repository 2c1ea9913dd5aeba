"""Analyser sources.

The reference wraps a Web Audio `AnalyserNode` (`web-audio-analyser`). This
headless equivalent exposes the same surface — `frequencies(out)` /
`waveform(out)` and `frequency_bin_count` — fed either by pushed arrays
(`Analyser`, for live clients) or by numpy FFT over a WAV file
(`WavAnalyser`, for the demo's track reactivity without a browser).

Spectra are scaled to the Web Audio byte range [0, 255] so the reference's
trigger thresholds (`demo.main.js:170-202`) transfer unchanged.

A copy of `tendrils_tpu/audio/analyser.py` (numpy and the standard library
only; importing that package imports JAX).
"""

import wave

import numpy as np


class Analyser:
    """Push-driven analyser: a client feeds spectra/waveforms."""

    def __init__(self, fft_size=2 ** 10):
        self.fft_size = fft_size
        self._freq = np.zeros(self.frequency_bin_count, np.float32)
        self._wave = np.zeros(fft_size, np.float32)

    @property
    def frequency_bin_count(self):
        return self.fft_size // 2

    def push(self, frequencies=None, waveform=None):
        if frequencies is not None:
            self._freq[:] = frequencies
        if waveform is not None:
            self._wave[:] = waveform
        return self

    def frequencies(self, out):
        out[:] = self._freq
        return out

    def waveform(self, out):
        out[:] = self._wave[:out.shape[0]]
        return out


class WavAnalyser(Analyser):
    """FFT analyser over a WAV file, addressed by playhead time (ms).

    Mirrors Web Audio's `getByteFrequencyData` shape: magnitude spectrum in
    dB mapped to [0, 255] over [min_db, max_db] with exponential smoothing.
    """

    def __init__(self, path, fft_size=2 ** 10, smoothing=0.8,
                 min_db=-100.0, max_db=-30.0):
        super().__init__(fft_size)
        self.smoothing = smoothing
        self.min_db = min_db
        self.max_db = max_db
        with wave.open(path, "rb") as w:
            self.rate = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        data = np.frombuffer(raw, dtype).reshape(-1, ch).mean(axis=1)
        if width == 1:
            data = (data - 128.0) / 128.0
        else:
            data = data / float(np.iinfo(dtype).max)
        self.samples = data.astype(np.float32)
        self._smooth = np.zeros(self.frequency_bin_count, np.float64)
        self.time_ms = 0.0

    def seek(self, time_ms):
        self.time_ms = float(time_ms)
        return self

    def tick(self, time_ms):
        """Compute the spectrum at the playhead and store it."""
        self.time_ms = float(time_ms)
        start = int(self.time_ms / 1000.0 * self.rate)
        frame = self.samples[start:start + self.fft_size]
        if frame.shape[0] < self.fft_size:
            frame = np.pad(frame, (0, self.fft_size - frame.shape[0]))
        self._wave = frame
        windowed = frame * np.blackman(self.fft_size)
        mag = np.abs(np.fft.rfft(windowed))[:self.frequency_bin_count]
        mag = mag / self.fft_size
        # Web Audio smoothing-over-time, then dB mapping to bytes.
        self._smooth = (self.smoothing * self._smooth
                        + (1 - self.smoothing) * mag)
        with np.errstate(divide="ignore"):
            db = 20.0 * np.log10(np.maximum(self._smooth, 1e-12))
        scaled = (db - self.min_db) / (self.max_db - self.min_db) * 255.0
        self._freq = np.clip(scaled, 0, 255).astype(np.float32)
        return self

    def duration_ms(self):
        return self.samples.shape[0] / self.rate * 1000.0
