"""The port's audio stack (`tendrils_tpu_torch/audio/`) against the JAX
package's on the same numpy-seeded inputs: the ring-buffer order logs,
the spectrum statistics, `AudioTrigger` over a pushed analyser,
`WavAnalyser` on a synthesized WAV file, and `AudioTexture` (whose
`grid()` is a torch tensor in the port and a JAX array in the reference).

Tolerance: none. Both run the same numpy (and Python) code on the same
arrays, so every value and array must be equal (`==`,
`assert_array_equal`).
"""

import math
import wave

import numpy as np
import pytest
import torch

from tendrils_tpu import audio as jaudio
from tendrils_tpu.audio import data_log as jlog
from tendrils_tpu_torch import audio as taudio
from tendrils_tpu_torch.audio import data_log as tlog


def _write_wav(path, seed, rate=8000, seconds=1.0, width=2, channels=1):
    """A WAV of two tones and seeded noise, `width` bytes a sample."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    sig = (0.5 * np.sin(2 * math.pi * 440 * t)
           + 0.3 * np.sin(2 * math.pi * 1250 * t * (1 + t))
           + 0.1 * rng.standard_normal(t.size))
    sig = np.clip(sig, -1, 1)
    if width == 1:
        pcm = (sig * 100 + 128).astype(np.uint8)
    else:
        pcm = (sig * 20000).astype(np.int16)
    pcm = np.repeat(pcm[:, None], channels, axis=1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


def test_data_log_matches_jax():
    for order in range(1, 6):
        assert jlog.make_order_log(order) == tlog.make_order_log(order)
        mk = lambda s: jlog.make_log(s, lambda i: i * i)  # noqa: E731
        assert jlog.make_order_log(order, mk) == tlog.make_order_log(
            order, mk)
    a, b = list(range(7)), list(range(7))
    for _ in range(9):
        assert jlog.step(a) == tlog.step(b) and a == b
    for i in (-9, -1, 0, 2.4, 2.6, 13):
        assert jlog.wrap_index(i, a) == tlog.wrap_index(i, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyse_matches_jax(seed):
    """The statistics on seeded spectra (and an empty one), and
    `order_log_rates` over a seeded pyramid."""
    rng = np.random.default_rng(seed)
    for data in (rng.uniform(-255, 255, 512).astype(np.float32),
                 rng.standard_normal(33), np.zeros(0)):
        for fn in ("peak", "peak_pos", "sum_abs", "mean"):
            assert getattr(jaudio, fn)(data) == getattr(taudio, fn)(data)
        for fulcrum in (0.0, 0.25, 0.5, 0.8):
            assert jaudio.sum_weight(data, fulcrum) == \
                taudio.sum_weight(data, fulcrum)
            assert jaudio.mean_weight(data, fulcrum) == \
                taudio.mean_weight(data, fulcrum)
    last, cur = rng.uniform(0, 255, (2, 64)).astype(np.float32)
    np.testing.assert_array_equal(jaudio.log_rates(last, cur, 16.7),
                                  taudio.log_rates(last, cur, 16.7))
    logs = []
    for m in (jlog, tlog):
        r = np.random.default_rng(seed)
        logs.append(m.make_order_log(4, lambda s: m.make_log(
            s, lambda i: r.uniform(0, 255, 16).astype(np.float32))))
    for _ in range(3):
        jaudio.order_log_rates(logs[0], 16.7)
        taudio.order_log_rates(logs[1], 16.7)
        for ja, ta in zip(logs[0], logs[1]):
            for x, y in zip(ja, ta):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_trigger_matches_jax(seed):
    """`AudioTrigger` on a pushed `Analyser`: 20 seeded spectra, each
    sampled with a seeded dt; the pyramid, `data_order` at every order
    and the default and custom tests' firing, frame by frame."""
    rng = np.random.default_rng(seed)
    spectra = rng.uniform(0, 255, (20, 8)).astype(np.float32)
    spectra[::4] = 0.0  # silences, so that the rates jump
    dts = rng.uniform(8, 25, 20)
    fired = ([], [])
    pairs = []
    for m, log in zip((jaudio, taudio), fired):
        an = m.Analyser(fft_size=16)
        tr = m.AudioTrigger(an, 4, limit=60,
                            react=lambda t, log=log: log.append("react"))
        pairs.append((an, tr))
    for spec, dt in zip(spectra, dts):
        outs = []
        for (an, tr), log, m in zip(pairs, fired, (jaudio, taudio)):
            an.push(frequencies=spec, waveform=np.resize(spec, 16))
            tr.sample(dt)
            log.append(tr.fire())
            log.append(tr.fire(test=lambda t: m.mean_weight(
                t.data_order(2), 0.25) > 1.0))
            outs.append([tr.data_order(k).copy() for k in range(-4, 4)])
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)
    assert fired[0] == fired[1]
    assert "react" in fired[0] and False in fired[0]
    for (_, tr) in pairs:
        tr.clear()
        assert all(not d.any() for log in tr.order_log for d in log)


@pytest.mark.parametrize("width,channels", [(2, 1), (1, 2)],
                         ids=["int16-mono", "uint8-stereo"])
def test_wav_analyser_matches_jax(tmp_path, width, channels):
    """`WavAnalyser` on a synthesized WAV: the decoded samples, then the
    smoothed byte spectrum and the waveform at 30 playhead times (past the
    end included), and the track's duration."""
    path = _write_wav(tmp_path / "t.wav", 7, width=width, channels=channels)
    ja, ta = jaudio.WavAnalyser(path), taudio.WavAnalyser(path)
    np.testing.assert_array_equal(ja.samples, ta.samples)
    assert ja.duration_ms() == ta.duration_ms()
    assert ja.frequency_bin_count == ta.frequency_bin_count == 512
    fj = np.zeros(512, np.float32)
    ft = np.zeros(512, np.float32)
    for t in np.arange(30) * 37.0:
        ja.tick(t)
        ta.tick(t)
        np.testing.assert_array_equal(ja.frequencies(fj),
                                      ta.frequencies(ft))
        np.testing.assert_array_equal(ja.waveform(np.zeros(1024)),
                                      ta.waveform(np.zeros(1024)))
    assert fj.max() > 0
    assert ja.seek(120.0).time_ms == ta.seek(120.0).time_ms


def test_texture_grid_matches_jax():
    """`AudioTexture`: `assign`, `waveform` and `frequencies` on seeded
    bytes, and `grid()` (`f32[4, 1, N]`: the value on RGB, alpha 1) equal
    to the JAX array as numpy; the port's is a CPU tensor."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 255, 600).astype(np.float32)
    np.testing.assert_array_equal(jaudio.waveform_map(data),
                                  taudio.waveform_map(data))
    np.testing.assert_array_equal(jaudio.frequency_map(data),
                                  taudio.frequency_map(data))
    jt, tt = jaudio.AudioTexture(512), taudio.AudioTexture(512)
    for op in ("assign", "waveform", "frequencies"):
        getattr(jt, op)(data)
        getattr(tt, op)(data)
        np.testing.assert_array_equal(jt.array, tt.array)
        g = tt.grid()
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype == torch.float32 and tuple(g.shape) == (4, 1, 512)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jt.grid()))
    before = tt.grid()
    tt.frequencies(data[::-1])
    assert not torch.equal(before, tt.grid())  # grid() is a copy
