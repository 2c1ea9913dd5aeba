"""Audio reactivity (SURVEY §2.4) — headless-first.

Ports the reference's audio stack: `data-log` ring-buffer order logs,
`analyse` derivative/statistics functions, `AudioTrigger` (order-log pyramid
of spectra + predicate firing) and the audio→texture bridge. Where the
reference reads a Web Audio analyser, this package accepts spectrum arrays
from any source and ships a numpy FFT `Analyser` for WAV files so the demo's
audio-reactive behavior runs headless.

The port of `tendrils_tpu/audio/`: numpy copies of its modules, but for
`AudioTexture.grid()`, which returns a torch tensor.
"""

from .analyse import (log_rates, mean, mean_weight, order_log_rates, peak,
                      peak_pos, sum_abs, sum_weight)
from .analyser import Analyser, WavAnalyser
from .data_log import make_log, make_order_log
from .texture import AudioTexture, frequency_map, waveform_map
from .trigger import AudioTrigger, default_test

__all__ = [
    "Analyser", "AudioTexture", "AudioTrigger", "WavAnalyser",
    "default_test", "frequency_map", "log_rates", "make_log",
    "make_order_log", "mean", "mean_weight", "order_log_rates", "peak",
    "peak_pos", "sum_abs", "sum_weight", "waveform_map",
]
