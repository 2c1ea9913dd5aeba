"""AudioTrigger — ref `src/audio/index.js:18-63`.

Keeps an order-log pyramid of recent spectra and their time-derivatives;
`sample(dt)` pushes a new analyser frame and recomputes derivative orders;
`fire(react, test)` runs a predicate over the pyramid and fires a callback.

A copy of `tendrils_tpu/audio/trigger.py` (numpy only; importing that
package imports JAX).
"""

import numpy as np

from .analyse import order_log_rates, peak
from .data_log import make_log, make_order_log, step, wrap_index


def default_test(trigger):
    """Ref `src/audio/index.js:13-14`."""
    return peak(trigger.data_order(-1)) > trigger.limit


class AudioTrigger:
    def __init__(self, analyser, orders, limit=200, test=None, react=None):
        self.analyser = analyser
        nbins = analyser.frequency_bin_count
        self.order_log = make_order_log(
            orders,
            lambda size: make_log(size,
                                  lambda i: np.zeros(nbins, np.float32)))
        self.limit = limit
        self.test = test
        self.react = react

    def sample(self, dt=1, method="frequencies"):
        """Push a new spectrum frame and update derivative orders — ref
        `audio/index.js:33-38`."""
        buf = step(self.order_log[0])
        getattr(self.analyser, method)(buf)
        order_log_rates(self.order_log, dt)
        return self

    def data_order(self, nth):
        """Most recent sample at the nth-order log; negative indexes from the
        highest order — ref `audio/index.js:42-44`."""
        return wrap_index(nth, self.order_log)[0]

    def fire(self, react=None, test=None):
        """Ref `audio/index.js:48-56`."""
        react = react if react is not None else self.react
        test = test if test is not None else (self.test or default_test)
        triggered = bool(test(self))
        if triggered and react is not None:
            react(self)
        return triggered

    def clear(self):
        for log in self.order_log:
            for data in log:
                data[:] = 0
        return self
