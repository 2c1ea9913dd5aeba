"""Spectrum statistics and derivative pyramids — ref `src/analyse/index.js`.

All functions operate on numpy arrays (the reference's `*List` iteratee
helpers over typed arrays).

A copy of `tendrils_tpu/audio/analyse.py` (numpy only; importing that
package imports JAX).
"""

import numpy as np

from .data_log import step


def log_rates(last, current, dt, out=None):
    """Euler dy/dt per bin — ref `analyse/index.js:17-18` +
    `physics/euler/index.js` `eulerDyDt = (pos1-pos0)/dt`."""
    last = np.asarray(last, np.float32)
    current = np.asarray(current, np.float32)
    rates = (current - last) / dt
    if out is not None:
        out[:] = rates
        return out
    return rates


def order_log_rates(order_log, dt=1):
    """Fill each higher order with the rate of change of the one below —
    ref `analyse/index.js:25-31`."""
    for o in range(1, len(order_log)):
        out = step(order_log[o])
        log_rates(order_log[o - 1][1], order_log[o - 1][0], dt, out)
    return order_log


def peak(data):
    """Value of largest magnitude — ref `analyse/index.js:36-37`."""
    data = np.asarray(data)
    if data.size == 0:
        return 0.0
    return float(data[np.argmax(np.abs(data))])


def peak_pos(data):
    """Ref `analyse/index.js:39-51`."""
    data = np.asarray(data)
    if data.size == 0:
        return {"peak": 0.0, "pos": -1}
    i = int(np.argmax(np.abs(data)))
    return {"peak": float(data[i]), "pos": i}


def sum_abs(data):
    """Ref `analyse/index.js:53`."""
    return float(np.abs(np.asarray(data, np.float64)).sum())


def sum_weight(data, fulcrum=0.5):
    """Triangular weighting about a fulcrum (a crude band-pass) — ref
    `analyse/index.js:55-58`."""
    data = np.asarray(data, np.float64)
    n = data.size
    if n == 0:
        return 0.0
    i = np.arange(n) / max(n - 1, 1)
    w = 1.0 - np.abs(i - fulcrum)
    return float(np.abs(data * w).sum())


def mean(data):
    return sum_abs(data) / max(np.asarray(data).size, 1)


def mean_weight(data, fulcrum=0.5):
    return sum_weight(data, fulcrum) / max(np.asarray(data).size, 1)
