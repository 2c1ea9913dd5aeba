"""Ring-buffer data logs — ref `src/data-log/index.js:14-36`.

`make_order_log(order)` builds the triangular 2D structure
`[[*]*order, [*]*(order-1), ..., [*]]` used to hold spectra and their
successive time-derivative orders.

A copy of `tendrils_tpu/audio/data_log.py` (pure Python; importing that
package imports JAX).
"""


def make_log(size, data_maker=None):
    if data_maker is None:
        data_maker = lambda i: []  # noqa: E731
    return [data_maker(i) for i in range(size)]


def make_order_log(order, log_maker=make_log):
    return [log_maker(order - i) for i in range(order)]


def step(array):
    """Ring rotation: pop last, unshift to front — ref
    `src/utils/index.js:1-7`. Returns the recycled element."""
    nxt = array.pop()
    array.insert(0, nxt)
    return nxt


def wrap_index(index, array):
    """Ref `src/utils/index.js:9-10`."""
    return array[(len(array) + round(index)) % len(array)]
