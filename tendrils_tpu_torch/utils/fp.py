"""Iteratee-first functional helpers — ref `src/fp/` (153 LoC), as
`tendrils_tpu/utils/fp.py` (plain Python, copied: the port imports
nothing of the JAX package).

The reference threads these through every module; Python mostly has builtins,
but the iteratee-first, output-object-filling signatures are part of its API
surface, so they're provided for parity (`map_obj(f, src, out)` mirrors
`fp/map.js`'s `map((v, k) => ..., src, out)` etc.)."""

import functools


def each(f, obj):
    """`fp/each.js`: call f(value, key) over dict/list entries."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            f(v, k)
    else:
        for i, v in enumerate(obj):
            f(v, i)
    return obj


def map_obj(f, src, out=None):
    """`fp/map.js`: map entries into `out` (dict or list)."""
    if out is None:
        out = {} if isinstance(src, dict) else [None] * len(src)
    if isinstance(src, dict):
        for k, v in src.items():
            out[k] = f(v, k)
    else:
        for i, v in enumerate(src):
            while len(out) <= i:
                out.append(None)
            out[i] = f(v, i)
    return out


def map_list(f, src, out):
    """`fp/map.js` `mapList`: elementwise into a preallocated sequence."""
    for i, v in enumerate(src):
        out[i] = f(v, i)
    return out


def reduce_obj(f, obj, acc=None):
    """`fp/reduce.js`: fold f(acc, value, key)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            acc = f(acc, v, k)
    else:
        for i, v in enumerate(obj):
            acc = f(acc, v, i)
    return acc


def filter_obj(pred, obj):
    """`fp/filter.js`: entries passing pred(value, key)."""
    if isinstance(obj, dict):
        return {k: v for k, v in obj.items() if pred(v, k)}
    return [v for i, v in enumerate(obj) if pred(v, i)]


def compose(*fns):
    """`fp/compose.js`: right-to-left composition."""

    def composed(*args, **kw):
        fs = list(fns)
        out = fs.pop()(*args, **kw)
        while fs:
            out = fs.pop()(out)
        return out

    return composed


def curry(f, arity=None):
    """`fp/partial.js` `curry`."""
    if arity is None:
        arity = f.__code__.co_argcount

    def curried(*args):
        if len(args) >= arity:
            return f(*args)
        return curry(functools.partial(f, *args), arity - len(args))

    return curried
