"""Checkpoint / resume.

The reference persists *parameters* (presets, shareable URLs, keyframe
capture — `demo.main.js:1281-1293`) and reconstructs sim state by respawning.
This build keeps that param-first model AND adds real state checkpointing
(SURVEY §5): the full `SimState` + engine params + timer, as one npz — so
long trajectories resume, which respawn cannot give.

The port of `tendrils_tpu/io/checkpoint.py`, in its npz layout: the same
array names and the same `__meta__` JSON, so either package loads the
other's checkpoints. The state goes through numpy (`convert`). The port
has no threefry key: it writes the key that `jax.random.PRNGKey(seed)`
gives for the engine's seed (nothing draws from it, so a JAX state holds
that key for its whole life) and ignores the key on load. Unlike the
JAX loader, it also sets the engine's `color_map_res` to the loaded colour
map's shape, so that a resumed run draws a textured map as the run that
saved it did.
"""

import dataclasses
import json

import numpy as np

from .. import convert

# Derived caches, recomputed (the carried force) or re-seeded (the
# merge-reorder carry) on the first frame after a load: not persisted.
_DERIVED = ("force", "sort_key", "sort_hist")


def threefry_key(seed):
    """The raw `uint32[2]` key of `jax.random.PRNGKey(seed)` (threefry,
    32-bit): the seed's high and low words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def save_checkpoint(path, engine):
    """Dump engine sim state + live params + timer to `path` (.npz)."""
    sim = engine.sim
    arrays = {}
    for f in dataclasses.fields(sim):
        v = getattr(sim, f.name)
        if v is not None and f.name not in _DERIVED:
            arrays[f.name] = v.cpu().numpy()
        if f.name == "color_map":  # where the JAX state keeps its key
            arrays["key"] = threefry_key(engine.seed)
    meta = {
        "state": {k: v for k, v in engine.state.items()},
        "timer": {"time": engine.timer.time, "since": engine.timer.since,
                  "offset": engine.timer.offset, "rate": engine.timer.rate,
                  "step": engine.timer.step, "dt": engine.timer.dt,
                  "paused": engine.timer.paused, "end": engine.timer.end,
                  "loop": engine.timer.loop},
        "config": {
            "root_num": engine.config.root_num,
            "view_res": list(engine.config.view_res),
            "flow_res": (list(engine.config.flow_res)
                         if engine.config.flow_res else None),
        },
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return path


def load_checkpoint(path, engine):
    """Restore a checkpoint (the port's or the JAX package's) into an
    engine, onto its device (must have compatible config — rebuild with
    `setup(root_num)` / `resize` first if shapes differ)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))

    cfg = meta["config"]
    if cfg["root_num"] != engine.config.root_num:
        engine.setup(cfg["root_num"])
    ck_flow = tuple(cfg["flow_res"]) if cfg["flow_res"] else None
    ck_flow_shape = ck_flow if ck_flow else tuple(cfg["view_res"])
    if (tuple(cfg["view_res"]) != tuple(engine.config.view_res)
            or ck_flow_shape != tuple(engine.config.flow_shape)):
        engine.resize(tuple(cfg["view_res"]), ck_flow)

    engine.sim = convert.sim_from_numpy({k: data[k] for k in data.files},
                                        device=engine.device)
    # The config's `color_map_res` follows the loaded map, as after
    # `set_color_map`: the draw samples a textured map per particle only
    # when the config says it has one.
    cm_res = tuple(engine.sim.color_map.shape[1:])
    if cm_res != tuple(engine.config.color_map_res):
        engine.config = dataclasses.replace(engine.config,
                                            color_map_res=cm_res)
    engine.reseed_derived()
    engine.state.update(meta["state"])
    for k, v in meta["timer"].items():
        setattr(engine.timer, k, v)
    return engine
