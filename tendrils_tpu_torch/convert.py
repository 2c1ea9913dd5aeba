"""State and parameter exchange with the JAX package, through numpy.

The JAX side hands over numpy arrays (or dicts of them), never JAX arrays,
so this module imports neither JAX nor `tendrils_tpu`. Used to start both
engines from the same state and to compare them.
"""

import dataclasses

import numpy as np
import torch

from .engine import EngineConfig
from .state import SimState

# JAX backend names -> the port's ("pallas" kernels become "kernel").
_BACKENDS = {"pallas": "kernel", "xla": "xla"}
_SIM_FIELDS = ("particles", "previous", "targets", "flow", "view",
               "color_map", "idx")
# Fields that may be None (absent).
_OPTIONAL = ("force", "sort_key", "sort_hist")


def engine_config(jax_cfg) -> EngineConfig:
    """The port's EngineConfig for a JAX `EngineConfig` (same fields)."""
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(EngineConfig)}
    kw["splat_backend"] = _BACKENDS[kw["splat_backend"]]
    kw["gather_backend"] = _BACKENDS[kw["gather_backend"]]
    return EngineConfig(**kw)


def sim_from_numpy(arrays, device="cuda") -> SimState:
    """A SimState on `device` from a dict of numpy arrays named like the
    JAX `SimState` fields. `force` and the merge-reorder carry (`sort_key`,
    `sort_hist`) may be absent or None; the JAX `key` is ignored (it has
    no counterpart)."""
    kw = {k: torch.tensor(np.asarray(arrays[k]), device=device)
          for k in _SIM_FIELDS}
    kw["idx"] = kw["idx"].to(torch.int32)
    for k in _OPTIONAL:
        if arrays.get(k) is not None:
            kw[k] = torch.tensor(np.asarray(arrays[k]), device=device)
    return SimState(**kw)


def sim_to_numpy(sim: SimState) -> dict:
    """The SimState as a dict of numpy arrays (`force`, `sort_key` and
    `sort_hist` None when absent)."""
    return {k: None if getattr(sim, k) is None
            else getattr(sim, k).cpu().numpy()
            for k in _SIM_FIELDS + _OPTIONAL}


def params_from_numpy(params, device="cuda") -> dict:
    """A params dict (numpy or Python values) as f32 tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def params_to_numpy(params) -> dict:
    return {k: v.cpu().numpy() for k, v in params.items()}
