"""The logic step on one hand-written CUDA kernel.

  K13 `logic_step` (csrc/logic.cu) per particle: the row's uv and index01
      from its original index, the two simplex-noise wander calls, the
      parameter variance, damping, the flow and wander accumulation, the
      target term, the speed clamp, the Euler step and the inert mask, in
      one pass over the particles.

The JAX package has no TPU kernel here: XLA fuses the step under jit
(`tendrils_tpu/ops/logic.py`). Its plain version is
`state.particle_coords_from_idx` then `logic.step_with_force`, taken for CPU
tensors; on the card K13 equals it bit for bit. The flow force is an input:
the carried force, one gathered before the call, or None under `flow_off`
(the flow term adds 0.0). The parameters, `time` and `dt` are read through
device pointers, so a changed parameter costs no host read and no sync.
"""

import torch

from .. import state as state_mod
from . import cuda_lib, logic

_F32 = torch.float32
# The parameters K13 reads, in the order of csrc/logic.cu's `Param`, which
# then takes `time` and `dt`.
PARAM_KEYS = ("noiseScale", "varyNoiseScale", "noiseSpeed", "varyNoiseSpeed",
              "forceWeight", "varyForce", "flowWeight", "varyFlow",
              "noiseWeight", "varyNoise", "damping", "target", "varyTarget",
              "speedLimit")


def logic_step(particles, targets, idx, force, params, time, dt, root_num):
    """K13: one logic step, `particles f32[4, N]` -> `f32[4, N]` (a new
    tensor). `targets`: `f32[4, N]`, rows 0-1 read; `idx`: `i32[N]`, the
    rows' original indices; `force`: the flow force `f32[2, N]`, or None
    for none (`flow_off`); `params`: the engine's parameter tensors;
    `time`, `dt`: numbers or 0-d tensors; `root_num`: the particle grid's
    side."""
    rows = (particles, targets, idx) + (() if force is None else (force,))
    if cuda_lib.on_cpu(*rows):
        return logic_step_plain(particles, targets, idx, force, params, time,
                                dt, root_num)
    n = particles.shape[1]
    device = particles.device
    particles = particles.contiguous()
    targets = targets.contiguous()
    cuda_lib.check(particles, "particles", _F32, (4, n))
    cuda_lib.check(targets, "targets", _F32, (4, n))
    cuda_lib.check(idx, "idx", torch.int32, (n,))
    if force is not None:
        force = force.contiguous()
        cuda_lib.check(force, "force", _F32, (2, n))
    # A 0-d f32 tensor on the device is passed as it is; a number is copied.
    scalars = [torch.as_tensor(v, dtype=_F32, device=device)
               for v in (*(params[k] for k in PARAM_KEYS), time, dt)]
    if any(t.numel() != 1 for t in scalars):
        raise ValueError("logic_step: a parameter, time or dt that is not "
                         "one number")
    out = torch.empty_like(particles)
    cuda_lib.launch("tt_logic_step", "logic_step", particles, targets, force,
                    idx, n, root_num, *scalars, out)
    return out


def logic_step_plain(particles, targets, idx, force, params, time, dt,
                     root_num):
    """Plain version of K13."""
    cuda_lib.plain_calls["logic_step"] += 1
    uv, index01, _ = state_mod.particle_coords_from_idx(idx, root_num)
    return logic.step_with_force(particles, targets, params, uv, index01,
                                 time, dt, 0.0 if force is None else force)
