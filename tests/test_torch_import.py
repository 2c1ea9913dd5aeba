"""`import tendrils_tpu_torch` loads neither JAX nor Triton, at any depth:
the package, its engine modules, its application layer (`app`,
`animate`, `audio`, `io` and the CLI's module, `__main__`, imported, not
run), its host modules (`geom`, `native`, `utils`, `ops.physics`,
`ops.glsl_utils`) and its multi-device package (`parallel`: `comm`,
`sharding`, `spatial`, `dryrun`)."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_or_triton():
    code = ("import sys, tendrils_tpu_torch, tendrils_tpu_torch.convert, "
            "tendrils_tpu_torch.models, tendrils_tpu_torch.spawners, "
            "tendrils_tpu_torch.media, tendrils_tpu_torch.flow_line, "
            "tendrils_tpu_torch.ops.splat, tendrils_tpu_torch.ops.splat_cuda, "
            "tendrils_tpu_torch.ops.optical_flow, tendrils_tpu_torch.app, "
            "tendrils_tpu_torch.app.keys, tendrils_tpu_torch.app.sub, "
            "tendrils_tpu_torch.animate, tendrils_tpu_torch.audio, "
            "tendrils_tpu_torch.io, tendrils_tpu_torch.__main__, "
            "tendrils_tpu_torch.geom, tendrils_tpu_torch.native, "
            "tendrils_tpu_torch.utils.fp, "
            "tendrils_tpu_torch.utils.profiling, "
            "tendrils_tpu_torch.ops.physics, "
            "tendrils_tpu_torch.ops.glsl_utils, "
            "tendrils_tpu_torch.ops.render, "
            "tendrils_tpu_torch.ops.fixed_point, "
            "tendrils_tpu_torch.parallel, tendrils_tpu_torch.parallel.comm, "
            "tendrils_tpu_torch.parallel.sharding, "
            "tendrils_tpu_torch.parallel.spatial, "
            "tendrils_tpu_torch.parallel.dryrun\n"
            "print(sorted(m for m in ('jax', 'triton', 'tendrils_tpu') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
