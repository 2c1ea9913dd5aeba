"""`import tendrils_tpu_torch` loads neither JAX nor Triton, at any depth."""

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
            "tendrils_tpu_torch.ops.optical_flow\n"
            "print(sorted(m for m in ('jax', 'triton', 'tendrils_tpu') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
