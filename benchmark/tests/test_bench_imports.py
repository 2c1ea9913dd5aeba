"""The import check: top-level module names compared whole."""

import subprocess
import sys
import textwrap

from conftest import ROOT


def _run_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_run", ROOT / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_names_compared_whole():
    run = _run_module()
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "tendrils_tpu", "tendrils_tpu.engine", "tendrils_tpu_torch",
            "tendrils_tpu_torch.engine", "jaxtyping", "flaxen", "numpy"]
    assert run.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "tendrils_tpu", "tendrils_tpu.engine"]
    assert run.forbidden_modules(["tendrils_tpu_torch.ops.cuda_lib"]) == []


def test_a_run_loads_no_jax():
    """A tiny run on the CPU, the harness, the program and the reference
    in one fresh process, leaves no JAX module loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
        from conftest import tiny
        from benchmark import harness
        result, _, _ = harness.run(tiny("show16m-show"), 9, 0.1, False, 0.0,
                                   device="cpu")
        assert result["correct"]
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "r", {str(ROOT / 'benchmark' / 'run.py')!r})
        run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run)
        print("FORBIDDEN", run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tier1-headless",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "tendrils_tpu_torch" in out.stderr


def test_run_refuses_without_a_card():
    """No card visible (as here): a non-zero exit and no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tier1-headless",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
