"""The benchmark of `tendrils_tpu_torch` on one NVIDIA H100, driven by
`BENCHMARK.json` at the root of the repository. `run.py` runs one cell
once; see it for the command. Nothing here imports JAX or the JAX
package."""
