"""K2's roofline count at both configurations' shapes."""

import json
import math

from benchmark import cell, trace


def _k2():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "k2", cell.DIR / "metrics" / "k2_roofline_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_padded_grid_matches_the_port():
    from tendrils_tpu_torch.ops.tile_geom import pad_dims
    k2 = _k2()
    for hw in ((1080, 1920), (2160, 3840), (32, 128), (720, 1280)):
        assert k2.pad_dims(*hw) == pad_dims(*hw)


def test_bytes_at_both_configurations():
    k2 = _k2()
    # tier1-1080p: 1,048,576 rows of 3 words, 11 planes of 1136 x 2560.
    assert k2.k2_bytes(1 << 20, (1080, 1920), 3, 11) == \
        4 * 3 * (1 << 20) + 11 * 1136 * 2560 * 4 + 128
    # show16m-4k: 16,777,216 rows, 11 planes of 2208 x 4608.
    assert k2.k2_bytes(1 << 24, (2160, 3840), 3, 11) == \
        4 * 3 * (1 << 24) + 11 * 2208 * 4608 * 4 + 128
    assert math.isclose(trace.bound_ms(k2.k2_bytes(1 << 20, (1080, 1920),
                                                   3, 11)),
                        0.041953, rel_tol=1e-4)
    assert math.isclose(trace.bound_ms(k2.k2_bytes(1 << 24, (2160, 3840),
                                                   3, 11)),
                        0.193732, rel_tol=1e-4)
    # The rgba8 stream of a textured colour map: a fourth word a row.
    assert k2.k2_bytes(1 << 20, (1080, 1920), 4, 11) - \
        k2.k2_bytes(1 << 20, (1080, 1920), 3, 11) == 4 * (1 << 20)


def test_the_configurations_hold_those_shapes():
    for name, root, hw in (("tier1-1080p", 1024, [1080, 1920]),
                           ("show16m-4k", 4096, [2160, 3840])):
        cfg = json.loads((cell.DIR / "configs" / f"{name}.json").read_text())
        assert cfg["engine"]["root_num"] == root
        assert cfg["engine"]["view_res"] == hw


def test_roofline_reads_the_named_kernels():
    from benchmark.trace import TraceView
    k2 = _k2()
    cfg = json.loads((cell.DIR / "configs" / "tier1-1080p.json").read_text())
    ops = [("(anonymous namespace)::splat_tile_kernel((anonymous "
            "namespace)::Params, int const*)", 0.0, 1000.0),
           ("(anonymous namespace)::splat_convert_kernel(float const*)",
            1000.0, 1100.0),
           ("(anonymous namespace)::splat_points_convert_kernel(long*)",
            1100.0, 5000.0),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 0.0,
            9000.0)]
    view = TraceView(frames=1, device_ops=ops, stretch=(0.0, 9000.0),
                     counters={"splat": 4, "pack": 1}, config=cfg)
    want = 100.0 * trace.bound_ms(k2.k2_bytes(1 << 20, (1080, 1920), 3, 11)) \
        / 1.1
    assert math.isclose(k2.read(view), want)
    view.counters = {"splat_rgba": 4}
    assert k2.read(view) > want
    view.counters = {"pack": 1}
    assert k2.read(view) is None
