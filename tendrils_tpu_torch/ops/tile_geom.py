"""Padded-grid geometry shared with the JAX package's fused draw.

The fused draw accumulates into a PADDED `f32[11, hp, wp]` grid whose
content starts at (`PAD_LO_H`, `PAD_LO_W`); the packed p1 word, the segment
tile key and the resolve all use this convention, so the port keeps the
reference's constants bit for bit (`tendrils_tpu/ops/tile_geom.py`, without
its `TT_REGION_*` environment overrides). The tiles enter the sort key,
and K2's tile pass owns one tile a block: a sample keyed by a tile whose
footprint lies in the tile's REGION_H x REGION_W region only touches the
2 x 2 tiles from there (`csrc/splat.cu`, `fits_key_tile`).
"""

HALF = 32767  # 15-bit field max of the packed fixed-point streams
TILE_H = 16
TILE_W = 256
REGION_H = 32
REGION_W = 384
PAD_LO_H, PAD_LO_W = TILE_H, TILE_W
PAD_HI_H, PAD_HI_W = REGION_H, REGION_W


def pad_dims(h, w):
    hp = (PAD_LO_H + h + PAD_HI_H + TILE_H - 1) // TILE_H * TILE_H
    wp = (PAD_LO_W + w + PAD_HI_W + TILE_W - 1) // TILE_W * TILE_W
    return hp, wp
