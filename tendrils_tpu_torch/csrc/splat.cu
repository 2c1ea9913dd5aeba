// K2 splat — replaces tendrils_tpu/ops/draw_pallas.py:_kernel (launched
// from _bin_and_splat), in every variant the engine runs: the p0 word
// stream and the rgba8 colour stream are each optional (null pointers), as
// the TPU kernel's derive_p0 and scalar_color, and the flow channels are
// dropped under flow_off (`flowWeight == 0`), a launch parameter: `ch0`, the
// global channel of the scratch's first plane, 0 (all 11 planes, both
// channel groups) or N_FLOW (the view's 6 planes alone: one channel group
// in the tile pass, no flow deposits among the strays, 6 planes zeroed and
// converted). A plane keeps its global channel's fixed-point step, so the
// view planes of a view-only launch are bit-equal to planes N_FLOW.. of the
// 11-channel launch on the same stream.
//
// Each (sorted segment, sample) is re-derived from the packed words exactly
// as the TPU kernel does (`sample_geo`, `group_channels`): p0 from its word
// or as p1 - vel * viewScale (derive_p0), the colours from the rgba8 word or
// as the render colour model of a 1x1 colour map, the deposit mass from the
// major extent, the zero weight of samples the margin clamp moved, and the
// sample centre quantised to 1/pscale px. Its separable box footprints
// (width flowWidth for the 5 flow channels, lineWidth for the 6 view
// channels, each <= KMAX_WIDTH, so at most 9 x 9 texels) add into the
// PADDED [11, hp, wp] grid, the layout the resolve reads.
//
// The sums are int64 fixed point (common.cuh: `fixed_shift`): each deposit
// (wr * ch) * wc, computed in f32 as before, is quantised at a power-of-two
// scale per channel and added as an integer, so the accumulator does not
// depend on the order of the adds and a frame replays bit for bit. The
// scale comes from the most one add of a channel can weigh (`add_bound`)
// and the most adds one texel can receive, adds_rows x samples (a sample
// adds once to each texel of its box). `adds_rows`, a launch parameter, is
// the rows of the whole frame: n on one device; on a shard of a frame split
// over ranks, the frame's global row count, so that every rank quantises at
// the step one device takes for the same particles and the ranks' int64
// sums add up (before the conversion, pass 4) to that device's bit for bit.
//
// Bound: deposits. At config 2 that is ~2M samples x (36 texels x 5 flow
// channels + 4 texels x 6 view channels) ~ 4.3e8 adds a frame. Added with
// atomics straight into global memory they take 6.4 ms of the frame (an
// H100 at 700 W); this kernel adds them in shared memory, on the
// reference's own contract (draw_pallas.py:82-85, :255-263): the segments
// arrive sorted by a key whose tile is the top-left corner of their
// bounding box, and a sample whose footprint lies inside that key tile's
// REGION_H x REGION_W region (from the tile's origin) only touches the
// 2 x 2 output tiles (ty..ty+1, tx..tx+1). Four launches, stream-ordered:
//
//   1. `splat_plan_kernel`, one block per output tile: binary-searches the
//      sorted keys for the rows of its <= 4 source tiles (ty-1..ty,
//      tx-1..tx; two contiguous runs), splits a tile with more than
//      `chunk` source rows (INFO) into parts, queues them (their blocks
//      run first, so a heavy tile is not the tail) and zeroes the split
//      tile's texels of the int64 scratch.
//      (Searching in the wrapper instead, with `torch.searchsorted`, left
//      the tile pass 0.1 ms slower in a config-2 frame on an H100, for
//      reasons not found.)
//   2. `splat_tile_kernel`, one block per (tile part, channel group): zeroes
//      its tile in shared memory (16 x 256 int64 texels a channel, rows
//      padded to 260 words), deposits every FITTING sample of its rows into
//      the texels of its own tile with shared-memory integer atomics, and
//      writes the tile into the int64 scratch with 16-byte stores (a split
//      tile: global 64-bit atomics into the zeroed tile). Every texel of
//      the scratch is written, so nothing zeroes it first. A warp gathers
//      its depositing samples and puts ks lanes on each, one a footprint
//      column (ks = 6 at flowWidth 5, so 5 samples a round; 16 at
//      lineWidth 1), each walking its column's rows: a sample's adds fall
//      on distinct texels at once, where one sample a lane put
//      neighbouring sorted samples on the same texels (1.4x slower on an
//      H100). Bound here: the shared adds, which do not slow as the
//      particles cluster (an H100 spends less block time a deposit in a
//      dense part than in a sparse one), so with the part cut above the
//      pass takes 0.53-0.55 ns a sample in a 16.7M frame, spread or late
//      in a window. Hopper
//      has no shared float add and no shared 64-bit integer add (each is a
//      compare-and-swap loop, ATOMS.CAST.SPIN and ATOMS.CAST.SPIN.64), so
//      a deposit is two native 32-bit adds (`add64`); split lo and hi word
//      planes, or a warp's rows taken sample by sample, were slower;
//   3. `splat_stray_kernel`, one thread per (segment, sample): the samples
//      that do NOT fit their key tile's region (long segments, such as a p0
//      far from p1 after a respawn) with global 64-bit atomics, counted;
//   4. `splat_convert_kernel`, one thread per 4 texels: the scratch to the
//      f32 accumulator, f32(sum) * 2^-S_k, coalesced.
//
// Every sample is deposited once, by pass 2 or pass 3; the fit test
// (`fits_key_tile`) reads the tile from the sorted key itself, as the
// plan's searches do, so the run a row is found in and the region its fit
// is tested against cannot disagree.
#include "common.cuh"

namespace {

using namespace tt;

constexpr int N_VIEW = N_CHAN - N_FLOW;
// The tile pass: one block of TILE_THREADS an SM (its 200 KB tile leaves
// room for no second), so the block has every warp the SM can hold.
constexpr int TILE_THREADS = 1024;
constexpr int PLAN_THREADS = 256;
constexpr int CONVERT_THREADS = 256;
// Shared tile rows of int64 texels, padded by 4 words: the rows of a
// footprint start 8 banks apart; 16-byte aligned for the vector stores.
// The tile holds the wider channel group, the view's 6 channels.
constexpr int SROW = TILE_W + 4;
constexpr int SPLANE = TILE_H * SROW;
constexpr int TILE_SMEM =
    N_VIEW * SPLANE * (int)sizeof(long long);  // 199,680 B
// Per-tile plan words: the starts of its source tiles' runs, above-left,
// above, left and its own, and their end (a0, am, a1, b0, bm, b1), the
// parts and the source rows. Every source row counts alike in the part
// cut: a row keyed in a neighbouring tile can land in this one as fully
// as the tile's own, where the flow piles particles along an edge of the
// grid (at 16.7M late in a window, such tiles take ~1M samples: counted
// at less than a full row, they stay whole, and their blocks run ~10 ms
// past the rest of the pass on an H100).
constexpr int INFO = 8;

struct Params {
  const float* scal;
  const int* keys;
  const int* p1w;
  const int* vlw;
  const int* p0w;
  const int* rgbaw;
  int n, samples, h, w, hp, wp, tiles_x, bits;
  float pscale;
  int ch0;  // global channel of the scratch's first plane: 0 or N_FLOW
  int adds_rows;  // rows whose adds the fixed-point steps leave room for
};

// The channel groups a launch deposits (the tile pass's gridDim.y): the
// flow's and the view's, or the view's alone.
__host__ __device__ __forceinline__ int channel_groups(int ch0) {
  return ch0 == 0 ? 2 : 1;
}

// The most one add of global channel k can weigh, from `group_channels`
// (the box weights wr <= 1 / width <= 1 and wc <= 1 only shrink it): flow
// vx.a and vy.a speedLimit (|unq15| <= 1, a < 1), wf.a and a 1, the logs
// LOG_BOUND (a <= 1 - 1e-4); view r.a, g.a, b.a and a.a COLOR_MAX (each
// colour clamped or decoded into [0, COLOR_MAX]), a 1, the log LOG_BOUND.
constexpr float LOG_BOUND = 9.22f;  // > -log(1e-4) = 9.2103

__device__ __forceinline__ float add_bound(const float* scal, int k) {
  switch (k) {
    case 0:
    case 1:
      return fabsf(scal[0]);
    case 2:
    case 3:
    case N_FLOW + 4:
      return 1.0f;
    case 4:
    case N_CHAN - 1:
      return LOG_BOUND;
    default:
      return COLOR_MAX;
  }
}

// S_k of global channel k for a frame of adds_rows segments x samples.
__device__ __forceinline__ int channel_shift(const float* scal, int k,
                                             int adds_rows, int samples) {
  return fixed_shift(add_bound(scal, k), (long long)adds_rows * samples);
}

// Box-overlap coverage of texel `idx` by the footprint [lo, hi).
__device__ __forceinline__ float cover(float idx, float lo, float hi) {
  return clampf(fminf(idx + 1.0f, hi) - fmaxf(idx, lo), 0.0f, 1.0f);
}

// One sample's placement: the quantised centre (gx, gy), its deposit mass
// a, and what its channels need.
struct Geo {
  float gx, gy, a, vx, vy, p1x, p1y;
};

// Sample s of sorted segment i, op for op as the TPU kernel. False when
// its mass is 0 (a dead row, or a sample the margin clamp moved): every
// channel of it is exactly 0.
__device__ __forceinline__ bool sample_geo(const Params& P, int i, int s,
                                           Geo& g) {
  const float* scal = P.scal;
  const float speed_limit = scal[0];
  const float inv_p = 1.0f / P.pscale;
  const int p1 = P.p1w[i];
  const int vl = P.vlw[i];
  const float p1x = (float)(p1 & HALF) * inv_p;
  const float p1y = (float)(p1 >> 15) * inv_p;
  const float live = (float)(vl >> 30);
  const int vel_u = vl & ((1 << 30) - 1);
  const float vx = unq15(vel_u & HALF) * speed_limit;
  const float vy = unq15(vel_u >> 15) * speed_limit;
  float p0x, p0y;
  if (P.p0w == nullptr) {
    // derive_p0: Euler inverse in pixel space.
    p0x = clampf(p1x - vx * (scal[30] * 0.5f * (float)P.w), 1.0f,
                 (float)(PAD_LO_W + P.w) + 1.0f);
    p0y = clampf(p1y - vy * (scal[31] * 0.5f * (float)P.h), 1.0f,
                 (float)(PAD_LO_H + P.h) + 1.0f);
  } else {
    const int p0 = P.p0w[i];
    p0x = (float)(p0 & HALF) * inv_p;
    p0y = (float)(p0 >> 15) * inv_p;
  }
  const float dx = p1x - p0x;
  const float dy = p1y - p0y;
  // GL's DDA lights one fragment per major-axis pixel: mass ~ major extent.
  const float ascale = live * fmaxf(fmaxf(fabsf(dx), fabsf(dy)), 1.0f) /
                       (float)P.samples;
  // As JAX: (s + 0.5) / samples in double, rounded once.
  const float ts = (float)((s + 0.5) / P.samples);
  const float xu = p0x + dx * ts;
  const float yu = p0y + dy * ts;
  const float xp = clampf(xu, 1.0f, (float)(PAD_LO_W + P.w) + 1.0f);
  const float yp = clampf(yu, 1.0f, (float)(PAD_LO_H + P.h) + 1.0f);
  g.a = (xu != xp || yu != yp) ? 0.0f : ascale;
  g.gx = (float)(int)rintf(xp * P.pscale) * inv_p - 0.5f;
  g.gy = (float)(int)rintf(yp * P.pscale) * inv_p - 0.5f;
  g.vx = vx;
  g.vy = vy;
  g.p1x = p1x;
  g.p1y = p1y;
  return g.a != 0.0f;
}

// Render colour model of a 1x1 colour map (draw_pallas `_kernel`
// scalar_color; common.cuh:color_model) from the un-quantised velocity, the
// vignette position derived from p1: (r, g, b, a) into c[0..3].
__device__ __forceinline__ void scalar_colors(const float* __restrict__ scal,
                                              float vx, float vy, float p1x,
                                              float p1y, int h, int w,
                                              float* c) {
  const float inv_sl = 1.0f / fmaxf(scal[0], 1e-12f);
  const float posx = ((p1x - (float)PAD_LO_W) * (float)(2.0 / w) - 1.0f) /
                     fmaxf(scal[30], 1e-12f);
  const float posy = ((p1y - (float)PAD_LO_H) * (float)(2.0 / h) - 1.0f) /
                     fmaxf(scal[31], 1e-12f);
  color_model(scal, vx * inv_sl, vy * inv_sl, posx, posy, scal[16],
              scal[17], scal[18], scal[19], c);
  for (int k = 0; k < 4; ++k) c[k] = clampf(c[k], 0.0f, COLOR_MAX);
}

// The NCH channel values of one channel group of a placed sample: the
// flow's (vx.a, vy.a, wf.a, a, log(1-a)) or the view's (r.a, g.a, b.a,
// a.a, a, log(1-a)). False when the group's alpha is 0 (nothing to add).
template <int NCH>
__device__ __forceinline__ bool group_channels(const Params& P, int i,
                                               const Geo& g, float* ch) {
  if (NCH == N_FLOW) {
    const float wf = fminf(sqrtf(g.vx * g.vx + g.vy * g.vy) / P.scal[0],
                           1.0f);
    const float af = fminf(wf * g.a, (float)(1.0 - 1e-4));
    if (!(af > 0.0f)) return false;
    ch[0] = g.vx * af;
    ch[1] = g.vy * af;
    ch[2] = wf * af;
    ch[3] = af;
    ch[4] = log1pf(-af);
    return true;
  }
  float c[4];
  if (P.rgbaw != nullptr) {
    // The rgba8 word K1 packed (draw_pallas.py:323-329).
    const int rgba = P.rgbaw[i];
    const float c8 = (float)(4.0 / 255.0);
    c[0] = (float)(rgba & 255) * c8;
    c[1] = (float)((rgba >> 8) & 255) * c8;
    c[2] = (float)((rgba >> 16) & 255) * c8;
    c[3] = (float)((rgba >> 24) & 127) * (float)(4.0 / 127.0);
  } else {
    scalar_colors(P.scal, g.vx, g.vy, g.p1x, g.p1y, P.h, P.w, c);
  }
  const float av = clampf(c[3] * g.a, 0.0f, (float)(1.0 - 1e-4));
  if (!(av > 0.0f)) return false;
  ch[0] = c[0] * av;
  ch[1] = c[1] * av;
  ch[2] = c[2] * av;
  ch[3] = c[3] * av;
  ch[4] = av;
  if (NCH > 5) ch[NCH - 1] = log1pf(-av);
  return true;
}

// Clamped box width of channel group `NCH` (flowWidth or lineWidth) and
// half the wider of the two: the footprint the fit test bounds.
template <int NCH>
__device__ __forceinline__ float group_width(const float* scal) {
  return clampf(scal[NCH == N_FLOW ? 2 : 3], 1.0f, KMAX_WIDTH);
}

__device__ __forceinline__ float half_widest(const float* scal) {
  return fmaxf(clampf(scal[2], 1.0f, KMAX_WIDTH),
               clampf(scal[3], 1.0f, KMAX_WIDTH)) * 0.5f;
}

// Whether a sample's footprint (the wider box, half-width hwm) lies in the
// region of its sorted key's tile (tests/test_torch_splat_tiles.py holds a
// transcription to the reference's rule). At the grid's top and left edges
// the region reaches out past them: texels there do not exist, in either
// pass.
__device__ __forceinline__ bool fits_key_tile(const Params& P, int key,
                                              float gx, float gy,
                                              float hwm) {
  const int tile = key >> P.bits;
  const int ty = tile / P.tiles_x;
  const float row0 = (float)(ty * TILE_H);
  const float col0 = (float)((tile - ty * P.tiles_x) * TILE_W);
  return (row0 == 0.0f || gy + (0.5f - hwm) >= row0) &&
         gy + (0.5f + hwm) <= row0 + REGION_H &&
         (col0 == 0.0f || gx + (0.5f - hwm) >= col0) &&
         gx + (0.5f + hwm) <= col0 + REGION_W;
}

// --- pass 1: the plan --------------------------------------------------------

// `queue`: the count of queued parts, the count of strays (pass 3), then
// (tile, part) pairs.
constexpr int QUEUE_HEAD = 2;

// First row of the tile-sorted keys whose tile is >= `tile`.
__device__ __forceinline__ int tile_start(const int* __restrict__ keys, int n,
                                          int bits, int tile) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((keys[mid] >> bits) < tile) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void splat_plan_kernel(const int* __restrict__ keys, int n,
                                  int bits, int tiles_x, int hp, int wp,
                                  int chunk, int ch0,
                                  int* __restrict__ info,
                                  int* __restrict__ queue, int queue_cap,
                                  long long* __restrict__ fix) {
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  __shared__ int parts_s;
  if (threadIdx.x == 0) {
    // Source tiles (ty-1..ty, tx-1..tx): one run of rows in each tile row.
    const int lo = tx > 0 ? tx - 1 : 0;
    int a0 = 0, am = 0, a1 = 0;
    if (ty > 0) {
      a0 = tile_start(keys, n, bits, (ty - 1) * tiles_x + lo);
      am = tile_start(keys, n, bits, (ty - 1) * tiles_x + tx);
      a1 = tile_start(keys, n, bits, (ty - 1) * tiles_x + tx + 1);
    }
    const int b0 = tile_start(keys, n, bits, ty * tiles_x + lo);
    const int bm = tile_start(keys, n, bits, t);
    const int b1 = tile_start(keys, n, bits, t + 1);
    const int w = (a1 - a0) + (b1 - b0);
    const int parts = w > chunk ? (w + chunk - 1) / chunk : 1;
    int* in = info + INFO * t;
    in[0] = a0;
    in[1] = am;
    in[2] = a1;
    in[3] = b0;
    in[4] = bm;
    in[5] = b1;
    in[6] = parts;
    in[7] = w;
    if (parts > 1) {
      const int base = atomicAdd(queue, parts);
      for (int j = 0; j < parts && base + j < queue_cap; ++j) {
        queue[QUEUE_HEAD + 2 * (base + j)] = t;
        queue[QUEUE_HEAD + 1 + 2 * (base + j)] = j;
      }
    }
    parts_s = parts;
  }
  __syncthreads();
  if (parts_s == 1) return;
  // A split tile: its parts add into it with global atomics, so zero it.
  const long long plane = (long long)hp * wp;
  long long* tile0 = fix + (long long)(ty * TILE_H) * wp + tx * TILE_W;
  constexpr int Q = TILE_W / 2;  // 16-byte stores of two texels
  for (int k = threadIdx.x; k < (N_CHAN - ch0) * TILE_H * Q;
       k += blockDim.x) {
    const int c2 = k % Q;
    const int r = (k / Q) % TILE_H;
    const int ch = k / (Q * TILE_H);
    *reinterpret_cast<longlong2*>(tile0 + ch * plane + (long long)r * wp +
                                  2 * c2) = make_longlong2(0, 0);
  }
}

// --- pass 2: the tile pass ---------------------------------------------------

// A sample's box of half-width hw around (gx, gy): its extent and the
// rows and columns it can touch from (r0, c0), at most KSPAN each, as the
// stray pass and the plain version iterate them.
struct Box {
  float lo_y, hi_y, lo_x, hi_x, r0, c0;
  int nr, nc;
};

__device__ __forceinline__ Box box_of(float gx, float gy, float hw) {
  Box b;
  b.lo_y = gy + (0.5f - hw);
  b.hi_y = gy + (0.5f + hw);
  b.lo_x = gx + (0.5f - hw);
  b.hi_x = gx + (0.5f + hw);
  b.r0 = floorf(b.lo_y);
  b.c0 = floorf(b.lo_x);
  b.nr = min((int)(ceilf(b.hi_y) - b.r0), KSPAN);
  b.nc = min((int)(ceilf(b.hi_x) - b.c0), KSPAN);
  return b;
}

// Add q into the int64 shared texel p, exactly, whatever the order of the
// adds: two native 32-bit adds (ATOMS.ADD), the low word's, whose old
// value gives the carry into the high word (old + lo wraps below old), and
// the high word's, skipped when it adds 0. The low words' carries are
// counted in full, so the 64-bit sum is exact.
__device__ __forceinline__ void add64(unsigned long long* p, long long q) {
  unsigned* w = reinterpret_cast<unsigned*>(p);
  const unsigned lo = (unsigned)q;
  unsigned hi = (unsigned)((unsigned long long)q >> 32);
  if (lo != 0u) {
    const unsigned old = atomicAdd(w, lo);
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi != 0u) atomicAdd(w + 1, hi);
}

// Column dx of box b, channels ch (quantised at `scale`), into the NCH
// planes of the shared tile at (row0, col0): the texels of that column
// that lie in the tile, row by row.
template <int NCH>
__device__ __forceinline__ void tile_column(
    unsigned long long* __restrict__ sm, const float* ch, const float* scale,
    const Box& b, int dx, float inv_w, int row0, int col0) {
  const float cf = b.c0 + (float)dx;
  const int c = (int)cf - col0;
  const float wc = cover(cf, b.lo_x, b.hi_x);
  if (c < 0 || c >= TILE_W || wc <= 0.0f) return;
  for (int dy = 0; dy < b.nr; ++dy) {
    const float rf = b.r0 + (float)dy;
    const int r = (int)rf - row0;
    if (r < 0 || r >= TILE_H) continue;
    const float wr = cover(rf, b.lo_y, b.hi_y) * inv_w;
    if (wr <= 0.0f) continue;
    unsigned long long* t = sm + r * SROW + c;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      add64(t + k * SPLANE, quantise((wr * ch[k]) * wc, scale[k]));
    }
  }
}

// One tile part's channel group NCH (N_FLOW: the flow's, N_VIEW: the
// view's), into `fix` at the group's first plane. Its steps are those of
// the group's global channels, whatever plane the group starts at.
template <int NCH>
__device__ __forceinline__ void tile_body(const Params& P, int t, int part,
                                          const int* __restrict__ info,
                                          unsigned long long* __restrict__ sm,
                                          long long* __restrict__ fix) {
  const int ty = t / P.tiles_x;
  const int row0 = ty * TILE_H;
  const int col0 = (t - ty * P.tiles_x) * TILE_W;
  longlong2* sm2 = reinterpret_cast<longlong2*>(sm);
  for (int k = threadIdx.x; k < NCH * SPLANE / 2; k += blockDim.x) {
    sm2[k] = make_longlong2(0, 0);
  }
  float scale[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    scale[k] = pow2f(channel_shift(P.scal, (NCH == N_FLOW ? 0 : N_FLOW) + k,
                                   P.adds_rows, P.samples));
  }
  __syncthreads();

  const int* in = info + INFO * t;
  const int a0 = in[0], na = in[2] - in[0], b0 = in[3];
  const int parts = in[6];
  // Part j of `parts` takes rows [w j / parts, w (j + 1) / parts) of the
  // source rows laid end to end (above-left, above, left, own).
  const long long w = in[7];
  const int lo = (int)(w * part / parts);
  const int hi = (int)(w * (part + 1) / parts);
  const float width = group_width<NCH>(P.scal);
  const float hw = width * 0.5f;
  const float inv_w = 1.0f / width;
  const float hwm = half_widest(P.scal);
  // Lanes over footprint columns: `per` samples a round, ks lanes on each
  // (ks the columns a box of this width touches, but where float rounding
  // adds one: those boxes go whole to their own thread), every lane
  // walking its column's rows.
  const int ks = min((int)ceilf(width) + 1, KSPAN);
  const int lane = threadIdx.x & 31;
  const int per = 32 / ks;
  const int slot = lane / ks;
  const int dcol = lane - slot * ks;
  const long long items = (long long)(hi - lo) * P.samples;
  // Uniform trip count over the block: the lane mapping shuffles.
  for (long long base = 0; base < items; base += blockDim.x) {
    const long long it = base + threadIdx.x;
    bool dep = false;
    Geo g;
    g.gx = g.gy = 0.0f;
    float ch[NCH];
    if (it < items) {
      const int k = lo + (int)(it / P.samples);
      const int s = (int)(it - (long long)(k - lo) * P.samples);
      const int i = k < na ? a0 + k : b0 + (k - na);
      if (sample_geo(P, i, s, g) &&
          fits_key_tile(P, P.keys[i], g.gx, g.gy, hwm)) {
        // Does its box touch this tile?
        const Box b = box_of(g.gx, g.gy, hw);
        dep = b.hi_y > (float)row0 && b.lo_y < (float)(row0 + TILE_H) &&
              b.hi_x > (float)col0 && b.lo_x < (float)(col0 + TILE_W) &&
              group_channels<NCH>(P, i, g, ch);
        if (dep && b.nc > ks) {
          for (int dx = 0; dx < b.nc; ++dx) {
            tile_column<NCH>(sm, ch, scale, b, dx, inv_w, row0, col0);
          }
          dep = false;
        }
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, dep);
    // This lane holds the rank-`lane` sample's source lane.
    const int rank_src = (int)__fns(mask, 0, lane + 1);
    const int ndep = __popc(mask);
    for (int s0 = 0; s0 < ndep; s0 += per) {
      const int r = s0 + slot;
      const bool act = slot < per && r < ndep;
      const int src = __shfl_sync(0xffffffffu, rank_src, act ? r : 0) & 31;
      const float sgx = __shfl_sync(0xffffffffu, g.gx, src);
      const float sgy = __shfl_sync(0xffffffffu, g.gy, src);
      float sch[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        sch[k] = __shfl_sync(0xffffffffu, dep ? ch[k] : 0.0f, src);
      }
      if (act) {
        const Box b = box_of(sgx, sgy, hw);
        if (dcol < b.nc) {
          tile_column<NCH>(sm, sch, scale, b, dcol, inv_w, row0, col0);
        }
      }
    }
  }
  __syncthreads();

  // Write the tile out: 16-byte stores, or coalesced 64-bit atomics into a
  // split (zeroed) tile.
  const long long plane = (long long)P.hp * P.wp;
  long long* tile0 = fix + (long long)row0 * P.wp + col0;
  constexpr int Q = TILE_W / 2;
  for (int k = threadIdx.x; k < NCH * TILE_H * Q; k += blockDim.x) {
    const int c2 = k % Q;
    const int r = (k / Q) % TILE_H;
    const int c = k / (Q * TILE_H);
    const longlong2 v = sm2[(c * SPLANE + r * SROW) / 2 + c2];
    long long* dst = tile0 + c * plane + (long long)r * P.wp + 2 * c2;
    if (parts == 1) {
      *reinterpret_cast<longlong2*>(dst) = v;
    } else {
      atomicAdd(reinterpret_cast<unsigned long long*>(dst),
                (unsigned long long)v.x);
      atomicAdd(reinterpret_cast<unsigned long long*>(dst) + 1,
                (unsigned long long)v.y);
    }
  }
}

// Blocks [0, queue_cap) take the queued parts of split tiles (first, so
// the heavy work starts early; the unused ones exit), blocks [queue_cap,
// queue_cap + tiles) the tiles that are not split. blockIdx.y: the
// channel group (0 flow, 1 view; the view alone when ch0 = N_FLOW).
__global__ void __launch_bounds__(TILE_THREADS, 1)
    splat_tile_kernel(Params P, const int* __restrict__ info,
                      const int* __restrict__ queue, int queue_cap,
                      long long* __restrict__ fix) {
  extern __shared__ longlong2 smem[];
  unsigned long long* sm = reinterpret_cast<unsigned long long*>(smem);
  const int b = blockIdx.x;
  int t = b - queue_cap, part = 0;
  if (b < queue_cap) {
    if (b >= queue[0]) return;
    t = queue[QUEUE_HEAD + 2 * b];
    part = queue[QUEUE_HEAD + 1 + 2 * b];
  } else if (info[INFO * t + 6] > 1) {
    return;
  }
  // The launch's groups are the last channel_groups(ch0) of (flow, view).
  const int group = (int)blockIdx.y + 2 - channel_groups(P.ch0);
  if (group == 0) {
    tile_body<N_FLOW>(P, t, part, info, sm, fix);
  } else {
    tile_body<N_VIEW>(P, t, part, info, sm,
                      fix + (N_FLOW - P.ch0) * (long long)P.hp * P.wp);
  }
}

// --- pass 3: the strays ------------------------------------------------------

// Add chans[0..nch) x box(width 2*hw) around (gx, gy), quantised at
// `scale`, into nch planes of the global int64 scratch.
template <int NCH>
__device__ __forceinline__ void deposit(long long* __restrict__ fix, int hp,
                                        int wp, const float* chans,
                                        const float* scale, float gx,
                                        float gy, float hw, float inv_w) {
  const float lo_y = gy + (0.5f - hw);
  const float hi_y = gy + (0.5f + hw);
  const float lo_x = gx + (0.5f - hw);
  const float hi_x = gx + (0.5f + hw);
  const float r0 = floorf(lo_y);
  const float c0 = floorf(lo_x);
  const long long plane = (long long)hp * wp;
  for (int dy = 0; dy < KSPAN; ++dy) {
    const float rf = r0 + (float)dy;
    const float wr = cover(rf, lo_y, hi_y) * inv_w;
    const int r = (int)rf;
    if (wr <= 0.0f || r < 0 || r >= hp) continue;
    for (int dx = 0; dx < KSPAN; ++dx) {
      const float cf = c0 + (float)dx;
      const float wc = cover(cf, lo_x, hi_x);
      const int c = (int)cf;
      if (wc <= 0.0f || c < 0 || c >= wp) continue;
      unsigned long long* texel =
          reinterpret_cast<unsigned long long*>(fix) + (long long)r * wp + c;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        atomicAdd(texel + k * plane, (unsigned long long)quantise(
                                         (wr * chans[k]) * wc, scale[k]));
      }
    }
  }
}

__global__ void splat_stray_kernel(Params P, int* __restrict__ strays,
                                   long long* __restrict__ fix) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)P.n * P.samples) return;
  const int i = (int)(t / P.samples);
  const int s = (int)(t - (long long)i * P.samples);
  Geo g;
  if (!sample_geo(P, i, s, g)) return;
  if (fits_key_tile(P, P.keys[i], g.gx, g.gy, half_widest(P.scal))) return;
  atomicAdd(strays, 1);
  float ch[N_VIEW], scale[N_VIEW];
  if (P.ch0 == 0 && group_channels<N_FLOW>(P, i, g, ch)) {
    const float width = group_width<N_FLOW>(P.scal);
    for (int k = 0; k < N_FLOW; ++k) {
      scale[k] = pow2f(channel_shift(P.scal, k, P.adds_rows, P.samples));
    }
    deposit<N_FLOW>(fix, P.hp, P.wp, ch, scale, g.gx, g.gy, width * 0.5f,
                    1.0f / width);
  }
  if (group_channels<N_VIEW>(P, i, g, ch)) {
    const float width = group_width<N_VIEW>(P.scal);
    for (int k = 0; k < N_VIEW; ++k) {
      scale[k] =
          pow2f(channel_shift(P.scal, N_FLOW + k, P.adds_rows, P.samples));
    }
    deposit<N_VIEW>(fix + (N_FLOW - P.ch0) * (long long)P.hp * P.wp, P.hp,
                    P.wp, ch, scale, g.gx, g.gy, width * 0.5f, 1.0f / width);
  }
}

// --- pass 4: the conversion --------------------------------------------------

// Thread i converts texels 4i..4i+3 of the flat [N_CHAN - ch0, hp, wp]
// scratch (a plane holds plane4 groups of 4; plane p is global channel
// ch0 + p).
__global__ void splat_convert_kernel(const float* __restrict__ scal,
                                     int adds_rows, int samples, int plane4,
                                     int ch0,
                                     const long long* __restrict__ fix,
                                     float* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(N_CHAN - ch0) * plane4) return;
  const float inv = pow2f(-channel_shift(scal, ch0 + (int)(i / plane4),
                                          adds_rows, samples));
  const longlong2* src = reinterpret_cast<const longlong2*>(fix) + 2 * i;
  const longlong2 a = __ldcs(src);
  const longlong2 b = __ldcs(src + 1);
  reinterpret_cast<float4*>(acc)[i] = make_float4(
      __ll2float_rn(a.x) * inv, __ll2float_rn(a.y) * inv,
      __ll2float_rn(b.x) * inv, __ll2float_rn(b.y) * inv);
}

Params make_params(const float* scal, const int* keys, const int* p1,
                   const int* vl, const int* p0, const int* rgba, int n,
                   int samples, int h, int w, int hp, int wp, int bits,
                   float pscale, int ch0, int adds_rows) {
  return Params{scal, keys, p1, vl, p0, rgba, n, samples, h, w, hp, wp,
                wp / TILE_W, bits, pscale, ch0, adds_rows};
}

}  // namespace

// Pass 1. `keys`: i32[n], tile-sorted, `tile << bits | id`; `info`:
// i32[INFO x tiles]; `queue`: i32[QUEUE_HEAD + 2 x queue_cap]; `chunk`:
// the most source rows a part takes; `ch0`: the global channel of the
// scratch's first plane (0, or N_FLOW under flow_off); `fix`: the int64
// [N_CHAN - ch0, hp, wp] scratch.
extern "C" int tt_splat_plan(const int* keys, int n, int bits, int hp, int wp,
                             int chunk, int ch0, int* info, int* queue,
                             int queue_cap, long long* fix, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(queue, 0, QUEUE_HEAD * sizeof(int), s);
  const int tiles = (hp / TILE_H) * (wp / TILE_W);
  splat_plan_kernel<<<tiles, PLAN_THREADS, 0, s>>>(
      keys, n, bits, wp / TILE_W, hp, wp, chunk, ch0, info, queue,
      queue_cap, fix);
  return (int)cudaGetLastError();
}

// Pass 2, after pass 1 on the same stream.
extern "C" int tt_splat_tiles(const float* scal, const int* keys,
                              const int* p1, const int* vl, const int* p0,
                              const int* rgba, int n, int samples, int h,
                              int w, int hp, int wp, int bits, float pscale,
                              int ch0, int adds_rows, const int* info,
                              const int* queue, int queue_cap, long long* fix,
                              void* stream) {
  const Params P = make_params(scal, keys, p1, vl, p0, rgba, n, samples, h,
                               w, hp, wp, bits, pscale, ch0, adds_rows);
  const dim3 grid(queue_cap + (hp / TILE_H) * (wp / TILE_W),
                  channel_groups(ch0));
  const cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(splat_tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILE_SMEM);
  splat_tile_kernel<<<grid, TILE_THREADS, TILE_SMEM, s>>>(P, info, queue,
                                                          queue_cap, fix);
  return (int)cudaGetLastError();
}

// Pass 3, after pass 2 on the same stream; counts the strays into
// queue[1].
extern "C" int tt_splat_strays(const float* scal, const int* keys,
                               const int* p1, const int* vl, const int* p0,
                               const int* rgba, int n, int samples, int h,
                               int w, int hp, int wp, int bits, float pscale,
                               int ch0, int adds_rows, int* queue,
                               long long* fix, void* stream) {
  const long long items = (long long)n * samples;
  if (items > 0) {
    splat_stray_kernel<<<blocks_for(items), THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_params(scal, keys, p1, vl, p0, rgba, n, samples, h, w, hp, wp,
                    bits, pscale, ch0, adds_rows),
        queue + 1, fix);
  }
  return (int)cudaGetLastError();
}

// Pass 4, after pass 3 on the same stream (on a shard, after the ranks'
// scratches were summed): `accum`, f32 [N_CHAN - ch0, hp, wp], from the
// scratch at the steps of `adds_rows` (wp is a multiple of TILE_W, so a
// plane holds whole groups of 4 texels).
extern "C" int tt_splat_convert(const float* scal, int adds_rows,
                                int samples, int hp, int wp, int ch0,
                                const long long* fix, float* accum,
                                void* stream) {
  const int plane4 = hp * wp / 4;
  const long long groups = (long long)(N_CHAN - ch0) * plane4;
  splat_convert_kernel<<<(int)((groups + CONVERT_THREADS - 1) /
                               CONVERT_THREADS),
                         CONVERT_THREADS, 0, (cudaStream_t)stream>>>(
      scal, adds_rows, samples, plane4, ch0, fix, accum);
  return (int)cudaGetLastError();
}
