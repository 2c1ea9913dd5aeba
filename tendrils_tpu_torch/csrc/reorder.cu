// K10 compact — replaces tendrils_tpu/ops/reorder_pallas.py:_compact (body
// _compact_kernel).
// K11 merge apply — replaces the apply kernel of
// reorder_pallas.py:merge_reorder (_apply_kernel).
//
// The merge reorder restores the resident stream's tile-sorted row order
// from the previous frame's: the rows whose key did not change (U, key ==
// prev_key) are already in tile order, so only the churned rows (C) are
// compacted (K10), sorted (torch.sort over n / 8 slots) and merged back
// (K11). Ordering contract (reorder_pallas.py:24-30): sorted by tile (key
// >> idx_bits); within a tile the U rows first, in their previous relative
// order, then the C rows sorted by full key.
//
// K10, one block per 4096-row source block (1024 threads, 4 consecutive
// rows each): a block-wide exclusive scan of the churn mask puts each
// churned row's (key, prev_key, source row) at base_b + rank of a dense
// buffer of capacity n / 8 (base_b: the exclusive cumsum of the per-block
// churn counts, a torch op in the wrapper, as the JAX computes it in XLA),
// never past the capacity. The JAX's ragged-128 layout pads each block's
// run to a multiple of 128 and guards that layout with its own `ok_layout`;
// its slack is at most one 128-row chunk a block, and `k_rag_rows` budgets
// for exactly that on top of the n / 8 capacity (reorder_pallas.py:
// 556-557), so `ok_layout` holds whenever k_total <= n / 8. The dense
// layout therefore keeps `ok` identical on the capacity guard. Carrying the
// source row instead of the payloads lets the caller gather every stream by
// one permutation, as the flat sort does.
//
// K11, one block of 1024 threads per 4096 rows, in two roles:
//   U blocks (one per 4096-row source block): pass j = 0..3 of thread t
//     takes row b x 4096 + j x 1024 + t, so a warp's loads of key and prev
//     are one 128-byte line each. The U row at row r goes to
//     (#U before r) + (#C in tiles before its tile), csum_c_excl[tile];
//     "#U before r" is the block's U base (its first row minus the C rows
//     of earlier blocks, base_b), the U rows of the block's earlier passes,
//     and a block-wide exclusive scan over the pass's 1024 rows. A warp's U
//     rows of one tile then land on consecutive ranks;
//   C blocks (after them): the j-th sorted C row goes to
//     (#U in tiles up to its tile), csum_u_incl[tile], + j, j strided by
//     1024 across the block's threads.
// Each placement writes key_sorted[rank] and perm[rank] = source row and
// counts itself in its 4096-element destination block (i32[n / 4096]): a
// warp whose placements all fall in one block (found with redux.sync
// min/max) adds them with one atomic; a warp that straddles blocks groups
// its lanes by block first. `ok` = the capacity guard and every count ==
// 4096 (the JAX's `counts == DB`), so the counts must be exact for any
// ranks, colliding ones included. A rank outside [0, n) or a tile outside
// the histogram is not placed, so it shows as a count mismatch. The TPU's
// window guards (WIN, CWIN, TBLW misses) have no counterpart in a scatter:
// this `ok` may hold on a frame where the JAX's does not.
//
// Bound: bytes. K10 reads key and prev (8 B a row) and writes 12 B per
// churned row; K11 reads key and prev (8 B a row) and the sorted C rows
// (8 B each), writes key_sorted and perm (8 B a row). Neither does more
// than a few integer operations a row. The TPU kernels route rows with
// in-VMEM log-shift networks and windowed DMAs because Mosaic has no
// scatter; a direct scatter to the exact merge rank computes the same
// permutation.
#include <climits>

#include "common.cuh"

namespace {

using namespace tt;

constexpr int SB = 4096;        // rows of a source block and of a dest block
constexpr int RT = 1024;        // threads of a block
constexpr int PER = SB / RT;    // rows per thread
constexpr unsigned FULL = 0xffffffffu;

// P exclusive prefix sums at once, each of one value a thread over the
// block's RT threads in thread order: excl[j] gets the sum of v[j] over
// the threads before this one, total[j] the sum over the block. `sums`:
// P x RT / 32 ints of shared memory, written here (a second call in the
// same block needs arrays of its own). Two barriers for all P scans: the
// warps' sums of scan j are scanned by warp j.
template <int P>
__device__ __forceinline__ void block_excl_scans(const int (&v)[P],
                                                 int (&excl)[P],
                                                 int (&total)[P],
                                                 int (*sums)[RT / 32]) {
  static_assert(P <= RT / 32, "one warp a scan");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    x[j] = v[j];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x[j], o);
      if (lane >= o) x[j] += y;
    }
    if (lane == 31) sums[j][warp] = x[j];
  }
  __syncthreads();
  if (warp < P) {
    int s = sums[warp][lane];  // RT / 32 == 32 warps: one lane each
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sums[warp][lane] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < P; ++j) {
    total[j] = sums[j][RT / 32 - 1];
    excl[j] = x[j] - v[j] + (warp > 0 ? sums[j][warp - 1] : 0);
  }
}

__global__ void __launch_bounds__(RT)
    compact_kernel(const int* __restrict__ key, const int* __restrict__ prev,
                   const int* __restrict__ base_b, int cap,
                   int* __restrict__ ck, int* __restrict__ cprev,
                   int* __restrict__ csrc) {
  __shared__ int sums[1][RT / 32];
  const int r0 = blockIdx.x * SB + threadIdx.x * PER;
  int k[PER], p[PER];
  int c[1] = {0};
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    k[j] = key[r0 + j];
    p[j] = prev[r0 + j];
    c[0] += k[j] != p[j];
  }
  int excl[1], total[1];
  block_excl_scans(c, excl, total, sums);
  int pos = base_b[blockIdx.x] + excl[0];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (k[j] != p[j]) {
      if (pos < cap) {
        ck[pos] = k[j];
        cprev[pos] = p[j];
        csrc[pos] = r0 + j;
      }
      ++pos;
    }
  }
}

// Write each lane's row (`p`: it has one) at its merge rank and count the
// warp's placements in their destination blocks. Called by all 32 lanes.
// When every placing lane's rank lies in one block (the rule: a warp's
// ranks are near-consecutive), one lane adds them all; otherwise the lanes
// are grouped by block (`__match_any_sync`) and each group adds its size.
__device__ __forceinline__ void place(bool p, int rank, int n, int k,
                                      int src, int* __restrict__ key_out,
                                      int* __restrict__ perm_out,
                                      int* __restrict__ counts) {
  p = p && rank >= 0 && rank < n;
  const int blk = p ? rank / SB : 0;
  if (p) {
    key_out[rank] = k;
    perm_out[rank] = src;
  }
  const unsigned placed = __ballot_sync(FULL, p);
  if (placed == 0) return;
  const int lo = __reduce_min_sync(FULL, p ? blk : INT_MAX);
  const int hi = __reduce_max_sync(FULL, p ? blk : -1);
  const int lane = threadIdx.x & 31;
  if (lo == hi) {
    if (lane == __ffs(placed) - 1) atomicAdd(&counts[lo], __popc(placed));
    return;
  }
  if (p) {
    const unsigned peers = __match_any_sync(placed, blk);
    if (lane == __ffs(peers) - 1) atomicAdd(&counts[blk], __popc(peers));
  }
}

__global__ void __launch_bounds__(RT)
    apply_kernel(const int* __restrict__ key, const int* __restrict__ prev,
                 const int* __restrict__ base_b, int nb, int n,
                 const int* __restrict__ ck_s, const int* __restrict__ src_s,
                 const int* __restrict__ k_total, int cap,
                 const int* __restrict__ csum_u_incl,
                 const int* __restrict__ csum_c_excl, int n_tiles,
                 int idx_bits, int* __restrict__ key_out,
                 int* __restrict__ perm_out, int* __restrict__ counts) {
  if ((int)blockIdx.x < nb) {
    // U role: source block b; pass j covers its rows j x RT + thread.
    __shared__ int sums[PER][RT / 32];
    const int b = blockIdx.x;
    const int r0 = b * SB + threadIdx.x;
    int k[PER], is_u[PER], c_before[PER];
    bool in[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      k[j] = key[r0 + j * RT];
      is_u[j] = k[j] == prev[r0 + j * RT];
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const unsigned t = (unsigned)k[j] >> idx_bits;
      in[j] = is_u[j] && t < (unsigned)n_tiles;
      c_before[j] = in[j] ? csum_c_excl[t] : 0;
    }
    int excl[PER], total[PER];
    block_excl_scans(is_u, excl, total, sums);
    int u_before = b * SB - base_b[b];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      place(in[j], u_before + excl[j] + c_before[j], n, k[j], r0 + j * RT,
            key_out, perm_out, counts);
      u_before += total[j];
    }
    return;
  }
  // C role: sorted C rows (blockIdx.x - nb) * SB ..., strided by RT.
  const int kt = min(*k_total, cap);
  const int j0 = (blockIdx.x - nb) * SB + threadIdx.x;
  int kc[PER], rank[PER], src[PER];
  bool in[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * RT;
    kc[i] = j < kt ? ck_s[j] : 0;
    src[i] = j < kt ? src_s[j] : 0;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * RT;
    const unsigned t = (unsigned)kc[i] >> idx_bits;
    in[i] = j < kt && t < (unsigned)n_tiles;
    rank[i] = in[i] ? csum_u_incl[t] + j : 0;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    place(in[i], rank[i], n, kc[i], src[i], key_out, perm_out, counts);
  }
}

}  // namespace

// n: rows, a multiple of 4096; cap: the C capacity (n / 8).
extern "C" int tt_reorder_compact(const int* key, const int* prev,
                                  const int* base_b, int n, int cap, int* ck,
                                  int* cprev, int* csrc, void* stream) {
  if (n > 0) {
    compact_kernel<<<n / SB, RT, 0, (cudaStream_t)stream>>>(
        key, prev, base_b, cap, ck, cprev, csrc);
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_reorder_apply(const int* key, const int* prev,
                                const int* base_b, int n, const int* ck_s,
                                const int* src_s, const int* k_total, int cap,
                                const int* csum_u_incl,
                                const int* csum_c_excl, int n_tiles,
                                int idx_bits, int* key_out, int* perm_out,
                                int* counts, void* stream) {
  if (n > 0) {
    const int nb = n / SB;
    apply_kernel<<<nb + (cap + SB - 1) / SB, RT, 0, (cudaStream_t)stream>>>(
        key, prev, base_b, nb, n, ck_s, src_s, k_total, cap, csum_u_incl,
        csum_c_excl, n_tiles, idx_bits, key_out, perm_out, counts);
  }
  return (int)cudaGetLastError();
}
