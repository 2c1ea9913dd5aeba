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
// K11, one thread per row in two roles:
//   U blocks (one per 4096-row source block): the U row at row r goes to
//     (#U before r) + (#C in tiles before its tile), csum_c_excl[tile];
//     "#U before r" is the block's U base (its first row minus the C rows
//     of earlier blocks, base_b) plus a block-wide exclusive scan;
//   C blocks (after them): the j-th sorted C row goes to
//     (#U in tiles up to its tile), csum_u_incl[tile], + j.
// Each placement writes key_sorted[rank] and perm[rank] = source row and
// counts itself in its 4096-element destination block (warp-aggregated
// atomics on i32[n / 4096]); `ok` = the capacity guard and every count ==
// 4096 (the JAX's `counts == DB`). A rank outside [0, n) or a tile outside
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
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tt;

constexpr int SB = 4096;        // rows of a source block and of a dest block
constexpr int RT = 1024;        // threads of a block
constexpr int PER = SB / RT;    // consecutive rows per thread

// Exclusive prefix sum of `v` over the block's RT threads, in thread order.
// Called once per block (its shared array is not reused).
__device__ __forceinline__ int block_excl_scan(int v) {
  __shared__ int warp_sums[RT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];  // RT / 32 == 32 warps: one lane each
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  return x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(RT)
    compact_kernel(const int* __restrict__ key, const int* __restrict__ prev,
                   const int* __restrict__ base_b, int cap,
                   int* __restrict__ ck, int* __restrict__ cprev,
                   int* __restrict__ csrc) {
  const int r0 = blockIdx.x * SB + threadIdx.x * PER;
  int k[PER], p[PER];
  int c = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    k[j] = key[r0 + j];
    p[j] = prev[r0 + j];
    c += k[j] != p[j];
  }
  int pos = base_b[blockIdx.x] + block_excl_scan(c);
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

// Write one row at its merge rank and count it in its destination block.
__device__ __forceinline__ void place(int rank, int n, int k, int src,
                                      int* __restrict__ key_out,
                                      int* __restrict__ perm_out,
                                      int* __restrict__ counts) {
  if (rank < 0 || rank >= n) return;
  key_out[rank] = k;
  perm_out[rank] = src;
  const int blk = rank / SB;
  cg::coalesced_group active = cg::coalesced_threads();
  cg::coalesced_group peers = cg::labeled_partition(active, blk);
  if (peers.thread_rank() == 0) atomicAdd(&counts[blk], (int)peers.size());
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
    // U role: source block blockIdx.x.
    const int b = blockIdx.x;
    const int r0 = b * SB + threadIdx.x * PER;
    int k[PER];
    bool is_u[PER];
    int u = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      k[j] = key[r0 + j];
      is_u[j] = k[j] == prev[r0 + j];
      u += is_u[j];
    }
    int u_before = b * SB - base_b[b] + block_excl_scan(u);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (is_u[j]) {
        const unsigned t = (unsigned)k[j] >> idx_bits;
        if (t < (unsigned)n_tiles) {
          place(u_before + csum_c_excl[t], n, k[j], r0 + j, key_out,
                perm_out, counts);
        }
        ++u_before;
      }
    }
    return;
  }
  // C role: sorted C rows (blockIdx.x - nb) * SB ..., strided by RT.
  const int kt = min(*k_total, cap);
  const int j0 = (blockIdx.x - nb) * SB + threadIdx.x;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * RT;
    if (j < kt) {
      const int kc = ck_s[j];
      const unsigned t = (unsigned)kc >> idx_bits;
      if (t < (unsigned)n_tiles) {
        place(csum_u_incl[t] + j, n, kc, src_s[j], key_out, perm_out,
              counts);
      }
    }
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
