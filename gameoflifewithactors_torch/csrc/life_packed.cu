// Temporal-blocked bit-packed life-like (B/S) stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_kernel in full-grid mode, as built by _build_runner and driven by
// multi_step_pallas: `gens` generations of a binary 3x3 B/S rule per launch
// on the (H, W/32) packed grid (bit i of word j in row r is cell
// (r, 32*j + i)), TORUS or DEAD.
//
// What bounds it on this card: integer (LOP3 / funnel-shift) issue rate.
// One generation of the SWAR network costs about 20 bitwise operations per
// 32-cell word, and with `gens` = 8 the launch reads and writes the grid
// once, so the 8 generations' operations take about four times as long at
// the INT32 rate (64 lanes per SM per clock) as the grid's bytes take at
// the HBM rate.
//
// What the design does about it:
// - Temporal blocking, as on the TPU: each block loads its tile plus a
//   halo once, advances `gens` generations in shared memory (ping-pong
//   buffers, one barrier per generation) and writes the tile once, so
//   device memory is touched once per launch, not once per generation.
// - A Pallas block holds whole rows (about 1 MB at 16384^2), far beyond an
//   SM's shared memory, so both axes are tiled: a block owns th x tw words
//   and loads (th + 2*gens) x (tw + 2) of them. One halo word per side is
//   enough while gens <= 32, since each generation consumes one bit column
//   per side; rows shrink by one per side per generation.
// - TORUS reads source rows and words modulo H and W/32 (the unrolled
//   torus), exact for any grid and tile size. DEAD loads zeros outside the
//   grid and writes zeros there after every generation, the counterpart of
//   the per-generation _zero_edge_rows re-zero.
// - Per word and generation: the row sums and the bit-sliced rule table of
//   life_rule.cuh (about 20 LOP3s and funnel shifts per word). Each thread
//   walks a short column of rows so every row's T is computed once and
//   reused for the rows above and below.
// - Shared-memory rows carry a zero word at each end, so the edge words of
//   the slab need no bounds test, and the buffers are addressed by
//   arithmetic on the one shared array, so every access is a shared load
//   or store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "life_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerItem = 8;

using life::next_word;
using life::row_sums;
using life::RuleMasks;
using life::rule_masks;

__global__ void __launch_bounds__(kThreads)
life_packed_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int H, int Wp, int gens, int th, int tw, unsigned born,
                   unsigned survive, int dead) {
  extern __shared__ uint32_t smem[];
  const int L = th + 2 * gens;
  const int ww = tw + 2;        // words computed per row: tile + one halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int plane = L * stride;
  const int row0 = blockIdx.y * th - gens;  // grid row of slab row 0
  const int col0 = blockIdx.x * tw - 1;     // grid word of slab word 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Load: one warp per row, so a row's source index is reduced once.
  for (int r = warp; r < L; r += kWarps) {
    int gr = row0 + r;
    const bool row_in = gr >= 0 && gr < H;
    if (dead && !row_in) {
      gr = 0;  // the row reads as zeros; keep the pointer in range
    } else if (!row_in) {
      gr %= H;
      if (gr < 0) gr += H;
    }
    const uint32_t* src = in + (size_t)gr * Wp;
    uint32_t* row = smem + r * stride;
    for (int x = lane; x < stride; x += 32) {
      uint32_t v = 0u;
      if (x > 0 && x <= ww) {
        int gc = col0 + x - 1;
        if (dead) {
          if (row_in && gc >= 0 && gc < Wp) v = src[gc];
        } else {
          if (gc < 0 || gc >= Wp) {
            gc %= Wp;
            if (gc < 0) gc += Wp;
          }
          v = src[gc];
        }
      }
      row[x] = v;
      if (x == 0 || x > ww) row[plane + x] = 0u;  // the other buffer's pads
    }
  }
  const RuleMasks masks = rule_masks(born, survive);
  __syncthreads();

  for (int k = 0; k < gens; ++k) {
    const uint32_t* src = smem + (k & 1) * plane;
    uint32_t* dst = smem + ((k + 1) & 1) * plane;
    const int lo = k + 1;      // output rows [lo, hi) of this generation
    const int hi = L - k - 1;
    const int chunks = (hi - lo + kRowsPerItem - 1) / kRowsPerItem;
    for (int item = threadIdx.x; item < chunks * ww; item += kThreads) {
      const int chunk = item / ww;
      const int x = item - chunk * ww + 1;   // column in the padded row
      const int rs = lo + chunk * kRowsPerItem;
      const int re = min(rs + kRowsPerItem, hi);
      const int gc = col0 + x - 1;
      const bool col_out = dead && (gc < 0 || gc >= Wp);
      const uint32_t* p = src + (rs - 1) * stride + x;
      uint32_t c_up, tn0, tn1, unused0, unused1;
      row_sums(p, c_up, tn0, tn1, unused0, unused1);
      uint32_t alive, tc0, tc1, s0, s1;
      row_sums(p + stride, alive, tc0, tc1, s0, s1);
      for (int r = rs; r < re; ++r) {
        p += stride;
        uint32_t c_dn, ts0, ts1, sd0, sd1;
        row_sums(p + stride, c_dn, ts0, ts1, sd0, sd1);
        const int gr = row0 + r;
        uint32_t v = next_word(alive, tn0, tn1, s0, s1, ts0, ts1, masks);
        if (col_out || (dead && (gr < 0 || gr >= H))) v = 0u;
        dst[r * stride + x] = v;
        tn0 = tc0; tn1 = tc1;
        tc0 = ts0; tc1 = ts1;
        s0 = sd0; s1 = sd1;
        alive = c_dn;
      }
    }
    __syncthreads();
  }

  // Store the tile: rows gens..gens+th-1, words 2..tw+1 of the padded rows.
  const uint32_t* res = smem + (gens & 1) * plane;
  for (int r = warp; r < th; r += kWarps) {
    const int gr = blockIdx.y * th + r;
    if (gr >= H) break;
    for (int x = lane; x < tw; x += 32) {
      const int gc = blockIdx.x * tw + x;
      if (gc < Wp) out[(size_t)gr * Wp + gc] = res[(r + gens) * stride + x + 2];
    }
  }
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (H, Wp) uint32 buffers) on `stream`. Returns the CUDA error code of the
// launch (0 on success).
int life_packed_launch(const void* in, void* out, int H, int Wp, int gens,
                       int th, int tw, unsigned born, unsigned survive,
                       int dead, void* stream) {
  const size_t smem = 2ull * (th + 2 * gens) * (tw + 4) * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        life_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Wp + tw - 1) / tw, (H + th - 1) / th);
  life_packed_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, H, Wp, gens, th, tw, born, survive,
      dead);
  return (int)cudaGetLastError();
}

const char* life_packed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
