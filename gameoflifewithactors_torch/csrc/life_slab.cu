// Temporal-blocked bit-packed B/S stencil on halo-extended row bands, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_kernel in slab mode (with and without dead_band), as built by
// _build_slab_runner and driven by make_pallas_slab_step: `gens`
// generations of a binary 3x3 B/S rule on a batch of (He, W/32) packed
// bands, He = band rows + 2*gens, where the caller has put `gens` rows of
// halo above and below each band and keeps rows [gens, He - gens) of the
// result. For each band:
// - rows outside [0, He) are zero when the slab is loaded and then evolve
//   freely (no re-zero: _zero_edge_rows once, at k == 0);
// - with edge code bit 0 (bit 1), rows with extended index < gens
//   (>= He - gens) are zeroed before every generation: the permanently
//   dead exterior of a band at the grid's top (bottom) edge under a DEAD
//   vertical closure (_zero_band_exterior). Edge code 0 lets every row
//   evolve freely. The code is one for the whole batch (the serving
//   lanes: every band is a whole grid) or one per band, read from a
//   device array by blockIdx.z (the bands of a mesh on one device: 1 for
//   the top band, 2 for the bottom one, 0 between);
// - horizontally, TORUS wraps words modulo W/32 and DEAD zeroes the words
//   outside the grid before every generation.
// The whole (He, W/32) result is defined this way, halo rows included, and
// does not depend on the tile size.
//
// What bounds it on this card: integer (LOP3 / funnel-shift) issue rate,
// as for life_packed.cu: about 20 bitwise operations per word and
// generation against one read and one write of the band per launch.
//
// What the design does about it:
// - B1's geometry (life_packed.cu): blocks own th x tw-word tiles of one
//   band, load (th + 2*gens) x (tw + 2) words into shared memory once, run
//   `gens` generations there (ping-pong buffers, one barrier each) and
//   write the tile once. One halo word per side holds while gens <= 32.
// - One launch covers the whole batch, blockIdx.z being the band: Pallas
//   issued one kernel call per universe (a manual-DMA pallas_call cannot
//   be vmapped), a CUDA grid has no such limit.
// - Slab row r of a block always holds extended row y0 - gens + r (the
//   slab shrinks by one row per side per generation, it is not shifted),
//   so the dead band is a comparison of that global index with two limits
//   fixed at launch, and B1's per-word arithmetic (life_rule.cuh) runs
//   unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "life_rule.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerItem = 8;
constexpr int kFar = 1 << 30;   // a row limit no band reaches

using life::next_word;
using life::row_sums;
using life::RuleMasks;
using life::rule_masks;

__global__ void __launch_bounds__(kThreads)
life_slab_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int He, int Wp, int gens, int th, int tw, unsigned born,
                 unsigned survive, int dead_cols, int edge_code,
                 const int* __restrict__ edge_codes) {
  extern __shared__ uint32_t smem[];
  if (edge_codes != nullptr) edge_code = edge_codes[blockIdx.z];
  const size_t band = (size_t)blockIdx.z * He * Wp;
  in += band;
  out += band;
  const int L = th + 2 * gens;
  const int ww = tw + 2;        // words computed per row: tile + one halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int plane = L * stride;
  const int row0 = blockIdx.y * th - gens;  // extended row of slab row 0
  const int col0 = blockIdx.x * tw - 1;     // grid word of slab word 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the dead band: extended rows < top or >= bottom are zero before every
  // generation
  const int top = (edge_code & 1) ? gens : -kFar;
  const int bottom = (edge_code & 2) ? He - gens : kFar;

  // Load: one warp per row. Rows outside [0, He) and dead-band rows read
  // as zeros.
  for (int r = warp; r < L; r += kWarps) {
    const int gr = row0 + r;
    const bool row_in = gr >= 0 && gr < He && gr >= top && gr < bottom;
    const uint32_t* src = in + (size_t)(row_in ? gr : 0) * Wp;
    uint32_t* row = smem + r * stride;
    for (int x = lane; x < stride; x += 32) {
      uint32_t v = 0u;
      if (row_in && x > 0 && x <= ww) {
        int gc = col0 + x - 1;
        if (dead_cols) {
          if (gc >= 0 && gc < Wp) v = src[gc];
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
    // the dead band is zeroed before every generation, so after every one
    // but the last
    const bool rezero_rows = k + 1 < gens;
    const int chunks = (hi - lo + kRowsPerItem - 1) / kRowsPerItem;
    for (int item = threadIdx.x; item < chunks * ww; item += kThreads) {
      const int chunk = item / ww;
      const int x = item - chunk * ww + 1;   // column in the padded row
      const int rs = lo + chunk * kRowsPerItem;
      const int re = min(rs + kRowsPerItem, hi);
      const int gc = col0 + x - 1;
      const bool col_out = dead_cols && (gc < 0 || gc >= Wp);
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
        if (col_out || (rezero_rows && (gr < top || gr >= bottom))) v = 0u;
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
    if (gr >= He) break;
    for (int x = lane; x < tw; x += 32) {
      const int gc = blockIdx.x * tw + x;
      if (gc < Wp) out[(size_t)gr * Wp + gc] = res[(r + gens) * stride + x + 2];
    }
  }
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (B, He, Wp) uint32 buffers) on `stream`. `edge_codes`, when not null, is
// a device array of B int32 edge codes, one per band, in place of
// `edge_code` for all of them. Returns the CUDA error code of the launch
// (0 on success).
int life_slab_launch(const void* in, void* out, int B, int He, int Wp,
                     int gens, int th, int tw, unsigned born, unsigned survive,
                     int dead_cols, int edge_code, const void* edge_codes,
                     void* stream) {
  const size_t smem = 2ull * (th + 2 * gens) * (tw + 4) * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        life_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Wp + tw - 1) / tw, (He + th - 1) / th, B);
  life_slab_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, He, Wp, gens, th, tw, born, survive,
      dead_cols, edge_code, (const int*)edge_codes);
  return (int)cudaGetLastError();
}

const char* life_slab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
