// Temporal-blocked bit-packed Larger-than-Life stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_ltl_kernel in both of its modes, as built by _ltl_pallas_call:
// `gens` generations per launch of a binary radius-r (1..7)
// Larger-than-Life rule — Moore box or von Neumann diamond, HROT interval
// lists, M0 or M1 — on packed words (bit i of word j in row r is cell
// (r, 32*j + i)):
// - full grid (_build_ltl_runner, driven by multi_step_ltl_pallas): the
//   (H, W/32) grid, TORUS or DEAD;
// - slab mode with dead_band (make_ltl_pallas_slab_step, driven by the
//   sharded band runner): a batch of halo-extended full-width (He, W/32)
//   bands, He = band rows + 2*r*gens, the caller keeping rows
//   [r*gens, He - r*gens). Rows outside [0, He) load as zero and then
//   evolve freely; with edge code bit 0 (bit 1) the extended rows < r*gens
//   (>= He - r*gens) are zeroed before every generation (the dead exterior
//   of the grid's top (bottom) band: _zero_band_exterior with a halo of
//   r*gens rows, shrinking r rows per generation); the code is one for the
//   batch or one per band, read by blockIdx.z; TORUS wraps words and DEAD
//   zeroes the words outside the grid before every generation.
// Each generation computes what ops/packed_ltl.py::step_ltl_packed_slab
// computes.
//
// What bounds it on this card: integer (LOP3 / funnel-shift) issue rate.
// A radius-5 box generation costs well over a hundred bitwise operations
// per 32-cell word against 8 bytes of device traffic per word and launch,
// so the operations outweigh the bytes many times over at any depth.
//
// What the design does about it:
// - Temporal blocking, as on the TPU: a block loads its th x tw-word tile
//   plus r*gens halo rows and hw = ceil(r*gens/32) halo words per side
//   into shared memory, advances `gens` generations there (ping-pong
//   buffers, one barrier per generation) and writes the tile once. The
//   slab loses r rows per side per generation, and its edge words turn to
//   garbage r cells per generation, which the hw halo words absorb. The
//   halo work grows with r*gens, so the wrapper's default depth and tile
//   come from a sweep on the card, not from the TPU's.
// - Counting: of the two candidate designs (a per-cell popcount of a
//   funnel-shifted window, or bit-sliced counts), this kernel keeps the
//   counts bit-sliced, 32 cells per operation, because a popcount per cell
//   costs about 32 times the operations (and POPC issues at a quarter of
//   the LOP3 rate). Per row, the horizontal window sum of width 2a+1 of
//   one word is built from 2a funnel shifts of the word and its two
//   neighbours, added two bits at a time into a 4-plane counter (a <= 7,
//   so counts <= 15). The box is separable: a thread walks down a column
//   of rows and slides its 8-plane count, adding the entering row's
//   horizontal sum and subtracting the leaving row's, so each output word
//   costs two row sums and two ripple adds. The diamond is not separable:
//   each output word sums its 2r+1 rows with widths 2(r-|dy|)+1 directly.
// - The rule is data, not code, so one build serves every rule: the born
//   and survive interval lists arrive as sorted boundaries (lo, hi+1,
//   ...), and a count lies in the set iff an odd number of boundaries are
//   <= it, an XOR of bit-sliced comparators. With the boundary's bits
//   given at run time, each bit of a comparator is one LOP3 (an empty
//   list means "never"). M0 subtracts the centre bit first.
// - TORUS reads rows and words modulo H and W/32, exact for any grid and
//   tile, including grids narrower than the halo. DEAD loads zeros outside
//   the grid and writes zeros there after every generation, the
//   counterpart of the per-generation _zero_edge_rows re-zero.
// - Shared-memory rows carry a zero word at each end, so the funnel shifts
//   at the slab's edge words need no bounds test.
// - The slab mode is a template flag: both modes share the counting and
//   the rule; the flag picks the load rule, the dead-row test and the
//   band offset (blockIdx.z). Slab row y always holds extended row
//   y0 - r*gens + y, so the dead band is two comparisons with limits fixed
//   per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerItem = 16;
constexpr int kMaxBounds = 32;   // interval boundaries per set (16 intervals)
constexpr int kCountPlanes = 8;  // counts <= 225 < 256
constexpr int kFar = 1 << 30;    // a row limit no band reaches

struct LtlRule {
  int radius;
  int diamond;
  int middle;
  int nborn;
  int nsurv;
  int born[kMaxBounds];  // sorted boundaries lo0, hi0+1, lo1, hi1+1, ...
  int surv[kMaxBounds];
};

// (sel & hi) | (~sel & lo): one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t hi, uint32_t lo) {
  return (sel & hi) | (~sel & lo);
}

// Window sum of width 2a+1 centred on each cell of word c (l and r its
// west and east neighbours), as a 4-plane bit-sliced number.
__device__ __forceinline__ void row_window(uint32_t l, uint32_t c, uint32_t r,
                                           int a, uint32_t (&h)[4]) {
  h[0] = c;
  h[1] = 0u;
  h[2] = 0u;
  h[3] = 0u;
  for (int d = 1; d <= a; ++d) {
    const uint32_t w = __funnelshift_l(l, c, d);  // the cell d to the west
    const uint32_t e = __funnelshift_r(c, r, d);  // the cell d to the east
    const uint32_t k1 = (h[0] & w) | (h[0] & e) | (w & e);
    h[0] ^= w ^ e;
    const uint32_t k2 = h[1] & k1;
    h[1] ^= k1;
    const uint32_t k3 = h[2] & k2;
    h[2] ^= k2;
    h[3] ^= k3;
  }
}

__device__ __forceinline__ void add4(uint32_t (&acc)[kCountPlanes],
                                     const uint32_t (&h)[4]) {
  uint32_t carry = 0u;
#pragma unroll
  for (int i = 0; i < kCountPlanes; ++i) {
    const uint32_t x = i < 4 ? h[i] : 0u;
    const uint32_t s = acc[i] ^ x ^ carry;
    carry = (acc[i] & x) | (acc[i] & carry) | (x & carry);
    acc[i] = s;
  }
}

__device__ __forceinline__ void sub4(uint32_t (&acc)[kCountPlanes],
                                     const uint32_t (&h)[4]) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kCountPlanes; ++i) {
    const uint32_t x = i < 4 ? h[i] : 0u;
    const uint32_t d = acc[i] ^ x ^ borrow;
    borrow = (~acc[i] & (x | borrow)) | (x & borrow);
    acc[i] = d;
  }
}

// All-ones where the bit-sliced count is >= c (0 <= c < 256).
__device__ __forceinline__ uint32_t count_ge(const uint32_t (&cnt)[kCountPlanes],
                                             int c) {
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < kCountPlanes; ++i) {
    borrow = ((c >> i) & 1) ? (~cnt[i] | borrow) : (~cnt[i] & borrow);
  }
  return ~borrow;
}

// All-ones where the count lies in the interval set given by its sorted
// boundaries: an odd number of boundaries <= count. The loop is unrolled
// so each boundary is read from the kernel's parameters at a fixed offset.
__device__ __forceinline__ uint32_t in_set(const uint32_t (&cnt)[kCountPlanes],
                                           const int (&bounds)[kMaxBounds],
                                           int n) {
  uint32_t v = 0u;
#pragma unroll
  for (int i = 0; i < kMaxBounds; ++i) {
    if (i < n) v ^= count_ge(cnt, bounds[i]);
  }
  return v;
}

// Slab = false: the full grid (H rows, `dead` closes both axes). Slab =
// true: blockIdx.z is a band of H = He extended rows, `dead` closes the
// columns only, and `edge_code` (or edge_codes[blockIdx.z]) sets the dead
// band.
template <bool Slab>
__global__ void __launch_bounds__(kThreads)
life_ltl_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int H, int Wp, int gens, int th, int tw, int hw, int dead,
                int edge_code, const int* __restrict__ edge_codes,
                const LtlRule rule) {
  extern __shared__ uint32_t smem[];
  const int rad = rule.radius;
  const int hr = rad * gens;
  const int L = th + 2 * hr;
  const int ww = tw + 2 * hw;   // words computed per row: tile + hw halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int plane = L * stride;
  const int row0 = blockIdx.y * th - hr;  // grid row of slab row 0
  const int col0 = blockIdx.x * tw - hw;  // grid word of slab word 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the dead band of a slab: extended rows < top or >= bottom are zero
  // before every generation
  int top = -kFar, bottom = kFar;
  if constexpr (Slab) {
    in += (size_t)blockIdx.z * H * Wp;
    out += (size_t)blockIdx.z * H * Wp;
    if (edge_codes != nullptr) edge_code = edge_codes[blockIdx.z];
    if (edge_code & 1) top = hr;
    if (edge_code & 2) bottom = H - hr;
  }

  // Load: one warp per row, so a row's source index is reduced once. A
  // slab's rows outside [0, H) and in its dead band read as zeros; the
  // full grid's wrap under TORUS.
  for (int r = warp; r < L; r += kWarps) {
    int gr = row0 + r;
    bool row_in = gr >= 0 && gr < H;
    if constexpr (Slab) row_in = row_in && gr >= top && gr < bottom;
    if (!row_in) {
      if (Slab || dead) {
        gr = 0;  // the row reads as zeros; keep the pointer in range
      } else {
        gr %= H;
        if (gr < 0) gr += H;
        row_in = true;
      }
    }
    const uint32_t* src = in + (size_t)gr * Wp;
    uint32_t* row = smem + r * stride;
    for (int x = lane; x < stride; x += 32) {
      uint32_t v = 0u;
      if (row_in && x > 0 && x <= ww) {
        int gc = col0 + x - 1;
        if (dead) {
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
  __syncthreads();

  for (int k = 0; k < gens; ++k) {
    const uint32_t* src = smem + (k & 1) * plane;
    uint32_t* dst = smem + ((k + 1) & 1) * plane;
    const int lo = rad * (k + 1);   // output rows [lo, hi) of this generation
    const int hi = L - rad * (k + 1);
    // a slab's dead band is zeroed before every generation, so after
    // every one but the last
    const bool rezero_rows = k + 1 < gens;
    const int chunks = (hi - lo + kRowsPerItem - 1) / kRowsPerItem;
    for (int item = threadIdx.x; item < chunks * ww; item += kThreads) {
      const int chunk = item / ww;
      const int x = item - chunk * ww + 1;   // column in the padded row
      const int rs = lo + chunk * kRowsPerItem;
      const int re = min(rs + kRowsPerItem, hi);
      const int gc = col0 + x - 1;
      const bool col_out = dead && (gc < 0 || gc >= Wp);
      const uint32_t* col = src + x;
      uint32_t acc[kCountPlanes];
      uint32_t h[4];
      if (!rule.diamond) {
#pragma unroll
        for (int i = 0; i < kCountPlanes; ++i) acc[i] = 0u;
        for (int y = rs - rad; y <= rs + rad; ++y) {
          const uint32_t* p = col + y * stride;
          row_window(p[-1], p[0], p[1], rad, h);
          add4(acc, h);
        }
      }
      for (int y = rs; y < re; ++y) {
        if (rule.diamond) {
#pragma unroll
          for (int i = 0; i < kCountPlanes; ++i) acc[i] = 0u;
          for (int dy = -rad; dy <= rad; ++dy) {
            const uint32_t* p = col + (y + dy) * stride;
            row_window(p[-1], p[0], p[1], rad - abs(dy), h);
            add4(acc, h);
          }
        }
        const uint32_t alive = col[y * stride];
        uint32_t cnt[kCountPlanes];
#pragma unroll
        for (int i = 0; i < kCountPlanes; ++i) cnt[i] = acc[i];
        if (!rule.middle) {  // M0: the centre does not count itself
          uint32_t borrow = alive;
#pragma unroll
          for (int i = 0; i < kCountPlanes; ++i) {
            const uint32_t c = cnt[i];
            cnt[i] = c ^ borrow;
            borrow = ~c & borrow;
          }
        }
        const uint32_t born = in_set(cnt, rule.born, rule.nborn);
        const uint32_t keep = in_set(cnt, rule.surv, rule.nsurv);
        const int gr = row0 + y;
        const bool zero =
            col_out || (Slab ? rezero_rows && (gr < top || gr >= bottom)
                             : dead && (gr < 0 || gr >= H));
        dst[y * stride + x] = zero ? 0u : mux(alive, keep, born);
        if (!rule.diamond && y + 1 < re) {
          // slide the box: add the row entering below, drop the one above
          const uint32_t* p = col + (y + 1 + rad) * stride;
          row_window(p[-1], p[0], p[1], rad, h);
          add4(acc, h);
          p = col + (y - rad) * stride;
          row_window(p[-1], p[0], p[1], rad, h);
          sub4(acc, h);
        }
      }
    }
    __syncthreads();
  }

  // Store the tile: rows hr..hr+th-1, words hw+1..hw+tw of the padded rows.
  const uint32_t* res = smem + (gens & 1) * plane;
  for (int r = warp; r < th; r += kWarps) {
    const int gr = blockIdx.y * th + r;
    if (gr >= H) break;
    for (int x = lane; x < tw; x += 32) {
      const int gc = blockIdx.x * tw + x;
      if (gc < Wp) out[(size_t)gr * Wp + gc] = res[(r + hr) * stride + x + hw + 1];
    }
  }
}

template <bool Slab>
int launch(const void* in, void* out, int nbands, int H, int Wp, int gens,
           int th, int tw, int hw, int radius, int diamond, int middle,
           int nborn, const int* born, int nsurv, const int* surv, int dead,
           int edge_code, const void* edge_codes, void* stream) {
  if (radius < 1 || radius > 7 || nborn < 0 || nborn > kMaxBounds ||
      nsurv < 0 || nsurv > kMaxBounds || 32 * hw < radius * gens)
    return (int)cudaErrorInvalidValue;
  LtlRule rule;
  rule.radius = radius;
  rule.diamond = diamond;
  rule.middle = middle;
  rule.nborn = nborn;
  rule.nsurv = nsurv;
  for (int i = 0; i < kMaxBounds; ++i) {
    rule.born[i] = i < nborn ? born[i] : 0;
    rule.surv[i] = i < nsurv ? surv[i] : 0;
  }
  const size_t smem = 2ull * (th + 2 * radius * gens) * (tw + 2 * hw + 2) *
                      sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        life_ltl_kernel<Slab>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Wp + tw - 1) / tw, (H + th - 1) / th, nbands);
  life_ltl_kernel<Slab><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, H, Wp, gens, th, tw, hw, dead,
      edge_code, (const int*)edge_codes, rule);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (H, Wp) uint32 buffers) on `stream`, with `hw` halo words per side
// (32 * hw >= radius * gens). `born`/`surv` hold the sorted interval
// boundaries of the birth and survival sets. Returns the CUDA error code of
// the launch (0 on success), or cudaErrorInvalidValue for a rule the
// kernel does not take.
int life_ltl_launch(const void* in, void* out, int H, int Wp, int gens, int th,
                    int tw, int hw, int radius, int diamond, int middle,
                    int nborn, const int* born, int nsurv, const int* surv,
                    int dead, void* stream) {
  return launch<false>(in, out, 1, H, Wp, gens, th, tw, hw, radius, diamond,
                       middle, nborn, born, nsurv, surv, dead, 0, nullptr,
                       stream);
}

// Launches one slab-mode call of `gens` generations from `in` to `out`
// (distinct (nbands, He, Wp) uint32 batches) on `stream`; `dead_cols`
// closes the columns, `edge_codes` (a device array of nbands int32 codes,
// or null for `edge_code` on every band) the rows. Returns as
// life_ltl_launch does.
int life_ltl_slab_launch(const void* in, void* out, int nbands, int He, int Wp,
                         int gens, int th, int tw, int hw, int radius,
                         int diamond, int middle, int nborn, const int* born,
                         int nsurv, const int* surv, int dead_cols,
                         int edge_code, const void* edge_codes, void* stream) {
  return launch<true>(in, out, nbands, He, Wp, gens, th, tw, hw, radius,
                      diamond, middle, nborn, born, nsurv, surv, dead_cols,
                      edge_code, edge_codes, stream);
}

const char* life_ltl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
