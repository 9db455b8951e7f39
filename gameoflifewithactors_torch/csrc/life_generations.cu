// Temporal-blocked Generations (multi-state) stencil on the bit-plane stack,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel gameoflifewithactors_tpu/ops/pallas_stencil.py::
// _make_gen_kernel in both of its modes, as built by _gen_pallas_call:
// - full grid (_build_gen_runner, driven by multi_step_pallas_generations):
//   `gens` generations of a Generations rule B.../S.../C per launch on the
//   (b, H, W/32) stack, b = ceil(log2 C) = 2..8 planes, plane i holding
//   bit i of every cell's state (bit j of word x in row r is cell
//   (r, 32*x + j)), TORUS or DEAD;
// - slab mode with dead_band (make_pallas_gen_slab_step, driven by the
//   sharded band runner): `gens` generations of a batch of halo-extended
//   full-width bands, each a (b, He, W/32) stack with He = band rows +
//   2*gens, the caller keeping rows [gens, He - gens). As in life_slab.cu,
//   rows outside [0, He) load as zero in every plane and then evolve
//   freely; with edge code bit 0 (bit 1) the extended rows < gens
//   (>= He - gens) are zeroed in every plane before every generation (the
//   dead exterior of the grid's top (bottom) band, _zero_band_exterior with
//   row_axis=1); the code is one for the batch or one per band, read by
//   blockIdx.z; horizontally TORUS wraps words and DEAD zeroes the words
//   outside the grid before every generation.
// Each generation is what ops/packed_generations.py::step_planes_slab
// computes.
//
// What bounds it on this card: integer (LOP3 / funnel-shift) issue rate.
// A generation costs about 26 bitwise operations per 32-cell word for
// Brian's Brain (b = 2) and a few more per extra plane, while the launch
// reads and writes the b planes once, so at gens = 8 the operations take
// about twice as long at the INT32 rate (64 lanes per SM per clock) as the
// bytes take at the HBM rate.
//
// What the design does about it:
// - Temporal blocking, as on the TPU and as in life_packed.cu: a block
//   loads its th x tw-word tile of all b planes plus `gens` halo rows and
//   one halo word per side (enough while gens <= 32) into shared memory,
//   advances `gens` generations there (ping-pong buffers, one barrier per
//   generation) and writes the tile once.
// - Shared memory holds 2 * b planes of (th + 2*gens) x (tw + 4) words; the
//   wrapper shrinks the tile for large b so it fits in 227 KB.
// - The plane count is a template parameter (one instantiation per b), so
//   the planes of a word live in registers; one build serves every rule.
// - Per word and generation: the alive plane p0 & ~(p1 | ... | p_{b-1}) of
//   the rows above, at and below (recomputed from all planes every
//   generation), the 3x3 count T_north + S + T_south in four bit-planes as
//   in life_packed.cu, then born and keep as two separate bit-sliced table
//   lookups (births land only where the state is 0, not wherever the cell
//   is not alive: a dying cell must not be born), then the decay
//   transition: a +1 carry chain over the planes, zeroed where it reaches
//   C. The zeroing compares with C mod 2^b, which for C = 2^b is the
//   dropped carry's 0 and leaves the (already zero) result as it is, so
//   every C takes the same branch-free path.
// - TORUS reads rows and words modulo H and W/32, exact for any grid and
//   tile; DEAD loads zeros outside the grid and writes zeros there, in
//   every plane, after every generation.
// - The slab mode is the second value of a template flag beside the plane
//   count, so both modes share every line of the per-word arithmetic and
//   the flag only picks a load rule, the dead-row test and the band
//   offset. Slab row r of a
//   block always holds extended row y0 - gens + r, so the dead band is two
//   comparisons with limits fixed per block; one launch steps the whole
//   batch, blockIdx.z being the band.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerItem = 8;
constexpr int kFar = 1 << 30;   // a row limit no band reaches

// (sel & hi) | (~sel & lo): one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t hi, uint32_t lo) {
  return (sel & hi) | (~sel & lo);
}

// A 9-entry count table (bit n of `mask` = count n) as all-ones/all-zero
// words.
struct Table {
  uint32_t t[8];
  uint32_t t8;
};

__device__ __forceinline__ Table make_table(unsigned mask) {
  Table m;
#pragma unroll
  for (int c = 0; c < 8; ++c) m.t[c] = 0u - ((mask >> c) & 1u);
  m.t8 = 0u - ((mask >> 8) & 1u);
  return m;
}

// Bit-sliced table lookup: all-ones where the table holds the count given
// by the planes r0..r3 (r3 set only for count 8).
__device__ __forceinline__ uint32_t lookup(const Table& m, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  uint32_t l1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l1[i] = mux(r0, m.t[2 * i + 1], m.t[2 * i]);
  const uint32_t l2a = mux(r1, l1[1], l1[0]);
  const uint32_t l2b = mux(r1, l1[3], l1[2]);
  return mux(r3, m.t8, mux(r2, l2b, l2a));
}

// The alive plane (state == 1) of a word's B state planes.
template <int B>
__device__ __forceinline__ uint32_t alive_of(const uint32_t (&v)[B]) {
  uint32_t higher = 0u;
#pragma unroll
  for (int j = 1; j < B; ++j) higher |= v[j];
  return v[0] & ~higher;
}

// The alive plane of the word at `w` (plane j at w + j*plane).
template <int B>
__device__ __forceinline__ uint32_t alive_at(const uint32_t* w, int plane) {
  uint32_t v[B];
#pragma unroll
  for (int j = 0; j < B; ++j) v[j] = w[j * plane];
  return alive_of<B>(v);
}

// Horizontal sums of the alive words (l, c, r) of one row: T = w + c + e
// and S = w + e in two bits each.
__device__ __forceinline__ void row_sums(uint32_t l, uint32_t c, uint32_t r,
                                         uint32_t& t0, uint32_t& t1,
                                         uint32_t& s0, uint32_t& s1) {
  const uint32_t w = __funnelshift_l(l, c, 1);  // (c << 1) | (l >> 31)
  const uint32_t e = __funnelshift_r(c, r, 1);  // (c >> 1) | (r << 31)
  const uint32_t wc = w ^ c;
  t0 = wc ^ e;
  t1 = (w & c) | (e & wc);
  s0 = w ^ e;
  s1 = w & e;
}

// Slab = false: the full grid (H rows, `dead` closes both axes). Slab =
// true: blockIdx.z is a band of H = He extended rows, `dead` closes the
// columns only, and `edge_code` (or edge_codes[blockIdx.z]) sets the dead
// band.
template <int B, bool Slab>
__global__ void __launch_bounds__(kThreads)
life_generations_kernel(const uint32_t* __restrict__ in,
                        uint32_t* __restrict__ out, int H, int Wp, int gens,
                        int th, int tw, unsigned born, unsigned survive,
                        unsigned states, int dead, int edge_code,
                        const int* __restrict__ edge_codes) {
  extern __shared__ uint32_t smem[];
  const int L = th + 2 * gens;
  const int ww = tw + 2;        // words computed per row: tile + one halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int plane = L * stride;
  const int buffer = B * plane;
  const int row0 = blockIdx.y * th - gens;  // grid row of slab row 0
  const int col0 = blockIdx.x * tw - 1;     // grid word of slab word 0
  const size_t grid_plane = (size_t)H * Wp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the dead band of a slab: extended rows < top or >= bottom are zero
  // before every generation
  int top = -kFar, bottom = kFar;
  if constexpr (Slab) {
    in += (size_t)blockIdx.z * B * grid_plane;
    out += (size_t)blockIdx.z * B * grid_plane;
    if (edge_codes != nullptr) edge_code = edge_codes[blockIdx.z];
    if (edge_code & 1) top = gens;
    if (edge_code & 2) bottom = H - gens;
  }

  // Load all planes: one warp per (plane, row), so a row's source index is
  // reduced once. A slab's rows outside [0, H) and in its dead band read
  // as zeros; the full grid's wrap under TORUS.
  for (int pr = warp; pr < B * L; pr += kWarps) {
    const int j = pr / L;
    const int r = pr - j * L;
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
    const uint32_t* src = in + j * grid_plane + (size_t)gr * Wp;
    uint32_t* row = smem + j * plane + r * stride;
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
      if (x == 0 || x > ww) row[buffer + x] = 0u;  // the other buffer's pads
    }
  }
  const Table tborn = make_table(born);
  const Table tkeep = make_table(survive);
  // bits of C mod 2^B as all-ones/all-zero words
  uint32_t cbits[B];
#pragma unroll
  for (int j = 0; j < B; ++j) cbits[j] = 0u - ((states >> j) & 1u);
  __syncthreads();

  for (int k = 0; k < gens; ++k) {
    const uint32_t* src = smem + (k & 1) * buffer;
    uint32_t* dst = smem + ((k + 1) & 1) * buffer;
    const int lo = k + 1;      // output rows [lo, hi) of this generation
    const int hi = L - k - 1;
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
      const uint32_t* p = src + (rs - 1) * stride + x;
      uint32_t tn0, tn1, unused0, unused1;
      row_sums(alive_at<B>(p - 1, plane), alive_at<B>(p, plane),
               alive_at<B>(p + 1, plane), tn0, tn1, unused0, unused1);
      p += stride;
      uint32_t cur[B];
#pragma unroll
      for (int j = 0; j < B; ++j) cur[j] = p[j * plane];
      uint32_t alive = alive_of<B>(cur);
      uint32_t tc0, tc1, s0, s1;
      row_sums(alive_at<B>(p - 1, plane), alive, alive_at<B>(p + 1, plane),
               tc0, tc1, s0, s1);
      for (int r = rs; r < re; ++r) {
        const uint32_t* q = p + stride;   // the row below
        uint32_t nxt[B];
#pragma unroll
        for (int j = 0; j < B; ++j) nxt[j] = q[j * plane];
        const uint32_t alive_dn = alive_of<B>(nxt);
        uint32_t ts0, ts1, sd0, sd1;
        row_sums(alive_at<B>(q - 1, plane), alive_dn, alive_at<B>(q + 1, plane),
                 ts0, ts1, sd0, sd1);
        // count = T_n + S + T_s in four bit-planes r0..r3
        const uint32_t a = tn0 ^ s0;
        const uint32_t r0 = a ^ ts0;
        const uint32_t k1 = (tn0 & s0) | (ts0 & a);
        const uint32_t b = tn1 ^ s1;
        const uint32_t sum = b ^ ts1;
        const uint32_t k2 = (tn1 & s1) | (ts1 & b);
        const uint32_t r1 = sum ^ k1;
        const uint32_t k2b = sum & k1;
        const uint32_t r2 = k2 ^ k2b;
        const uint32_t r3 = k2 & k2b;   // count 8 (then r0 = r1 = r2 = 0)
        const uint32_t born_p = lookup(tborn, r0, r1, r2, r3);
        const uint32_t keep_p = lookup(tkeep, r0, r1, r2, r3);
        // the decay transition (packed_generations.transition_planes)
        uint32_t nonzero = 0u;
#pragma unroll
        for (int j = 0; j < B; ++j) nonzero |= cur[j];
        const uint32_t kept = alive & keep_p;
        const uint32_t one = (~nonzero & born_p) | kept;
        const uint32_t aging = nonzero & ~kept;
        uint32_t inc[B];
        uint32_t carry = ~0u;
        uint32_t eq = ~0u;
#pragma unroll
        for (int j = 0; j < B; ++j) {
          inc[j] = cur[j] ^ carry;
          carry = cur[j] & carry;
          eq &= ~(inc[j] ^ cbits[j]);
        }
        const int gr = row0 + r;
        const bool zero =
            col_out || (Slab ? rezero_rows && (gr < top || gr >= bottom)
                             : dead && (gr < 0 || gr >= H));
        uint32_t* o = dst + r * stride + x;
#pragma unroll
        for (int j = 0; j < B; ++j) {
          uint32_t v = aging & inc[j] & ~eq;
          if (j == 0) v |= one;
          o[j * plane] = zero ? 0u : v;
        }
        tn0 = tc0; tn1 = tc1;
        tc0 = ts0; tc1 = ts1;
        s0 = sd0; s1 = sd1;
        alive = alive_dn;
#pragma unroll
        for (int j = 0; j < B; ++j) cur[j] = nxt[j];
        p = q;
      }
    }
    __syncthreads();
  }

  // Store the tile: rows gens..gens+th-1, words 2..tw+1 of the padded rows.
  const uint32_t* res = smem + (gens & 1) * buffer;
  for (int pr = warp; pr < B * th; pr += kWarps) {
    const int j = pr / th;
    const int r = pr - j * th;
    const int gr = blockIdx.y * th + r;
    if (gr >= H) continue;
    for (int x = lane; x < tw; x += 32) {
      const int gc = blockIdx.x * tw + x;
      if (gc < Wp)
        out[j * grid_plane + (size_t)gr * Wp + gc] =
            res[j * plane + (r + gens) * stride + x + 2];
    }
  }
}

template <int B, bool Slab>
int launch(const void* in, void* out, int nbands, int H, int Wp, int gens,
           int th, int tw, unsigned born, unsigned survive, unsigned states,
           int dead, int edge_code, const void* edge_codes, void* stream) {
  const size_t smem = 2ull * B * (th + 2 * gens) * (tw + 4) * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        life_generations_kernel<B, Slab>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Wp + tw - 1) / tw, (H + th - 1) / th, nbands);
  life_generations_kernel<B, Slab><<<grid, kThreads, smem,
                                     (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, H, Wp, gens, th, tw, born, survive,
      states & ((1u << B) - 1u), dead, edge_code, (const int*)edge_codes);
  return (int)cudaGetLastError();
}

template <bool Slab>
int launch_planes(const void* in, void* out, int nbands, int planes, int H,
                  int Wp, int gens, int th, int tw, unsigned born,
                  unsigned survive, unsigned states, int dead, int edge_code,
                  const void* edge_codes, void* stream) {
#define LAUNCH(b)                                                         \
  case b:                                                                 \
    return launch<b, Slab>(in, out, nbands, H, Wp, gens, th, tw, born,    \
                           survive, states, dead, edge_code, edge_codes,  \
                           stream)
  switch (planes) {
    LAUNCH(2); LAUNCH(3); LAUNCH(4); LAUNCH(5); LAUNCH(6); LAUNCH(7);
    LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (planes, H, Wp) uint32 stacks) on `stream`. Returns the CUDA error code
// of the launch (0 on success), or cudaErrorInvalidValue for a plane count
// outside 2..8.
int life_generations_launch(const void* in, void* out, int planes, int H,
                            int Wp, int gens, int th, int tw, unsigned born,
                            unsigned survive, unsigned states, int dead,
                            void* stream) {
  return launch_planes<false>(in, out, 1, planes, H, Wp, gens, th, tw, born,
                              survive, states, dead, 0, nullptr, stream);
}

// Launches one slab-mode call of `gens` generations from `in` to `out`
// (distinct (nbands, planes, He, Wp) uint32 batches) on `stream`;
// `dead_cols` closes the columns, `edge_codes` (a device array of nbands
// int32 codes, or null for `edge_code` on every band) the rows. Returns
// as life_generations_launch does.
int life_generations_slab_launch(const void* in, void* out, int nbands,
                                 int planes, int He, int Wp, int gens, int th,
                                 int tw, unsigned born, unsigned survive,
                                 unsigned states, int dead_cols, int edge_code,
                                 const void* edge_codes, void* stream) {
  return launch_planes<true>(in, out, nbands, planes, He, Wp, gens, th, tw,
                             born, survive, states, dead_cols, edge_code,
                             edge_codes, stream);
}

const char* life_generations_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
