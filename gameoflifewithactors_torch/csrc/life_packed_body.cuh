// The device body of the bit-packed 3x3 B/S kernels for Hopper (sm_90a):
// B1 (life_packed.cu) and B2 (life_slab.cu) are instantiations of the one
// kernel here, which a template flag puts into one of two forms --
//
// - kGrid: `gens` generations of whole (H, W/32) grids, TORUS or DEAD on
//   both axes, rows and words read modulo H and W/32 (exact for any grid
//   and tile). One grid is B1's full grid; a batch of them, blockIdx.z the
//   grid, with a (B,) mask is B2's lane form (the serving lanes: every
//   band of a lane is a whole grid, so the rows beyond it are its own rows
//   modulo H under TORUS and zero under DEAD -- what the row exchange,
//   B2's slab form and the crop compute, read here without an extended
//   copy). The blocks of a band whose mask entry is 0 copy their tile.
// - kSlab: B2's slab form, a batch of halo-extended (He, W/32) bands:
//   rows outside [0, He) load as zero and then evolve freely, the edge
//   code (one for the batch, or one per band read by blockIdx.z) puts a
//   dead band of `gens` rows at the top (bit 0) or bottom (bit 1) that is
//   zero before every generation, and horizontally TORUS wraps words and
//   DEAD zeroes the words outside the grid.
//
// Each generation is what ops/packed.py::step_packed_slab computes, with
// the rule looked up as life_rule.cuh's next_alive does
// (ops/packed.py::encoded_next_plane).
//
// What bounds it on this card: integer issue (LOP3 and funnel shifts, and
// beside them the shared-memory loads, stores and shuffles). B3/S23 needs
// about 20 bitwise operations per 32-cell word and generation
// (chip_smoke.py::ops_per_word), while a launch reads and writes the grid
// once, so at B1's 16 generations per launch (8 for the lanes and bands)
// the operations take about eight (four) times as long at the INT32 rate
// as the bytes at the HBM rate.
//
// What the design does about it (B3's, life_generations.cu, at one plane):
// - Temporal blocking: a block loads its th x tw-word tile plus `gens`
//   halo rows and one halo word per side (enough while gens <= 32) into
//   shared memory with cp.async, advances `gens` generations there
//   (ping-pong buffers, one barrier per generation), and the last
//   generation computes only the tile's own rows and words and writes
//   them straight to device memory.
// - Warp rows: a warp holds 32 adjacent words of a row, one per lane,
//   loads each once and takes its west and east neighbours by shuffle.
//   With halo words (kHaloCols) lanes 0 and 31 only serve their
//   neighbours, so a warp writes 30 words, and B1's default tile, 58
//   words wide (cuda_stencil.DEFAULT_TILE, from the sweep), fills two
//   warps. A tile that spans a whole row of at most 32 words (a lane of
//   1024-cell grids) needs no halo word: lane 0's west neighbour is the
//   row's last word (kRowTorus) or zero (kRowDead, two ANDs), so all 32
//   lanes write.
// - Balanced column walks: per generation the block's rows are cut into
//   as many segments as fill its eight warps once, and a warp walks down
//   one (segment, column group), unrolled over a ring of three rows in
//   registers with no exit inside the ring; each row's sums T = w + c + e
//   and S = w + e are computed once.
// - Dead cells cost nothing in the loop: rows outside the grid under DEAD
//   and a slab's dead band, and words outside the grid under DEAD, are
//   zeroed once in both buffers at the load and never written.
// - A rule lookup sized to the rule (life_rule.cuh): B3/S23 tests its two
//   counts in 9 LOP3 instead of the 18 of the table.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "life_bits.cuh"
#include "life_rule.cuh"

namespace life_packed {

enum Form { kGrid = 0, kSlab = 1 };
// How a warp's lanes map onto a row: one halo word per side, or the whole
// row in one warp (at most 32 words) wrapping under TORUS or zero-edged
// under DEAD.
enum Cols { kHaloCols = 0, kRowTorus = 1, kRowDead = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesOut = 30;       // lanes 1..30 of a warp write a word
constexpr int kFar = 1 << 30;       // a row limit no band reaches

using life::kAnd3;
using life::kMajority;
using life::kXor3;
using life::kXorAnd;
using life::lop3;

// What one launch asks, as the entry points receive it.
struct Launch {
  const void* in;
  void* out;
  int nbands, H, Wp, gens, th, tw;
  unsigned born, survive;
  int dead, edge_code;
  const void* edge_codes;   // kSlab: per-band edge codes, or null
  const void* mask;         // kGrid: per-band mask (0 = frozen), or null
  void* stream;
};

struct Args {
  const uint32_t* in;
  uint32_t* out;
  int H, Wp, gens, th, tw, dead, edge_code;
  const int* edge_codes;
  const int* mask;
  unsigned born, survive;
};

// One row of a column walk: the lane's word and the horizontal sums of
// the words around it.
struct Row {
  uint32_t c;
  uint32_t t0, t1, s0, s1;   // T = w + c + e and S = w + e, two bits each
};

// The lane's neighbours in the row: shuffle sources and, under kRowDead,
// all-ones/all-zero masks that zero a neighbour beyond the grid.
struct Nbrs {
  int west, east;
  uint32_t west_keep, east_keep;
};

// Loads this lane's word of a row, takes its neighbours' words from the
// adjacent lanes and sums them.
template <int C>
__device__ __forceinline__ void load_row(const uint32_t* q, const Nbrs& nb,
                                         Row& row) {
  const uint32_t c = *q;
  uint32_t west, east;
  if constexpr (C == kHaloCols) {
    west = __shfl_up_sync(0xffffffffu, c, 1);
    east = __shfl_down_sync(0xffffffffu, c, 1);
  } else {
    west = __shfl_sync(0xffffffffu, c, nb.west);
    east = __shfl_sync(0xffffffffu, c, nb.east);
    if constexpr (C == kRowDead) {
      west &= nb.west_keep;
      east &= nb.east_keep;
    }
  }
  const uint32_t w = __funnelshift_l(west, c, 1);  // (c << 1) | (west >> 31)
  const uint32_t e = __funnelshift_r(c, east, 1);  // (c >> 1) | (east << 31)
  row.c = c;
  row.t0 = lop3<kXor3>(w, c, e);
  row.t1 = lop3<kMajority>(w, c, e);
  row.s0 = w ^ e;
  row.s1 = w & e;
}

// The centre row's next word from the rows north and south of it: the
// count T_n + S + T_s in bit-planes r0..r3, then the rule.
template <int K>
__device__ __forceinline__ uint32_t next_word(const Row& n, const Row& c,
                                              const Row& s,
                                              const life::Rule<K>& rule) {
  const uint32_t r0 = lop3<kXor3>(n.t0, c.s0, s.t0);
  const uint32_t k1 = lop3<kMajority>(n.t0, c.s0, s.t0);
  const uint32_t sum = lop3<kXor3>(n.t1, c.s1, s.t1);
  const uint32_t k2 = lop3<kMajority>(n.t1, c.s1, s.t1);
  const uint32_t r1 = sum ^ k1;
  const uint32_t r2 = lop3<kXorAnd>(k2, sum, k1);
  // count 8 (r0 = r1 = r2 = 0); the equality path never reads it
  const uint32_t r3 = K == 0 ? lop3<kAnd3>(k2, sum, k1) : 0u;
  return life::next_alive<K>(rule, c.c, r0, r1, r2, r3);
}

// Where a walk puts its rows, one after another from its first: the next
// buffer in shared memory, or device memory in the last generation.
template <bool Last>
struct Sink {
  uint32_t* p;    // the current row's word
  int step;       // words to the next row
  bool put;       // whether this lane writes
  __device__ __forceinline__ void operator()(uint32_t v) {
    if (put) *p = v;
    p += step;
  }
};

// n rows of one column: q is this lane's word in the row above the first
// output row. The loop is unrolled over a ring of three rows: north,
// centre, and south, loaded into the slot the north row of the row
// before held. The exit is warp-uniform, so the shuffles see every lane.
template <int K, int C, bool Last>
__device__ __forceinline__ void walk(const uint32_t* q, int rowstep, int n,
                                     Sink<Last> sink, const life::Rule<K>& rule,
                                     const Nbrs& nb) {
  Row ring[3];
  load_row<C>(q, nb, ring[0]);
  q += rowstep;
  load_row<C>(q, nb, ring[1]);
  q += rowstep;
  // three rows at a time with no exit between them, so that the compiler
  // may overlap their loads and shuffles; then the last one or two
  for (; n >= 3; n -= 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      load_row<C>(q, nb, ring[(j + 2) % 3]);
      q += rowstep;
      sink(next_word<K>(ring[j], ring[(j + 1) % 3], ring[(j + 2) % 3], rule));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j >= n) break;
    load_row<C>(q, nb, ring[(j + 2) % 3]);
    q += rowstep;
    sink(next_word<K>(ring[j], ring[(j + 1) % 3], ring[(j + 2) % 3], rule));
  }
}

// The blocks of a frozen band (mask entry 0) copy their tile.
__device__ __forceinline__ void copy_tile(const uint32_t* in, uint32_t* out,
                                          int H, int Wp, int th, int tw) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < th; r += kWarps) {
    const int gr = blockIdx.y * th + r;
    if (gr >= H) break;
    for (int x = lane; x < tw; x += 32) {
      const int gc = blockIdx.x * tw + x;
      if (gc < Wp) out[(size_t)gr * Wp + gc] = in[(size_t)gr * Wp + gc];
    }
  }
}

// F picks the form (kGrid: whole grids, `dead` closing both axes, a
// mask per band; kSlab: bands of H = He extended rows, `dead` closing the
// columns only, `edge_code` or edge_codes[blockIdx.z] the rows), K the
// rule path (life_rule.cuh), C the lanes' columns (Cols; the row forms
// take tw == Wp <= 32). blockIdx.z is the band.
template <int F, int K, int C>
__global__ void __launch_bounds__(kThreads, 2)
life_packed_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr bool kRow = C != kHaloCols;
  const int H = a.H, Wp = a.Wp, gens = a.gens, th = a.th, tw = a.tw;
  const int L = th + 2 * gens;
  // words computed per row: the tile and one halo word each side, or the
  // whole row; a padded row holds them and a zero word at each end, or
  // one word per lane
  const int ww = kRow ? Wp : tw + 2;
  const int stride = kRow ? 32 : ww + 2;
  const int buffer = L * stride;
  const int row0 = blockIdx.y * th - gens;         // grid row of slab row 0
  const int xg = blockIdx.x * tw - (kRow ? 0 : 2); // grid word of padded word 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t band = (size_t)blockIdx.z * H * Wp;
  const uint32_t* in = a.in + band;
  uint32_t* out = a.out + band;
  // the live rows of the slab, which every generation but the last
  // computes: a slab's dead band (extended rows < top or >= bottom) and a
  // grid's rows outside it under DEAD stay zero
  int top = -kFar, bottom = kFar;
  if constexpr (F == kSlab) {
    const int code = a.edge_codes != nullptr ? a.edge_codes[blockIdx.z] : a.edge_code;
    if (code & 1) top = gens;
    if (code & 2) bottom = H - gens;
  } else {
    if (a.mask != nullptr && a.mask[blockIdx.z] == 0) {
      copy_tile(in, out, H, Wp, th, tw);
      return;
    }
    if (a.dead) {
      top = 0;
      bottom = H;
    }
  }
  const int ya = max(0, top - row0), yb = min(L, bottom - row0);

  // Load: one warp per row, so a row's source index is reduced once; the
  // words are copied asynchronously, the zeros stored. A slab's rows
  // outside [0, H) and in its dead band read as zeros; a grid's wrap
  // under TORUS. The other buffer gets zeros where no generation writes:
  // the pads, the dead rows and the dead words.
  for (int r = warp; r < L; r += kWarps) {
    int gr = row0 + r;
    bool row_in = gr >= 0 && gr < H;
    if constexpr (F == kSlab) row_in = row_in && gr >= top && gr < bottom;
    if (!row_in) {
      if (F == kSlab || a.dead) {
        gr = 0;  // the row reads as zeros; keep the pointer in range
      } else {
        gr %= H;
        if (gr < 0) gr += H;
        row_in = true;
      }
    }
    const bool live = r >= ya && r < yb;
    const uint32_t* src = in + (size_t)gr * Wp;
    uint32_t* row = smem + r * stride;
    for (int x = lane; x < stride; x += 32) {
      int gc = xg + x;
      bool col_in;   // a word the generations compute
      if constexpr (kRow) {
        col_in = x < Wp;
      } else {
        col_in = x > 0 && x <= ww;
        if (col_in) {
          if (a.dead) {
            col_in = gc >= 0 && gc < Wp;
          } else if (gc < 0 || gc >= Wp) {
            gc %= Wp;
            if (gc < 0) gc += Wp;
          }
        }
      }
      if (row_in && col_in) {
        life::copy_word(row + x, src + gc);
      } else {
        row[x] = 0u;
      }
      if (!(live && col_in)) row[buffer + x] = 0u;
    }
  }
  const life::Rule<K> rule = life::make_rule<K>(a.born, a.survive);
  Nbrs nb = {0, 0, ~0u, ~0u};
  if constexpr (kRow) {
    nb.west = lane == 0 ? Wp - 1 : lane - 1;
    nb.east = lane + 1 >= Wp ? 0 : lane + 1;
    if (lane == 0) nb.west_keep = 0u;
    if (lane == Wp - 1) nb.east_keep = 0u;
  }
  life::wait_copies();
  __syncthreads();

  for (int k = 0; k < gens; ++k) {
    const uint32_t* src = smem + (k & 1) * buffer;
    const bool last = k + 1 == gens;
    // output rows [lo, hi) and padded words [x0, x0 + ncols): the last
    // generation computes the tile only, clipped to the grid, the others
    // their live rows and every word
    int lo = k + 1, hi = L - k - 1;
    if (last) {
      hi = min(hi, H - row0);
    } else {
      lo = max(lo, ya);
      hi = min(hi, yb);
    }
    const int x0 = kRow ? 0 : (last ? 2 : 1);
    const int ncols = kRow ? Wp : (last ? min(tw, Wp - (int)blockIdx.x * tw) : ww);
    const int rows = hi - lo;
    if (rows > 0) {
      // (segment, column group) items filling the warps' rounds, the
      // segments of nearly equal length
      const int groups = kRow ? 1 : (ncols + kLanesOut - 1) / kLanesOut;
      const int rounds = (groups + kWarps - 1) / kWarps;
      const int nseg = min(rows, max(1, rounds * kWarps / groups));
      const int sq = rows / nseg, srem = rows - sq * nseg;
      for (int item = warp; item < groups * nseg; item += kWarps) {
        const int s = item / groups;
        const int cg = item - s * groups;
        const int rs = lo + s * sq + min(s, srem);
        const int n = sq + (s < srem ? 1 : 0);
        const int x = kRow ? lane : x0 - 1 + cg * kLanesOut + lane;  // padded column
        const int gc = xg + x;
        const bool put = kRow ? lane < Wp
                              : lane >= 1 && lane <= kLanesOut && x - x0 < ncols &&
                                    !(a.dead && (gc < 0 || gc >= Wp));
        // lanes past the last column read the end pad
        const uint32_t* q = src + (rs - 1) * stride + min(x, stride - 1);
        if (last) {
          Sink<true> sink = {out + (ptrdiff_t)(row0 + rs) * Wp + gc, Wp, put};
          walk<K, C, true>(q, stride, n, sink, rule, nb);
        } else {
          const int to = (k & 1) ? -buffer : buffer;
          Sink<false> sink = {const_cast<uint32_t*>(q) + stride + to, stride, put};
          walk<K, C, false>(q, stride, n, sink, rule, nb);
        }
      }
    }
    if (!last) __syncthreads();
  }
}

template <int F, int K>
void (*pick_cols(int cols))(Args) {
  if constexpr (F == kSlab) {
    return life_packed_kernel<F, K, kHaloCols>;
  } else {
    switch (cols) {
      case kRowTorus: return life_packed_kernel<F, K, kRowTorus>;
      case kRowDead: return life_packed_kernel<F, K, kRowDead>;
      default: return life_packed_kernel<F, K, kHaloCols>;
    }
  }
}

// Launches form F: the rule path from the masks, the columns from the
// tile (a grid tile spanning a whole row of at most 32 words takes a row
// form). Returns the CUDA error code of the launch (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
template <int F>
int launch(const Launch& l) {
  if (l.gens < 1 || l.gens > 32 || l.th < 1 || l.tw < 1 || l.H < 1 || l.Wp < 1 ||
      l.nbands < 1)
    return (int)cudaErrorInvalidValue;
  int cols = kHaloCols, tw = l.tw;
  if (F == kGrid && l.tw >= l.Wp && l.Wp <= 32) {
    cols = l.dead ? kRowDead : kRowTorus;
    tw = l.Wp;
  }
  void (*kernel)(Args);
  switch (life::rule_path(l.born, l.survive)) {
    case 1: kernel = pick_cols<F, 1>(cols); break;
    case 2: kernel = pick_cols<F, 2>(cols); break;
    case 3: kernel = pick_cols<F, 3>(cols); break;
    case 4: kernel = pick_cols<F, 4>(cols); break;
    default: kernel = pick_cols<F, 0>(cols); break;
  }
  Args a;
  a.in = (const uint32_t*)l.in;
  a.out = (uint32_t*)l.out;
  a.H = l.H;
  a.Wp = l.Wp;
  a.gens = l.gens;
  a.th = l.th;
  a.tw = tw;
  a.dead = l.dead;
  a.edge_code = l.edge_code;
  a.edge_codes = (const int*)l.edge_codes;
  a.mask = (const int*)l.mask;
  a.born = l.born;
  a.survive = l.survive;
  const int stride = cols == kHaloCols ? tw + 4 : 32;
  const size_t smem = 2ull * (l.th + 2 * l.gens) * stride * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((l.Wp + tw - 1) / tw, (l.H + l.th - 1) / l.th, l.nbands);
  kernel<<<grid, kThreads, smem, (cudaStream_t)l.stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace life_packed
