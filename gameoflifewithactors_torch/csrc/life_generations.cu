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
// What bounds it on this card: integer issue (LOP3, funnel shifts, and the
// shared-memory loads, stores and shuffles beside them). A generation of
// Brian's Brain (b = 2) needs about 27 bitwise operations per 32-cell word
// (chip_smoke.py::gen_ops_per_word), while a launch of 16 generations
// reads and writes the b planes once, so the operations take about five
// times as long at the INT32 rate as the bytes at the HBM rate.
//
// What the design does about it:
// - Temporal blocking, as on the TPU: a block loads its th x tw-word tile
//   of all b planes plus `gens` halo rows and one halo word per side
//   (enough while gens <= 32) into shared memory, advances `gens`
//   generations there (ping-pong buffers, one barrier per generation), and
//   the last generation computes only the tile's own rows and words and
//   writes them straight to device memory. The tile load is asynchronous
//   (cp.async, one word per copy, all in flight before one wait).
// - Shared memory holds the planes of a word side by side (word x of row r
//   at (r * stride + x) * b), so a row's b planes are one vector load and
//   one vector store for b = 2, 4, 8, and the row loop steps one pointer.
// - Each word's alive plane (p0 & ~(p1 | ... | p_{b-1})) is computed once
//   per generation: a warp holds 32 adjacent words of a row, one per lane,
//   and takes its west and east neighbours' alive words by warp shuffles.
//   Lanes 0 and 31 only serve their neighbours, so a warp writes 30 words
//   and the warps of a row overlap by two; the default tile is 28 words
//   wide so that its 30 computed words fill one warp, and as tall as lets
//   two blocks share an SM (192 rows at b = 2 and 16 generations), which
//   spends the fewest rows on the halo.
// - Balanced column walks: per generation the block's rows are cut into
//   as many segments as fill its eight warps once, of nearly equal length,
//   and a warp walks down one (segment, 30-word column group). The row
//   loop is unrolled three times over a ring of three rows in registers
//   (the north row's sums, the centre row's planes and sums, the south
//   row being loaded), so the horizontal sums T = w + c + e and S = w + e
//   of every row are computed once and no register is copied per row;
//   the three rows have no exit between them, so the compiler overlaps
//   their loads and shuffles (an exit after each row cost 10%). A segment
//   recomputes the sums of the two rows above its first output, which
//   costs less than the rule and the transition of one row.
// - Dead cells cost nothing in the loop: the rows a generation must zero
//   (outside the grid under DEAD, a slab's dead band) and the words outside
//   the grid under DEAD are zeroed in both buffers at the load and never
//   written, so each walk covers only the live rows and its lanes store
//   only live words.
// - A rule lookup sized to the rule: the launch picks one of five
//   instantiations per plane count and mode from the rule's counts
//   (life_generations_rule_path, the same choice as
//   cuda_stencil._generations_rule_encoding). Rules whose births and
//   survivals together name K = 1..4 counts, all in 1..7, test exactly
//   those counts: a count's equality plane is three LOP3 over the count's
//   three low bit-planes against all-ones/all-zero masks of its bits
//   (count 8 has low bits 000 and matches none of them), and joins the
//   birth and survival planes by one LOP3 each. Every other rule (count 0
//   or 8, or more than four counts) takes the 9-entry table of
//   life_rule.cuh, a mux tree with the alive plane as a selector (17
//   LOP3). Brian's Brain's lookup is 5 operations instead of 19.
// - The per-word arithmetic is packed_generations.step_planes_slab's: the
//   3x3 count T_north + S + T_south in four bit-planes, births only where
//   the state is 0 (a dying cell must not be born), then the decay
//   transition, a +1 carry chain over the planes, zeroed where it reaches
//   C; the zeroing compares with C mod 2^b, which for C = 2^b is the
//   dropped carry's 0, so every C takes the same branch-free path. Every
//   three-input step is one LOP3 (lop3<>, life_bits.cuh): left to the
//   compiler the same source took 1.8 times as long.
// - TORUS reads rows and words modulo H and W/32, exact for any grid and
//   tile. The slab mode is a template flag: it picks the load rule, the
//   dead band and the band offset (blockIdx.z), and shares every line of
//   the per-word arithmetic.
// - Build: 7 plane counts x 5 rule paths x full/slab are 70 kernels. The
//   file is compiled as eight translation units at once (_build.UNITS):
//   the unit with GEN_PLANES=b instantiates b's ten kernels, and the unit
//   without it holds the C entry points, which dispatch on b.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "life_rule.cuh"

namespace life_generations {

// What one launch asks, as the entry points receive it.
struct Launch {
  const void* in;
  void* out;
  int nbands, H, Wp, gens, th, tw;
  unsigned born, survive, states;
  int slab, dead, edge_code;
  const void* edge_codes;
  void* stream;
};

using life::rule_path;

template <int B>
int launch_planes(const Launch& l);

}  // namespace life_generations

#ifdef GEN_PLANES

namespace life_generations {

using life::copy_word;
using life::kAnd3;
using life::kAndXnor;
using life::kMajority;
using life::kXor3;
using life::kXorAnd;
using life::lop3;
using life::make_rule;
using life::Rule;
using life::rule_planes;
using life::wait_copies;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesOut = 30;       // lanes 1..30 of a warp write a word
constexpr int kFar = 1 << 30;       // a row limit no band reaches

constexpr int kAndNotOr = 0xae;     // (~a & b) | c
constexpr int kAndAndNot = 0x40;    // a & b & ~c

struct Args {
  const uint32_t* in;
  uint32_t* out;
  int H, Wp, gens, th, tw, dead, edge_code;
  const int* edge_codes;
  unsigned born, survive, states;
};

// One row of a column walk: the word's state planes, its alive and
// nonzero planes, and the horizontal sums of the alive words around it.
template <int B>
struct Row {
  uint32_t p[B];
  uint32_t alive, nonzero;
  uint32_t t0, t1, s0, s1;   // T = w + c + e and S = w + e, two bits each
};

// The b planes of a word, side by side in shared memory: one vector
// access for b = 2, 4 and 8 (a word's planes start at a multiple of b).
template <int B>
__device__ __forceinline__ void load_planes(const uint32_t* q, uint32_t (&v)[B]) {
  if constexpr (B % 4 == 0) {
#pragma unroll
    for (int i = 0; i < B / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(q)[i];
      v[4 * i] = u.x;
      v[4 * i + 1] = u.y;
      v[4 * i + 2] = u.z;
      v[4 * i + 3] = u.w;
    }
  } else if constexpr (B % 2 == 0) {
#pragma unroll
    for (int i = 0; i < B / 2; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(q)[i];
      v[2 * i] = u.x;
      v[2 * i + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) v[i] = q[i];
  }
}

template <int B>
__device__ __forceinline__ void store_planes(uint32_t* q, const uint32_t (&v)[B]) {
  if constexpr (B % 4 == 0) {
#pragma unroll
    for (int i = 0; i < B / 4; ++i)
      reinterpret_cast<uint4*>(q)[i] =
          make_uint4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (B % 2 == 0) {
#pragma unroll
    for (int i = 0; i < B / 2; ++i)
      reinterpret_cast<uint2*>(q)[i] = make_uint2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) q[i] = v[i];
  }
}

// Loads this lane's word of a row, computes its alive plane once, takes
// the neighbours' alive words from the adjacent lanes and sums them.
template <int B>
__device__ __forceinline__ void load_row(const uint32_t* q, Row<B>& row) {
  load_planes<B>(q, row.p);
  uint32_t higher = 0u;
#pragma unroll
  for (int j = 1; j < B; ++j) higher |= row.p[j];
  const uint32_t c = row.p[0] & ~higher;
  row.alive = c;
  row.nonzero = row.p[0] | higher;
  const uint32_t west = __shfl_up_sync(0xffffffffu, c, 1);
  const uint32_t east = __shfl_down_sync(0xffffffffu, c, 1);
  const uint32_t w = __funnelshift_l(west, c, 1);  // (c << 1) | (west >> 31)
  const uint32_t e = __funnelshift_r(c, east, 1);  // (c >> 1) | (east << 31)
  row.t0 = lop3<kXor3>(w, c, e);
  row.t1 = lop3<kMajority>(w, c, e);
  row.s0 = w ^ e;
  row.s1 = w & e;
}

// The centre row's next planes from the rows north and south of it
// (packed_generations.step_planes_slab for one word).
template <int B, int K>
__device__ __forceinline__ void next_planes(const Row<B>& n, const Row<B>& c,
                                            const Row<B>& s, const Rule<K>& rule,
                                            const uint32_t (&cbits)[B],
                                            uint32_t (&out)[B]) {
  // count = T_n + S + T_s in four bit-planes r0..r3
  const uint32_t r0 = lop3<kXor3>(n.t0, c.s0, s.t0);
  const uint32_t k1 = lop3<kMajority>(n.t0, c.s0, s.t0);
  const uint32_t sum = lop3<kXor3>(n.t1, c.s1, s.t1);
  const uint32_t k2 = lop3<kMajority>(n.t1, c.s1, s.t1);
  const uint32_t r1 = sum ^ k1;
  const uint32_t r2 = lop3<kXorAnd>(k2, sum, k1);
  const uint32_t r3 = lop3<kAnd3>(k2, sum, k1);   // count 8 (r0 = r1 = r2 = 0)
  uint32_t born, keep;
  rule_planes<K>(rule, c.alive, r0, r1, r2, r3, born, keep);
  // the decay transition (packed_generations.transition_planes)
  const uint32_t kept = c.alive & keep;
  const uint32_t one = lop3<kAndNotOr>(c.nonzero, born, kept);
  const uint32_t aging = c.nonzero & ~kept;
  uint32_t inc[B];
  uint32_t carry = ~0u;
  uint32_t eq = ~0u;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    inc[j] = c.p[j] ^ carry;
    carry = c.p[j] & carry;
    eq = lop3<kAndXnor>(eq, inc[j], cbits[j]);
  }
#pragma unroll
  for (int j = 0; j < B; ++j) out[j] = lop3<kAndAndNot>(aging, inc[j], eq);
  out[0] |= one;
}

// Where a walk puts its rows, one after another from its first: the next
// buffer in shared memory, or device memory in the last generation.
template <int B, bool Last>
struct Sink {
  uint32_t* p;    // the current row's word (plane 0)
  int step;       // words to the next row
  bool put;       // whether this lane writes
  __device__ __forceinline__ void operator()(const uint32_t (&v)[B]) {
    if (put) store_planes<B>(p, v);
    p += step;
  }
};

template <int B>
struct Sink<B, true> {
  uint32_t* p;
  int step;
  bool put;
  size_t plane;   // words between planes in device memory
  __device__ __forceinline__ void operator()(const uint32_t (&v)[B]) {
    if (put) {
#pragma unroll
      for (int j = 0; j < B; ++j) p[j * plane] = v[j];
    }
    p += step;
  }
};

// n rows of one column: q is this lane's word in the row above the first
// output row. The loop is unrolled over a ring of three rows: north,
// centre, and south, loaded into the slot the north row of the row
// before held. The exit is warp-uniform, so the shuffles see every lane.
template <int B, int K, bool Last>
__device__ __forceinline__ void walk(const uint32_t* q, int rowstep, int n,
                                     Sink<B, Last> sink, const Rule<K>& rule,
                                     const uint32_t (&cbits)[B]) {
  Row<B> ring[3];
  load_row<B>(q, ring[0]);
  q += rowstep;
  load_row<B>(q, ring[1]);
  q += rowstep;
  // three rows at a time with no exit between them, so that the compiler
  // may overlap their loads and shuffles; then the last one or two
  for (; n >= 3; n -= 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      load_row<B>(q, ring[(j + 2) % 3]);
      q += rowstep;
      uint32_t v[B];
      next_planes<B, K>(ring[j], ring[(j + 1) % 3], ring[(j + 2) % 3], rule,
                        cbits, v);
      sink(v);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j >= n) break;
    load_row<B>(q, ring[(j + 2) % 3]);
    q += rowstep;
    uint32_t v[B];
    next_planes<B, K>(ring[j], ring[(j + 1) % 3], ring[(j + 2) % 3], rule,
                      cbits, v);
    sink(v);
  }
}

// Slab = false: the full grid (H rows, `dead` closes both axes). Slab =
// true: blockIdx.z is a band of H = He extended rows, `dead` closes the
// columns only, and `edge_code` (or edge_codes[blockIdx.z]) sets the dead
// band. K picks the rule path (make_rule).
template <int B, bool Slab, int K>
__global__ void __launch_bounds__(kThreads, 2)
life_generations_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int H = a.H, Wp = a.Wp, gens = a.gens, th = a.th, tw = a.tw;
  const int L = th + 2 * gens;
  const int ww = tw + 2;        // words computed per row: tile + one halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int rowstep = stride * B;
  const int buffer = L * rowstep;
  const int row0 = blockIdx.y * th - gens;  // grid row of slab row 0
  const int col0 = blockIdx.x * tw - 1;     // grid word of slab word 0
  const size_t grid_plane = (size_t)H * Wp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t* in = a.in;
  uint32_t* out = a.out;
  // the live rows of the slab, which every generation but the last
  // computes: a slab's dead band (extended rows < top or >= bottom) and
  // the full grid's rows outside it under DEAD stay zero
  int top = -kFar, bottom = kFar;
  if constexpr (Slab) {
    in += (size_t)blockIdx.z * B * grid_plane;
    out += (size_t)blockIdx.z * B * grid_plane;
    const int code = a.edge_codes != nullptr ? a.edge_codes[blockIdx.z] : a.edge_code;
    if (code & 1) top = gens;
    if (code & 2) bottom = H - gens;
  } else if (a.dead) {
    top = 0;
    bottom = H;
  }
  const int ya = max(0, top - row0), yb = min(L, bottom - row0);

  // Load: one warp per row, so a row's source index is reduced once; the
  // words are copied asynchronously, the zeros stored. A slab's rows
  // outside [0, H) and in its dead band read as zeros; the full grid's
  // wrap under TORUS. The other buffer gets zeros where no generation
  // writes: the pads, the dead rows and the dead words.
  for (int r = warp; r < L; r += kWarps) {
    int gr = row0 + r;
    bool row_in = gr >= 0 && gr < H;
    if constexpr (Slab) row_in = row_in && gr >= top && gr < bottom;
    if (!row_in) {
      if (Slab || a.dead) {
        gr = 0;  // the row reads as zeros; keep the pointer in range
      } else {
        gr %= H;
        if (gr < 0) gr += H;
        row_in = true;
      }
    }
    const bool live = r >= ya && r < yb;
    const uint32_t* src = in + (size_t)gr * Wp;
    uint32_t* row = smem + r * rowstep;
    for (int x = lane; x < stride; x += 32) {
      int gc = col0 + x - 1;
      bool col_in = x > 0 && x <= ww;   // a word the generations compute
      if (col_in) {
        if (a.dead) {
          col_in = gc >= 0 && gc < Wp;
        } else if (gc < 0 || gc >= Wp) {
          gc %= Wp;
          if (gc < 0) gc += Wp;
        }
      }
      uint32_t* w = row + x * B;
#pragma unroll
      for (int j = 0; j < B; ++j) {
        if (row_in && col_in) {
          copy_word(w + j, src + j * grid_plane + gc);
        } else {
          w[j] = 0u;
        }
        if (!(live && col_in)) w[buffer + j] = 0u;
      }
    }
  }
  const Rule<K> rule = make_rule<K>(a.born, a.survive);
  // bits of C mod 2^B as all-ones/all-zero words
  uint32_t cbits[B];
#pragma unroll
  for (int j = 0; j < B; ++j) cbits[j] = 0u - ((a.states >> j) & 1u);
  wait_copies();
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
    const int x0 = last ? 2 : 1;
    const int ncols = last ? min(tw, Wp - (int)blockIdx.x * tw) : ww;
    const int rows = hi - lo;
    if (rows > 0) {
      // (segment, column group) items filling the warps' rounds, the
      // segments of nearly equal length
      const int groups = (ncols + kLanesOut - 1) / kLanesOut;
      const int rounds = (groups + kWarps - 1) / kWarps;
      const int nseg = min(rows, max(1, rounds * kWarps / groups));
      const int sq = rows / nseg, srem = rows - sq * nseg;
      for (int item = warp; item < groups * nseg; item += kWarps) {
        const int s = item / groups;
        const int cg = item - s * groups;
        const int rs = lo + s * sq + min(s, srem);
        const int n = sq + (s < srem ? 1 : 0);
        const int x = x0 - 1 + cg * kLanesOut + lane;  // padded column
        const int gc = col0 + x - 1;
        const bool put = lane >= 1 && lane <= kLanesOut && x - x0 < ncols &&
                         !(a.dead && (gc < 0 || gc >= Wp));
        // lanes past the last column read the end pad
        const uint32_t* q = src + (rs - 1) * rowstep + min(x, stride - 1) * B;
        if (last) {
          Sink<B, true> sink = {out + (ptrdiff_t)(row0 + rs) * Wp + gc, Wp, put,
                                grid_plane};
          walk<B, K, true>(q, rowstep, n, sink, rule, cbits);
        } else {
          const int to = (k & 1) ? -buffer : buffer;
          Sink<B, false> sink = {const_cast<uint32_t*>(q) + rowstep + to,
                                 rowstep, put};
          walk<B, K, false>(q, rowstep, n, sink, rule, cbits);
        }
      }
    }
    if (!last) __syncthreads();
  }
}

template <int B, int K>
void (*pick(bool slab))(Args) {
  return slab ? life_generations_kernel<B, true, K> : life_generations_kernel<B, false, K>;
}

template <int B>
int launch_planes(const Launch& l) {
  void (*kernel)(Args);
  switch (rule_path(l.born, l.survive)) {
    case 1: kernel = pick<B, 1>(l.slab); break;
    case 2: kernel = pick<B, 2>(l.slab); break;
    case 3: kernel = pick<B, 3>(l.slab); break;
    case 4: kernel = pick<B, 4>(l.slab); break;
    default: kernel = pick<B, 0>(l.slab); break;
  }
  Args a;
  a.in = (const uint32_t*)l.in;
  a.out = (uint32_t*)l.out;
  a.H = l.H;
  a.Wp = l.Wp;
  a.gens = l.gens;
  a.th = l.th;
  a.tw = l.tw;
  a.dead = l.dead;
  a.edge_code = l.edge_code;
  a.edge_codes = (const int*)l.edge_codes;
  a.born = l.born;
  a.survive = l.survive;
  a.states = l.states & ((1u << B) - 1u);
  const size_t smem = 2ull * B * (l.th + 2 * l.gens) * (l.tw + 4) * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((l.Wp + l.tw - 1) / l.tw, (l.H + l.th - 1) / l.th, l.nbands);
  kernel<<<grid, kThreads, smem, (cudaStream_t)l.stream>>>(a);
  return (int)cudaGetLastError();
}

template int launch_planes<GEN_PLANES>(const Launch&);

}  // namespace life_generations

#else  // the unit of the C entry points

namespace {

using namespace life_generations;

int launch(const Launch& l, int planes) {
  if (l.gens < 1 || l.gens > 32 || l.th < 1 || l.tw < 1)
    return (int)cudaErrorInvalidValue;
  switch (planes) {
    case 2: return launch_planes<2>(l);
    case 3: return launch_planes<3>(l);
    case 4: return launch_planes<4>(l);
    case 5: return launch_planes<5>(l);
    case 6: return launch_planes<6>(l);
    case 7: return launch_planes<7>(l);
    case 8: return launch_planes<8>(l);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (planes, H, Wp) uint32 stacks) on `stream`. Returns the CUDA error code
// of the launch (0 on success), or cudaErrorInvalidValue for a plane count
// outside 2..8 or a geometry the kernel does not take.
int life_generations_launch(const void* in, void* out, int planes, int H,
                            int Wp, int gens, int th, int tw, unsigned born,
                            unsigned survive, unsigned states, int dead,
                            void* stream) {
  const Launch l = {in, out, 1, H, Wp, gens, th, tw, born, survive, states,
                    0, dead, 0, nullptr, stream};
  return launch(l, planes);
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
  const Launch l = {in, out, nbands, He, Wp, gens, th, tw, born, survive,
                    states, 1, dead_cols, edge_code, edge_codes, stream};
  return launch(l, planes);
}

// The rule path a launch takes for these born and survive masks: the
// number of counts the equality path tests (1..4), or 0 for the table.
int life_generations_rule_path(unsigned born, unsigned survive) {
  return rule_path(born, survive);
}

const char* life_generations_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // GEN_PLANES
