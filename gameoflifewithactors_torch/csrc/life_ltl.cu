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
// What bounds it on this card: integer issue (LOP3 and funnel shifts). A
// radius-5 box generation needs about 78 bitwise operations per 32-cell
// word by the cheapest formulation the repo has (chip_smoke.py::
// ltl_ops_per_word), against 8 bytes of device traffic per word and
// launch, so the operations outweigh the bytes several times over.
//
// What the design does about it:
// - Temporal blocking: a block loads its th x tw-word tile plus r*gens
//   halo rows and hw = ceil(r*gens/32) halo words per side into shared
//   memory and advances `gens` generations there (ping-pong buffers, one
//   barrier per generation; one buffer when gens == 1). The slab loses r
//   rows per side per generation and its edge words turn to garbage r
//   cells per generation, which the hw halo words absorb. The last
//   generation computes only the tile's own words and rows and writes
//   them straight to device memory.
// - The tile load is asynchronous (cp.async, one word per copy): each
//   thread starts all of its copies before it waits for any, so a block
//   waits about one memory latency for its tile instead of one per row a
//   warp loads, and the other resident block computes meanwhile.
// - The box is separable, and each row's horizontal window sum is
//   computed once per generation: a thread walks down a column segment of
//   one word, and for each row entering the (2r+1)-row box it sums the
//   2r+1 funnel-shifted planes of the row with a carry-save network
//   (packed.bit_sliced_sum's order: full adders chained down each level),
//   adds that sum to a running bit-sliced count and subtracts the sum of
//   the row leaving the box. The leaving row's sum was computed 2r+1 rows
//   earlier and waits in a ring of 2r+1 entries held in registers: the
//   row loop is unrolled 2r+1 times under the radius template, so the
//   entering row's sum replaces the leaving row's in the same ring slot,
//   a compile-time index (ptxas -v, printed by chip_smoke.py, shows no
//   spills and no stack frame). Windows per output row fall to
//   (S + 2r) / S for a segment of S rows.
// - The radius is a template parameter, so a window sum has exactly
//   bit_length(2r+1) planes and a count exactly bit_length((2r+1)^2)
//   (box) or bit_length(2r(r+1)+1) (diamond) planes, and every adder and
//   comparator walks only those. Counts are kept modulo 2^planes: the
//   true count never reaches it, so add-then-subtract stays exact. Every
//   full adder, borrow and comparator step is one LOP3, written as such
//   (lop3<>): left to itself the compiler split some of them into three.
//   The row loop advances its shared-memory and output pointers by one
//   row instead of multiplying per row.
// - The rule is branch-free: the wrapper merges the interval boundaries
//   of both sets (lo, hi+1, ...) into one sorted list of distinct
//   boundaries and says, for each, whether it toggles the birth set and
//   the survival set. A count lies in a set iff it is >= an odd number of
//   that set's boundaries, so each set is the XOR of the comparators of
//   its toggling boundaries. A comparator is a borrow chain, one LOP3 per
//   count plane against an all-ones/all-zeros mask of the boundary's bit,
//   and its result joins both sets by one LOP3 each against the toggle
//   masks. The launch passes the masks precomputed, read from the kernel's
//   parameters through uniform registers. Rules of up to kFastBounds
//   boundaries (every named rule) take an unrolled loop over exactly
//   kFastBounds comparators, the unused ones toggling nothing; longer HROT
//   lists take a loop. The loop alone for every rule took 3% longer on
//   Bosco and 5% on a radius-7 diamond, more than the spread between runs
//   (PERF.md). M0 costs nothing: a live cell's window count is one more
//   than its M0 count, so the wrapper moves the survival boundaries up by
//   one (cuda_stencil._ltl_rule_encoding).
// - Work: per generation, the block's rows are cut into as many column
//   segments as fill its threads' rounds, each segment at most `seg`
//   rows (cuda_stencil.DEFAULT_LTL_SEGMENT) and all of nearly equal
//   length; the item-to-(segment, word) mapping
//   advances without a division per item, and the dead rows and words of
//   an item are one live row range fixed per item.
// - The diamond is not separable: each output word sums its 2r+1 rows'
//   windows of widths 2(r-|dy|)+1 directly (carry-save windows, exact
//   planes, the same rule).
// - TORUS reads rows and words modulo H and W/32, exact for any grid and
//   tile, including grids narrower than the halo. DEAD loads zeros outside
//   the grid and zeroes them after every generation, the counterpart of
//   the per-generation _zero_edge_rows re-zero. Shared-memory rows carry a
//   zero word at each end, so the funnel shifts at the edge words need no
//   bounds test.
// - Slab mode is a template flag: it picks the load rule, the dead band
//   and the band offset (blockIdx.z), and shares everything else.
// - Build: 7 radii x box/diamond x full/slab are 28 kernels. The file is
//   compiled as eight translation units at once (_build.UNITS): the unit
//   with LTL_RADIUS=r instantiates radius r's four kernels, and the unit
//   without it holds the two C entry points, which dispatch on the radius.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "life_bits.cuh"

namespace life_ltl {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSetBounds = 32;   // interval boundaries per set (16 intervals)
constexpr int kMaxBounds = 2 * kMaxSetBounds;   // distinct, both sets
constexpr int kFastBounds = 4;      // boundaries the unrolled comparator takes
constexpr int kMaxPlanes = 8;       // counts <= 225 < 256
constexpr int kFar = 1 << 30;       // a row limit no band reaches

// The rule as the kernel reads it, all from kernel parameters: for each
// distinct boundary the all-ones/all-zeros mask of each of its bits and
// whether it toggles the birth and the survival set. The boundaries are
// over the window count with the centre included: an M0 rule's survival
// boundaries arrive shifted up by one (a live centre is one of its own
// window's cells), so M0 costs the kernel nothing.
struct Rule {
  int nbounds;
  uint32_t born[kMaxBounds];
  uint32_t keep[kMaxBounds];
  uint32_t bits[kMaxBounds][kMaxPlanes];
};

struct Args {
  const uint32_t* in;
  uint32_t* out;
  int H, Wp, gens, th, tw, hw, seg, dead, edge_code;
  const int* edge_codes;
  Rule rule;
};

// What one launch asks, as the entry points receive it.
struct Launch {
  const void* in;
  void* out;
  int nbands, H, Wp, gens, th, tw, hw, seg, diamond, slab, dead, edge_code;
  const void* edge_codes;
  void* stream;
  const Rule* rule;
};

template <int R>
int launch_radius(const Launch& a);

}  // namespace life_ltl

#ifdef LTL_RADIUS

namespace life_ltl {

__host__ __device__ constexpr int bit_length(int n) {
  return n == 0 ? 0 : 1 + bit_length(n >> 1);
}

// Starts an asynchronous copy of one word from device to shared memory
// (cp.async): the thread goes on without waiting for it, so all of a
// tile's loads are in flight at once. wait_copies() waits for the
// thread's own copies; a barrier after it publishes them to the block.
__device__ __forceinline__ void copy_word(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// (sel & hi) | (~sel & lo): one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t hi, uint32_t lo) {
  return (sel & hi) | (~sel & lo);
}

using life::kBorrow;
using life::kGeStep;
using life::kMajority;
using life::kXor3;
using life::lop3;

// Carry-save sum of N one-bit planes into bit_length(N) planes, in the
// order of packed.bit_sliced_sum: on each level a chain of full adders
// (and one half adder for an even count) leaves the level's bit, and its
// carries form the next level.
template <int N>
struct Csa {
  __device__ static __forceinline__ void sum(const uint32_t* in, uint32_t* out) {
    if constexpr (N == 1) {
      out[0] = in[0];
    } else {
      uint32_t carry[N / 2];
      uint32_t acc = in[N - 1];
      int c = 0;
#pragma unroll
      for (int k = N - 2; k >= 1; k -= 2) {
        const uint32_t a = in[k], b = in[k - 1];
        carry[c++] = lop3<kMajority>(acc, a, b);
        acc = lop3<kXor3>(acc, a, b);
      }
      if constexpr (N % 2 == 0) {
        carry[c++] = acc & in[0];
        acc ^= in[0];
      }
      out[0] = acc;
      Csa<N / 2>::sum(carry, out + 1);
    }
  }
};

// Horizontal window sum of width 2A+1 centred on each cell of the word at
// p (p[-1] and p[1] its west and east neighbours), bit_length(2A+1) planes.
template <int A>
__device__ __forceinline__ void window(const uint32_t* p,
                                       uint32_t (&w)[bit_length(2 * A + 1)]) {
  const uint32_t c = p[0];
  uint32_t planes[2 * A + 1];
  planes[0] = c;
  if constexpr (A > 0) {
    const uint32_t l = p[-1], r = p[1];
#pragma unroll
    for (int d = 1; d <= A; ++d) {
      planes[2 * d - 1] = __funnelshift_l(l, c, d);  // the cell d to the west
      planes[2 * d] = __funnelshift_r(c, r, d);      // the cell d to the east
    }
  }
  Csa<2 * A + 1>::sum(planes, w);
}

// cnt += w modulo 2^NC: a half adder, full adders while w has planes,
// then half adders (2 LOP3 per plane, the last plane 1).
template <int NC, int NW>
__device__ __forceinline__ void add_into(uint32_t (&cnt)[NC],
                                         const uint32_t (&w)[NW]) {
  uint32_t carry = cnt[0] & w[0];
  cnt[0] ^= w[0];
#pragma unroll
  for (int i = 1; i < NC; ++i) {
    const uint32_t a = cnt[i];
    if (i < NW) {
      cnt[i] = lop3<kXor3>(a, w[i], carry);
      carry = lop3<kMajority>(a, w[i], carry);
    } else {
      cnt[i] = a ^ carry;
      carry = a & carry;
    }
  }
}

// cnt -= w modulo 2^NC, as add_into.
template <int NC, int NW>
__device__ __forceinline__ void sub_from(uint32_t (&cnt)[NC],
                                         const uint32_t (&w)[NW]) {
  uint32_t borrow = ~cnt[0] & w[0];
  cnt[0] ^= w[0];
#pragma unroll
  for (int i = 1; i < NC; ++i) {
    const uint32_t a = cnt[i];
    if (i < NW) {
      cnt[i] = lop3<kXor3>(a, w[i], borrow);
      borrow = lop3<kBorrow>(a, w[i], borrow);
    } else {
      cnt[i] = a ^ borrow;
      borrow = ~a & borrow;
    }
  }
}

// Joins boundary j's comparator (count >= boundary, an all-ones plane
// where it holds) into the birth and survival sets.
template <int NC>
__device__ __forceinline__ void join(const uint32_t (&cnt)[NC], const Rule& rule,
                                     int j, uint32_t& born, uint32_t& keep) {
  // the borrow out of cnt - boundary, one LOP3 per plane
  uint32_t borrow = rule.bits[j][0] & ~cnt[0];
#pragma unroll
  for (int i = 1; i < NC; ++i) borrow = lop3<kGeStep>(rule.bits[j][i], cnt[i], borrow);
  born ^= rule.born[j] & ~borrow;
  keep ^= rule.keep[j] & ~borrow;
}

// The next state of the word `alive` from its window count.
template <int NC>
__device__ __forceinline__ uint32_t next_word(const uint32_t (&cnt)[NC],
                                              uint32_t alive, const Rule& rule) {
  uint32_t born = 0u, keep = 0u;
  if (rule.nbounds <= kFastBounds) {
    // entries past nbounds toggle nothing: cheaper than a branch on each
#pragma unroll
    for (int j = 0; j < kFastBounds; ++j) join(cnt, rule, j, born, keep);
  } else {
#pragma unroll 1
    for (int j = 0; j < rule.nbounds; ++j) join(cnt, rule, j, born, keep);
  }
  return mux(alive, keep, born);
}

// Adds the diamond's rows DY..R (windows of half-width R - |dy|) of the
// word at p into cnt.
template <int R, int NC, int DY>
__device__ __forceinline__ void diamond_rows(const uint32_t* p, int stride,
                                             uint32_t (&cnt)[NC]) {
  constexpr int A = R - (DY < 0 ? -DY : DY);
  uint32_t w[bit_length(2 * A + 1)];
  window<A>(p + DY * stride, w);
  add_into(cnt, w);
  if constexpr (DY < R) diamond_rows<R, NC, DY + 1>(p, stride, cnt);
}

// Writes an item's output rows one after another from its first row: to
// device memory in the last generation (the caller clipped the rows to
// the grid), else to the next buffer, zero outside the item's live rows.
struct Sink {
  uint32_t* dst;      // the current row's word in the next buffer
  uint32_t* out;      // the current row's word in device memory
  int stride, Wp;
  int live;           // the current row less the first live row
  unsigned span;      // live rows
  bool last;
  __device__ __forceinline__ void put(uint32_t v) {
    if (last) {
      *out = v;
      out += Wp;
    } else {
      *dst = (unsigned)live < span ? v : 0u;
      dst += stride;
      ++live;
    }
  }
};

// Rows [rs, re) of one column of the box: warm up on the 2r+1 rows around
// rs, then slide, one window sum per entering row (see the header).
template <int R>
__device__ __forceinline__ void box_segment(const uint32_t* col, int stride,
                                            int rs, int re, Sink& sink,
                                            const Rule& rule) {
  constexpr int P = 2 * R + 1;
  constexpr int NW = bit_length(P);
  constexpr int NC = bit_length(P * P);
  uint32_t ring[P][NW];
  uint32_t cnt[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) cnt[i] = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    window<R>(col + (rs - R + j) * stride, ring[j]);
    add_into(cnt, ring[j]);
  }
  const int n = re - rs;
  const uint32_t* centre = col + rs * stride;
  const uint32_t* enter = centre + (R + 1) * stride;
  for (int base = 0; base < n; base += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (base + j >= n) break;
      sink.put(next_word(cnt, *centre, rule));
      // row y+1+R enters the box and row y-R leaves it: the same slot.
      // After the segment's last row this reads at most one row past the
      // slab, which the allocation holds.
      uint32_t w[NW];
      window<R>(enter, w);
      centre += stride;
      enter += stride;
      add_into(cnt, w);
      sub_from(cnt, ring[j]);
#pragma unroll
      for (int b = 0; b < NW; ++b) ring[j][b] = w[b];
    }
  }
}

template <int R>
__device__ __forceinline__ void diamond_segment(const uint32_t* col, int stride,
                                                int rs, int re, Sink& sink,
                                                const Rule& rule) {
  constexpr int NC = bit_length(2 * R * (R + 1) + 1);
  for (int y = rs; y < re; ++y) {
    uint32_t cnt[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) cnt[i] = 0u;
    diamond_rows<R, NC, -R>(col + y * stride, stride, cnt);
    sink.put(next_word(cnt, col[y * stride], rule));
  }
}

template <int R>
constexpr int kMinBlocks = R >= 6 ? 1 : 2;

// Slab = false: the full grid (H rows, `dead` closes both axes). Slab =
// true: blockIdx.z is a band of H = He extended rows, `dead` closes the
// columns only, and `edge_code` (or edge_codes[blockIdx.z]) sets the dead
// band.
template <int R, bool Diamond, bool Slab>
__global__ void __launch_bounds__(kThreads, kMinBlocks<R>)
ltl_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint32_t smem[];
  const int H = a.H, Wp = a.Wp, gens = a.gens, th = a.th, tw = a.tw, hw = a.hw;
  const int hr = R * gens;
  const int L = th + 2 * hr;
  const int ww = tw + 2 * hw;   // words computed per row: tile + hw halo each side
  const int stride = ww + 2;    // plus a zero word at each end
  const int plane = L * stride;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int row0 = by * th - hr;  // grid row of slab row 0
  const int col0 = bx * tw - hw;  // grid word of slab word 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t* in = a.in;
  uint32_t* out = a.out;
  // the dead band of a slab: extended rows < top or >= bottom are zero
  // before every generation
  int top = -kFar, bottom = kFar;
  if constexpr (Slab) {
    in += (size_t)blockIdx.z * H * Wp;
    out += (size_t)blockIdx.z * H * Wp;
    const int code = a.edge_codes != nullptr ? a.edge_codes[blockIdx.z] : a.edge_code;
    if (code & 1) top = hr;
    if (code & 2) bottom = H - hr;
  }

  // Load: one warp per row, so a row's source index is reduced once; the
  // words are copied asynchronously, the zeros stored. A slab's rows
  // outside [0, H) and in its dead band read as zeros; the full grid's
  // wrap under TORUS.
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
    const uint32_t* src = in + (size_t)gr * Wp;
    uint32_t* row = smem + r * stride;
    for (int x = lane; x < stride; x += 32) {
      int gc = col0 + x - 1;
      bool word_in = row_in && x > 0 && x <= ww;
      if (word_in) {
        if (a.dead) {
          word_in = gc >= 0 && gc < Wp;
        } else if (gc < 0 || gc >= Wp) {
          gc %= Wp;
          if (gc < 0) gc += Wp;
        }
      }
      if (word_in) {
        copy_word(row + x, src + gc);
      } else {
        row[x] = 0u;
      }
      if (gens > 1 && (x == 0 || x > ww)) row[plane + x] = 0u;  // the other buffer's pads
    }
  }
  wait_copies();
  __syncthreads();

  for (int k = 0; k < gens; ++k) {
    const uint32_t* src = smem + (k & 1) * plane;
    uint32_t* dst = smem + ((k + 1) & 1) * plane;
    const bool last = k + 1 == gens;
    // output rows [lo, hi) and padded words [x0, x0 + ncols): the last
    // generation computes the tile only, clipped to the grid
    const int lo = R * (k + 1);
    int hi = L - R * (k + 1);
    if (last) hi = min(hi, H - row0);
    const int x0 = last ? hw + 1 : 1;
    const int ncols = last ? min(tw, Wp - bx * tw) : ww;
    const int rows = hi - lo;
    // live rows of the next buffer: a slab's dead band is zeroed before
    // every generation, so after every one but the last; the full grid's
    // rows outside it under DEAD
    int ya = lo, yb = hi;
    if (Slab) {
      ya = max(ya, top - row0);
      yb = min(yb, bottom - row0);
    } else if (a.dead) {
      ya = max(ya, -row0);
      yb = min(yb, H - row0);
    }
    // column segments: as many as fill the rounds that segments of at
    // most `seg` rows need, of nearly equal length
    int nseg = (rows + a.seg - 1) / a.seg;
    const int rounds = (nseg * ncols + kThreads - 1) / kThreads;
    nseg = min(rows, max(nseg, rounds * kThreads / ncols));
    const int sq = rows / nseg, srem = rows - sq * nseg;
    const int items = nseg * ncols;
    const int step_seg = kThreads / ncols, step_x = kThreads - step_seg * ncols;
    int s = threadIdx.x / ncols;
    int x = threadIdx.x - s * ncols;
    for (int item = threadIdx.x; item < items; item += kThreads) {
      const int rs = lo + s * sq + min(s, srem);
      const int re = rs + sq + (s < srem ? 1 : 0);
      const int px = x0 + x;   // the word's column in the padded rows
      const int gc = col0 + px - 1;
      Sink sink;
      sink.dst = dst + rs * stride + px;
      sink.out = out + (ptrdiff_t)(row0 + rs) * Wp + gc;
      sink.stride = stride;
      sink.Wp = Wp;
      sink.last = last;
      const bool col_out = a.dead && (gc < 0 || gc >= Wp);
      sink.live = rs - ya;
      sink.span = col_out || yb <= ya ? 0u : (unsigned)(yb - ya);
      if constexpr (Diamond) {
        diamond_segment<R>(src + px, stride, rs, re, sink, a.rule);
      } else {
        box_segment<R>(src + px, stride, rs, re, sink, a.rule);
      }
      x += step_x;
      s += step_seg;
      if (x >= ncols) {
        x -= ncols;
        ++s;
      }
    }
    if (!last) __syncthreads();
  }
}

template <int R>
int launch_radius(const Launch& l) {
  void (*kernel)(const Args);
  if (l.diamond) {
    kernel = l.slab ? ltl_kernel<R, true, true> : ltl_kernel<R, true, false>;
  } else {
    kernel = l.slab ? ltl_kernel<R, false, true> : ltl_kernel<R, false, false>;
  }
  Args a;
  a.in = (const uint32_t*)l.in;
  a.out = (uint32_t*)l.out;
  a.H = l.H;
  a.Wp = l.Wp;
  a.gens = l.gens;
  a.th = l.th;
  a.tw = l.tw;
  a.hw = l.hw;
  a.seg = l.seg;
  a.dead = l.dead;
  a.edge_code = l.edge_code;
  a.edge_codes = (const int*)l.edge_codes;
  a.rule = *l.rule;
  // one or two slabs, and a row for the box's last look-ahead
  const size_t smem = ((l.gens > 1 ? 2ull : 1ull) * (l.th + 2 * R * l.gens) + 1) *
                      (l.tw + 2 * l.hw + 2) * sizeof(uint32_t);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((l.Wp + l.tw - 1) / l.tw, (l.H + l.th - 1) / l.th, l.nbands);
  kernel<<<grid, kThreads, smem, (cudaStream_t)l.stream>>>(a);
  return (int)cudaGetLastError();
}

template int launch_radius<LTL_RADIUS>(const Launch&);

}  // namespace life_ltl

#else  // the unit of the C entry points

namespace {

using namespace life_ltl;

int launch(Launch l, int radius, int nbounds, const int* bounds,
           const int* born, const int* keep) {
  const int side = radius * radius * 4 + 4 * radius + 1;   // (2r+1)^2
  if (radius < 1 || radius > 7 || nbounds < 0 || nbounds > kMaxBounds ||
      l.gens < 1 || l.th < 1 || l.tw < 1 || l.seg < 1 ||
      32 * l.hw < radius * l.gens)
    return (int)cudaErrorInvalidValue;
  Rule rule = {};
  rule.nbounds = nbounds;
  for (int j = 0; j < nbounds; ++j) {
    if (bounds[j] < 0 || bounds[j] > side + 2) return (int)cudaErrorInvalidValue;
    rule.born[j] = born[j] ? ~0u : 0u;
    rule.keep[j] = keep[j] ? ~0u : 0u;
    for (int i = 0; i < kMaxPlanes; ++i)
      rule.bits[j][i] = (bounds[j] >> i) & 1 ? ~0u : 0u;
  }
  l.rule = &rule;
  switch (radius) {
    case 1: return launch_radius<1>(l);
    case 2: return launch_radius<2>(l);
    case 3: return launch_radius<3>(l);
    case 4: return launch_radius<4>(l);
    case 5: return launch_radius<5>(l);
    case 6: return launch_radius<6>(l);
    default: return launch_radius<7>(l);
  }
}

}  // namespace

extern "C" {

// Launches one call of `gens` generations from `in` to `out` (distinct
// (H, Wp) uint32 buffers) on `stream`, with `hw` halo words per side
// (32 * hw >= radius * gens) and column segments of at most `seg` rows.
// `bounds` holds the rule's `nbounds` distinct sorted interval boundaries
// (lo, hi+1 of every interval of both sets), `born`/`keep` whether each
// toggles the birth/survival set. Returns the CUDA error code of the
// launch (0 on success), or cudaErrorInvalidValue for a rule or geometry
// the kernel does not take.
int life_ltl_launch(const void* in, void* out, int H, int Wp, int gens, int th,
                    int tw, int hw, int seg, int radius, int diamond,
                    int nbounds, const int* bounds,
                    const int* born, const int* keep, int dead, void* stream) {
  Launch l = {in, out, 1, H, Wp, gens, th, tw, hw, seg, diamond, 0, dead,
              0, nullptr, stream, nullptr};
  return launch(l, radius, nbounds, bounds, born, keep);
}

// Launches one slab-mode call of `gens` generations from `in` to `out`
// (distinct (nbands, He, Wp) uint32 batches) on `stream`; `dead_cols`
// closes the columns, `edge_codes` (a device array of nbands int32 codes,
// or null for `edge_code` on every band) the rows. Returns as
// life_ltl_launch does.
int life_ltl_slab_launch(const void* in, void* out, int nbands, int He, int Wp,
                         int gens, int th, int tw, int hw, int seg, int radius,
                         int diamond, int nbounds,
                         const int* bounds, const int* born, const int* keep,
                         int dead_cols, int edge_code, const void* edge_codes,
                         void* stream) {
  Launch l = {in, out, nbands, He, Wp, gens, th, tw, hw, seg, diamond, 1,
              dead_cols, edge_code, edge_codes, stream, nullptr};
  return launch(l, radius, nbounds, bounds, born, keep);
}

const char* life_ltl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // LTL_RADIUS
