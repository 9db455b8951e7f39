// The rule lookup of the 3x3 count kernels, shared by B1 and B2
// (life_packed_body.cuh: life_packed.cu and life_slab.cu) and B3
// (life_generations.cu). A rule is two runtime 9-bit masks (born,
// survive), so one build serves every rule; the lookup is sized to it:
//
// - the equality path, for a rule whose born and survive sets together
//   name K = 1..4 counts, all in 1..7 (rule_path): each count's equality
//   plane is three LOP3 over the count's three low bit-planes against
//   all-ones/all-zero masks of its bits (count 8 has low bits 000 and
//   matches none of them), and joins the birth and survival planes;
// - the table, for every other rule (count 0 or 8 named, more than four
//   counts, or none): the 9-entry tables of both sets looked up
//   bit-sliced, a mux tree over the count bit-planes and the alive plane
//   (17 LOP3), the same for every rule, B0 rules included.
//
// cuda_stencil._generations_rule_encoding makes the same choice;
// ops/packed.py::encoded_next_plane and
// ops/packed_generations.py::encoded_rule_planes are the plain twins.

#pragma once

#include <stdint.h>

#include "life_bits.cuh"

namespace life {

constexpr int kMaxEntries = 4;   // counts the equality path tests

// The rule path: K = 1..4 for a rule whose born and survive sets together
// name K counts, all in 1..7 (the equality path), else 0 (the table).
inline int rule_path(unsigned born, unsigned survive) {
  const unsigned counts = (born | survive) & 0x1ffu;
  const int n = __builtin_popcount(counts);
  return (counts & 0x101u) || n == 0 || n > kMaxEntries ? 0 : n;
}

// (sel & hi) | (~sel & lo): one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t hi, uint32_t lo) {
  return (sel & hi) | (~sel & lo);
}

// The rule as all-ones/all-zero masks: t[8*alive + count] for counts 0..7,
// and the count-8 entries.
struct RuleMasks {
  uint32_t t[16];
  uint32_t born8, keep8;
};

__device__ __forceinline__ RuleMasks rule_masks(unsigned born, unsigned survive) {
  RuleMasks m;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    m.t[c] = 0u - ((born >> c) & 1u);
    m.t[8 + c] = 0u - ((survive >> c) & 1u);
  }
  m.born8 = 0u - ((born >> 8) & 1u);
  m.keep8 = 0u - ((survive >> 8) & 1u);
  return m;
}

// The rule table looked up bit-sliced at the count r0..r3 (r3 set only
// for count 8, where r0 = r1 = r2 = 0): a mux tree over the count bits
// and the alive plane, all-ones where the cell is born (alive clear) or
// survives (alive set). 17 LOP3s, the same for every rule.
__device__ __forceinline__ uint32_t lookup(uint32_t alive, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3, const RuleMasks& m) {
  uint32_t l1[8], l2[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) l1[i] = mux(r0, m.t[2 * i + 1], m.t[2 * i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) l2[i] = mux(r1, l1[2 * i + 1], l1[2 * i]);
  const uint32_t dead_next = mux(r2, l2[1], l2[0]);
  const uint32_t live_next = mux(r2, l2[3], l2[2]);
  const uint32_t low = mux(alive, live_next, dead_next);
  return mux(r3, mux(alive, m.keep8, m.born8), low);
}

// The rule on the equality path: for each of the K counts, the
// all-ones/all-zero masks of its three bits and whether it is a birth
// and a survival count.
template <int K>
struct Rule {
  uint32_t n0[K], n1[K], n2[K];
  uint32_t born[K], keep[K];
};

// The table path: the 9-entry tables.
template <>
struct Rule<0> {
  RuleMasks table;
};

template <int K>
__device__ __forceinline__ Rule<K> make_rule(unsigned born, unsigned survive) {
  Rule<K> r;
  if constexpr (K == 0) {
    r.table = rule_masks(born, survive);
  } else {
    unsigned rest = (born | survive) & 0xfeu;   // counts 1..7, ascending
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int n = __ffs(rest) - 1;
      rest &= rest - 1u;
      r.n0[i] = 0u - (unsigned)(n & 1);
      r.n1[i] = 0u - (unsigned)((n >> 1) & 1);
      r.n2[i] = 0u - (unsigned)((n >> 2) & 1);
      r.born[i] = 0u - ((born >> n) & 1u);
      r.keep[i] = 0u - ((survive >> n) & 1u);
    }
  }
  return r;
}

// The birth and survival planes at the count r0..r3 (r3 set only for
// count 8), as B3's transition takes them: the equality path joins its
// counts' planes; the table path gives one plane, birth where the cell is
// not alive and survival where it is, which the transition may take for
// both.
template <int K>
__device__ __forceinline__ void rule_planes(const Rule<K>& rule, uint32_t alive,
                                            uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3,
                                            uint32_t& born, uint32_t& keep) {
  if constexpr (K == 0) {
    born = keep = lookup(alive, r0, r1, r2, r3, rule.table);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t eq = lop3<kAndXnor>(
          lop3<kNotBothXnor>(r0 ^ rule.n0[i], r1, rule.n1[i]), r2, rule.n2[i]);
      if (i == 0) {
        born = eq & rule.born[0];
        keep = eq & rule.keep[0];
      } else {
        born = lop3<kOrAnd>(born, eq, rule.born[i]);
        keep = lop3<kOrAnd>(keep, eq, rule.keep[i]);
      }
    }
  }
}

// The next alive plane of a binary B/S rule at the count r0..r3 (r3 read
// on the table path only): on the equality path, for each count, the
// cell's own entry (the survival mask where it is alive, the birth mask
// where it is not; one LOP3) folded into the count's equality plane,
// four LOP3 a count and one OR per further count -- B3/S23 costs 9.
template <int K>
__device__ __forceinline__ uint32_t next_alive(const Rule<K>& rule, uint32_t alive,
                                               uint32_t r0, uint32_t r1,
                                               uint32_t r2, uint32_t r3) {
  if constexpr (K == 0) {
    return lookup(alive, r0, r1, r2, r3, rule.table);
  } else {
    uint32_t next = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const uint32_t entry = lop3<kMux>(alive, rule.keep[i], rule.born[i]);
      // all-ones where the count is n and the cell's entry for n is set
      const uint32_t hit = lop3<kAndXnor>(
          lop3<kNotBothXnor>(lop3<kXorOrNot>(r0, rule.n0[i], entry), r1,
                             rule.n1[i]),
          r2, rule.n2[i]);
      next = i == 0 ? hit : next | hit;
    }
    return next;
  }
}

}  // namespace life
