// The per-word arithmetic of a binary 3x3 B/S generation on packed words,
// shared by the full-grid kernel (life_packed.cu, B1) and the row-band
// kernel (life_slab.cu, B2). Bit i of a word is the cell 32*j + i of its
// row; this is what ops/packed.py computes with whole tensors.
//
// - Per word: west/east neighbour planes by funnel shift, the horizontal
//   2-bit sums T = w+c+e and S = w+e, and the count T_north + S + T_south
//   in four bit-planes (ops/packed.py::_row_sum_bits).
// - The rule is two runtime 9-bit masks (born, survive), turned once per
//   thread into all-ones/all-zero table words and looked up bit-sliced: a
//   mux tree over the count bit-planes and the alive plane (17 LOP3s per
//   word, no branches). It computes what ops/packed.py::apply_rule_planes
//   does, and one build serves every B/S rule, B0 rules included. B3
//   (life_generations.cu) takes the same lookup for rules with many counts.

#pragma once

#include <stdint.h>

namespace life {

// (sel & hi) | (~sel & lo): one LOP3.
__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t hi, uint32_t lo) {
  return (sel & hi) | (~sel & lo);
}

// Horizontal sums of the row word at `p` (p[-1] and p[1] are its
// neighbours; rows carry a zero word at each end).
__device__ __forceinline__ void row_sums(const uint32_t* p, uint32_t& c,
                                         uint32_t& t0, uint32_t& t1,
                                         uint32_t& s0, uint32_t& s1) {
  c = p[0];
  const uint32_t w = __funnelshift_l(p[-1], c, 1);  // (c << 1) | (left >> 31)
  const uint32_t e = __funnelshift_r(c, p[1], 1);   // (c >> 1) | (right << 31)
  const uint32_t wc = w ^ c;
  t0 = wc ^ e;                 // T = w + c + e, low bit
  t1 = (w & c) | (e & wc);     // T, high bit
  s0 = w ^ e;                  // S = w + e
  s1 = w & e;
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

// Next state of the 32 cells of `alive` from the north/south T sums and
// the centre row's S sum: the count T_n + S + T_s in four bit-planes, then
// the rule table looked up bit-sliced (lookup), the same for every rule.
__device__ __forceinline__ uint32_t next_word(uint32_t alive, uint32_t tn0,
                                              uint32_t tn1, uint32_t s0,
                                              uint32_t s1, uint32_t ts0,
                                              uint32_t ts1, const RuleMasks& m) {
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
  return lookup(alive, r0, r1, r2, r3, m);
}

}  // namespace life
