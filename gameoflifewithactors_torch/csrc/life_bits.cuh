// Bitwise helpers shared by the bit-sliced kernels (life_ltl.cu, B4, and
// life_generations.cu, B3).

#pragma once

#include <stdint.h>

namespace life {

// One LOP3 of truth table Lut over (a, b, c) = (0xf0, 0xcc, 0xaa): left to
// itself the compiler splits some three-input functions into two or three.
template <int Lut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(Lut));
  return d;
#else
  uint32_t d = 0u;
  for (int k = 0; k < 8; ++k) {
    if ((Lut >> k) & 1)
      d |= (k & 4 ? a : ~a) & (k & 2 ? b : ~b) & (k & 1 ? c : ~c);
  }
  return d;
#endif
}

constexpr int kXor3 = 0x96;     // a ^ b ^ c
constexpr int kMajority = 0xe8; // the carry of a + b + c
constexpr int kBorrow = 0x8e;   // the borrow out of a - b - c
constexpr int kGeStep = 0xb2;   // a ? ~b | c : ~b & c (a borrow step of b - mask a)

}  // namespace life
