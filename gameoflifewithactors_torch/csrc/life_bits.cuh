// Bitwise helpers shared by the bit-sliced kernels (life_packed.cu and
// life_slab.cu, B1 and B2; life_generations.cu, B3; life_ltl.cu, B4).

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
constexpr int kNotBothXnor = 0x09;  // ~a & ~(b ^ c)
constexpr int kAndXnor = 0x90;      // a & ~(b ^ c)
constexpr int kOrAnd = 0xf8;        // a | (b & c)
constexpr int kXorAnd = 0x78;       // a ^ (b & c)
constexpr int kAnd3 = 0x80;         // a & b & c
constexpr int kMux = 0xca;          // a ? b : c
constexpr int kXorOrNot = 0x7d;     // (a ^ b) | ~c

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

}  // namespace life
