// The helpers a generated flux functor (ops/flux_gen.py) is written in:
// loads and stores of a field in its storage type, the float32 <->
// bfloat16 rounding, exact constants from their bits, and the maximum /
// minimum of PyTorch (a NaN operand gives NaN). Host and device code
// alike, so that a functor compiles with nvcc for the card and with a
// host C++ compiler for the CPU tests (-ffp-contract=off there, as
// --fmad=false here keeps a * b + c two roundings).

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#define DCCRG_HD __host__ __device__ __forceinline__
#else
#define DCCRG_HD inline
#endif

namespace flux_rt {

DCCRG_HD float bits_f(unsigned u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

DCCRG_HD unsigned f_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(f);
#else
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

// float32 -> bfloat16 bits, round to nearest even (c10's
// round_to_nearest_even on the host, the card's own conversion there)
DCCRG_HD unsigned short bf_bits(float f) {
#if defined(__CUDA_ARCH__)
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
#else
  if (f != f) return 0x7fc0;
  const unsigned u = f_bits(f);
  return (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
#endif
}

// a float32 value rounded to bfloat16 and widened back. On the card by
// the packed conversion (F2FP, two values an instruction, here the same
// one twice): the single one (F2F) issues on the unit that runs
// MUFU.EX2 at 16 a clock an SM and held a bfloat16 exp kernel's pace;
// both round to nearest even
DCCRG_HD float rbf(float f) {
#if defined(__CUDA_ARCH__)
  return __low2float(__floats2bfloat162_rn(f, f));
#else
  return bits_f((unsigned)bf_bits(f) << 16);
#endif
}

DCCRG_HD float ld_f32(const void* p, long long i) {
  return static_cast<const float*>(p)[i];
}
DCCRG_HD float ld_bf16(const void* p, long long i) {
  return bits_f((unsigned)static_cast<const unsigned short*>(p)[i] << 16);
}
DCCRG_HD void st_f32(void* p, long long i, float v) {
  static_cast<float*>(p)[i] = v;
}
// v is already a bfloat16 value: its top 16 bits
DCCRG_HD void st_bf16(void* p, long long i, float v) {
  static_cast<unsigned short*>(p)[i] = (unsigned short)(f_bits(v) >> 16);
}

DCCRG_HD float gmax(float a, float b) {
  return (a != a || b != b) ? bits_f(0x7fc00000u) : (a > b ? a : b);
}
DCCRG_HD float gmin(float a, float b) {
  return (a != a || b != b) ? bits_f(0x7fc00000u) : (a < b ? a : b);
}

}  // namespace flux_rt
