// Device fluxes of the bulk executor: the compile-time functors that
// kernel A (bulk_pass.cu, bulk_pass_k.cu) and kernel A' (fleet_bulk_pass.cu)
// instantiate, one per SlotwiseKernel twin the port knows by name
// (ops/roll_executor.py DEVICE_FLUXES, the same codes).
//
// A flux states:
// - its fields: kFields staged per cell, field 0 the carried one (read
//   at the neighbours and written), the rest static over a pass and
//   read at the neighbours too (the upwind flux's vx, vy);
// - which slots it reads: the slot tables are built on the host in the
//   neighbourhood's order (hood.offs_const) from the same predicate
//   (ops/roll_executor.py _flux_slots), each entry (ox, oy, oz, code);
//   a slot a flux never reads adds an exact +0.0 to a sum that starts
//   at +0.0 and so is never -0.0, which changes no bit, so the tables
//   leave it out. `reads` / `reads_column` say the same on the 3x3x3
//   cube for kernel A''s unrolled routes;
// - `add`: one read slot's term added to the carry, a masked slot
//   adding +0.0;
// - `finish`: the new value of field 0 from the cell and the carry, in
//   float32, rounded to the storage type by the caller.
// The arithmetic follows the plain twins' order of operations
// (dccrg_tpu_torch/fleet.py _make_diffuse_slotwise /
// _make_advect_x_slotwise, models/advection.py make_uniform_flux_kernel):
// the single-field twins round every term and every partial sum to the
// storage type, as PyTorch's bfloat16 arithmetic rounds them, and finish
// in float32 (`--fmad=false` keeps a * b + c two roundings).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace fluxes {

template <typename T> struct Store;
template <> struct Store<float> {
  using Bits = unsigned;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float pack(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  using Bits = unsigned short;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 pack(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Store<T>::load(Store<T>::pack(v));
}

// A flux's per-launch constants: the upwind flux's dt/dx and dt/dy; the
// single-field twins' dt (diffuse) or cfl (advect_x) in `a`.
struct Coef {
  float a, b;
};

// One dimension's face term of one upwind slot whose face sign f is +1
// or -1 (models/advection.py:118-125, face_term of the one-step kernel):
// acc - (valid ? up * m : 0) for f = +1 is acc + (valid ? up * m' : 0)
// with m' = v * (-c) = -m exactly, and acc + 0 for f = -1 is acc (the
// sum is never -0.0), so face_term's two selected terms become one with
// the same bits; f = 0 (no face) takes valid false. rn and vn may hold
// anything where !valid.
__device__ __forceinline__ float face(float acc, float rc, float rn,
                                      float vc, float vn, float c,
                                      bool valid, int f) {
  const float v = 0.5f * (vc + vn);
  const float up = (v >= 0.f) == (f > 0) ? rc : rn;
  const float m = v * (f > 0 ? -c : c);
  return acc + (valid ? up * m : 0.f);
}

// fleet.py _make_diffuse_slotwise: acc + where(mask, nbr - c, 0);
// out = c + dt * acc. Reads every slot.
struct Diffuse {
  static constexpr int kCode = 0;
  static constexpr int kFields = 1;
  // whether slot (dx, dy, dz) of the cube (each 0, 1, 2 for -1, 0, +1)
  // is read
  static __device__ __forceinline__ constexpr bool reads(int, int, int) {
    return true;
  }
  // whether column (dx, dy) of the cube is read in any plane
  static __device__ __forceinline__ constexpr bool reads_column(int, int) {
    return true;
  }
  template <typename T>
  static __device__ __forceinline__ float term(float c, float n) {
    return round_to<T>(n - c);
  }
  static __device__ __forceinline__ float finish(float c, float acc,
                                                 float p) {
    return c + p * acc;
  }
  template <typename T>
  static __device__ __forceinline__ float add(float acc, const float (&c)[1],
                                              const float (&n)[1], bool valid,
                                              int, Coef) {
    return round_to<T>(acc + (valid ? term<T>(c[0], n[0]) : 0.f));
  }
  template <typename T>
  static __device__ __forceinline__ float finish(const float (&c)[1],
                                                 float acc, Coef k) {
    return finish(c[0], acc, k.a);
  }
};

// fleet.py _make_advect_x_slotwise: acc + where(up & mask, nbr, 0) with
// up the slots whose offset has x < 0, y == 0, z == 0 (one on the cube,
// two at length 2); out = (1 - cfl) * c + cfl * acc.
struct AdvectX {
  static constexpr int kCode = 1;
  static constexpr int kFields = 1;
  static __device__ __forceinline__ constexpr bool reads(int dx, int dy,
                                                         int dz) {
    return dx == 0 && dy == 1 && dz == 1;
  }
  static __device__ __forceinline__ constexpr bool reads_column(int dx,
                                                                int dy) {
    return dx == 0 && dy == 1;
  }
  template <typename T>
  static __device__ __forceinline__ float term(float, float n) {
    return n;
  }
  static __device__ __forceinline__ float finish(float c, float acc,
                                                 float p) {
    return (1.f - p) * c + p * acc;
  }
  template <typename T>
  static __device__ __forceinline__ float add(float acc, const float (&)[1],
                                              const float (&n)[1], bool valid,
                                              int, Coef) {
    return round_to<T>(acc + (valid ? n[0] : 0.f));
  }
  template <typename T>
  static __device__ __forceinline__ float finish(const float (&c)[1],
                                                 float acc, Coef k) {
    return finish(c[0], acc, k.a);
  }
};

// models/advection.py make_uniform_flux_kernel: the upwind flux over
// density, vx, vy; per slot the x face then the y face, each through
// `face`; the sum in float32, out = rc + acc. Reads the slots with an
// x or y face (offset exactly +-1 in x or y); a slot's code is
// (fx + 1) | (fy + 1) << 2.
struct UpwindXY {
  static constexpr int kCode = 2;
  static constexpr int kFields = 3;
  template <typename T>
  static __device__ __forceinline__ float add(float acc, const float (&c)[3],
                                              const float (&n)[3], bool valid,
                                              int code, Coef k) {
    const int fx = (code & 3) - 1, fy = (code >> 2) - 1;
    acc = face(acc, c[0], n[0], c[1], n[1], k.a, valid && fx, fx);
    acc = face(acc, c[0], n[0], c[2], n[2], k.b, valid && fy, fy);
    return acc;
  }
  template <typename T>
  static __device__ __forceinline__ float finish(const float (&c)[3],
                                                 float acc, Coef) {
    return c[0] + acc;
  }
};

// Wrap a coordinate into [0, n) on a periodic axis (any number of times
// around); false when it lies outside a non-periodic one.
__device__ __forceinline__ bool wrap(int& c, int n, int periodic) {
  if (c >= 0 && c < n) return true;
  if (!periodic) return false;
  c %= n;
  if (c < 0) c += n;
  return true;
}

}  // namespace fluxes
