// 7-point Laplacian matvec of the Poisson solvers: Ap = sum over the
// three axes of rdd2 * ((p[lo] - p) + (p[hi] - p)).
//
// Replaces the Pallas kernel `make_laplacian_matvec`
// (dccrg_tpu/ops/poisson_kernel.py:43). p is [X, Y, Z] with Z
// contiguous. Periodic axes wrap; on a non-periodic edge the missing
// neighbour's term is exactly 0 (homogeneous Neumann). The TPU kernel
// streams (tx, Y, Z) x-bricks through VMEM with one-row x halos by DMA
// and builds the y/z neighbours by in-VMEM concatenation; a (tx, 256,
// 256) brick is 2 MB, far past a block's 227 KB of shared memory, so
// nothing of that tiling carries over. Here threads run along the
// contiguous z axis (a warp reads one 128-byte run per row), each
// thread owns one (y, z) column and marches along a chunk of x keeping
// p[x - 1], p[x], p[x + 1] in registers, and the y and z neighbours are
// read through the read-only cache (__ldg): a z neighbour lies in the
// same run as the warp's own loads, a y neighbour in a row that the
// neighbouring threadIdx.y rows of the block read too, so both are
// L1/L2 hits and device memory sees p about once. Wraps and Neumann
// edges are exact index arithmetic.
//
// Arithmetic in the reference's order (poisson_kernel.py:110-147):
// acc = 0; per axis x, y, z: t_lo = p[lo] - p, t_hi = p[hi] - p (0 on a
// non-periodic edge), acc = acc + rdd2 * (t_lo + t_hi). rdd2 arrives
// rounded to the storage type. In bfloat16 every operation is rounded
// to bfloat16, as the reference computes in its dtype (float32 math
// rounded after each +, -, * is the same); float32 is built with
// --fmad=false, so both agree with the plain PyTorch version bit for
// bit.
//
// Bound on the H100: bytes. One matvec at 256^3, float32, reads p once
// and writes Ap once: 2 * 2^24 * 4 B = 134 MB, 40.1 us at 3.35 TB/s;
// 12 float ops per cell (3.0 us at 67 TFLOP/s).
//
// C entry point: dccrg_laplacian_matvec(); returns cudaGetLastError()
// of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTz = 32;  // threads along z: one warp per row run
constexpr int kTy = 8;   // rows of y per block
constexpr int kXc = 16;  // x cells a thread marches over

template <typename T> struct Store;
template <> struct Store<float> {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float pack(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 pack(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// acc + rdd2 * (t_lo + t_hi), each operation rounded to the storage type
template <typename T>
__device__ __forceinline__ float axis_term(float acc, float rdd2, float tlo,
                                          float thi) {
  using S = Store<T>;
  return S::rnd(acc + S::rnd(rdd2 * S::rnd(tlo + thi)));
}

template <typename T>
__global__ void __launch_bounds__(kTz * kTy)
laplacian_kernel(const T* __restrict__ p, T* __restrict__ out, const int X,
                 const int Y, const int Z, const float rdx2,
                 const float rdy2, const float rdz2, const int px,
                 const int py, const int pz) {
  using S = Store<T>;
  const int z = blockIdx.x * kTz + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (z >= Z || y >= Y) return;
  const int x0 = blockIdx.z * kXc;
  const int x1 = min(x0 + kXc, X);

  const long long sx = (long long)Y * Z;  // x stride
  const long long col = (long long)y * Z + z;
  // y and z neighbours of this column: wrapped offsets and presence
  const bool has_ym = py || y > 0, has_yp = py || y < Y - 1;
  const bool has_zm = pz || z > 0, has_zp = pz || z < Z - 1;
  const long long cym = (long long)(y == 0 ? Y - 1 : y - 1) * Z + z;
  const long long cyp = (long long)(y == Y - 1 ? 0 : y + 1) * Z + z;
  const long long czm = (long long)y * Z + (z == 0 ? Z - 1 : z - 1);
  const long long czp = (long long)y * Z + (z == Z - 1 ? 0 : z + 1);

  const int xm0 = x0 == 0 ? X - 1 : x0 - 1;
  float pm = S::ld(p + xm0 * sx + col);
  float pc = S::ld(p + x0 * sx + col);
  for (int x = x0; x < x1; ++x) {
    const long long b = x * sx;
    const int xp = x == X - 1 ? 0 : x + 1;
    const float pp = S::ld(p + xp * sx + col);
    float acc = 0.f;
    float tlo = (px || x > 0) ? S::rnd(pm - pc) : 0.f;
    float thi = (px || x < X - 1) ? S::rnd(pp - pc) : 0.f;
    acc = axis_term<T>(acc, rdx2, tlo, thi);
    tlo = has_ym ? S::rnd(S::ld(p + b + cym) - pc) : 0.f;
    thi = has_yp ? S::rnd(S::ld(p + b + cyp) - pc) : 0.f;
    acc = axis_term<T>(acc, rdy2, tlo, thi);
    tlo = has_zm ? S::rnd(S::ld(p + b + czm) - pc) : 0.f;
    thi = has_zp ? S::rnd(S::ld(p + b + czp) - pc) : 0.f;
    acc = axis_term<T>(acc, rdz2, tlo, thi);
    out[b + col] = S::pack(acc);
    pm = pc;
    pc = pp;
  }
}

template <typename T>
int launch(const void* p, void* out, int X, int Y, int Z, float rdx2,
           float rdy2, float rdz2, int px, int py, int pz, int device,
           void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Z + kTz - 1) / kTz, (Y + kTy - 1) / kTy,
                  (X + kXc - 1) / kXc);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  laplacian_kernel<T><<<grid, dim3(kTz, kTy), 0, (cudaStream_t)stream>>>(
      (const T*)p, (T*)out, X, Y, Z, rdx2, rdy2, rdz2, px, py, pz);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (p and out alike). rdx2, rdy2, rdz2:
// 1 / cell_length**2 per axis, rounded to the storage type. px, py, pz:
// 1 where the axis is periodic.
extern "C" int dccrg_laplacian_matvec(int dtype, const void* p, void* out,
                                      int X, int Y, int Z, float rdx2,
                                      float rdy2, float rdz2, int px, int py,
                                      int pz, int device, void* stream) {
  if (dtype == 0)
    return launch<float>(p, out, X, Y, Z, rdx2, rdy2, rdz2, px, py, pz,
                         device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, out, X, Y, Z, rdx2, rdy2, rdz2, px, py,
                                 pz, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_laplacian_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
