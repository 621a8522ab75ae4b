// Rotation-advection step: `spp` upwind steps of the benchmark's
// separable solid-body rotation field per HBM pass.
//
// Replaces the Pallas kernel `make_rotation_step`
// (dccrg_tpu/ops/advection_kernel.py:40). rho is [X, Y, Z] with Z
// contiguous; the field is periodic in x and y and has no flux in z, so
// every z column is independent.
//
// A 2.5-D temporal pipeline that streams along x. A block owns a band of
// `by` output rows of y and a chunk of `tz` z-columns, and marches the
// whole periodic x extent once: X + 2*spp planes of x (the spp-wide
// halo on each side; rounded up to whole chunks of advances, below),
// each read from device memory once. Thread
// (zt, j) = (threadIdx.x, threadIdx.y) owns row j of the band widened
// by spp rows on each side (W = by + 2*spp rows) and the two z-columns
// 2*zt and 2*zt + 1 (two independent chains per thread, and 8-byte
// shared-memory accesses); the tz / 2 threads along z make each warp's
// loads and stores contiguous runs. At each advance t the thread takes
// plane t of rho (level 0), and sub-step level s = 1..spp computes plane
// t - s from level s-1's planes t-s-1, t-s and t-s+1:
//  - the x-neighbours are level s-1's last three planes, kept in the
//    thread's registers (the advance loop is unrolled by three, so the
//    windows rotate by renaming);
//  - the y-neighbours are rows j-1 and j+1 of level s-1's plane t-s,
//    which every level writes into a shared-memory plane when it
//    computes it; the planes are double-buffered by the parity of t, so
//    one __syncthreads per advance orders all levels' exchanges.
// Level s is computed on rows [s, W - s), so the y halo shrinks by one
// row per level and there is no x halo at all: at by = 64, spp = 7 the
// pass computes 1.09x the cell-updates it writes. The next planes of
// rho are loaded a few advances ahead into registers, so the device
// reads overlap the sub-steps. The folded face velocities are computed
// once per block: vx of the thread's row (it depends on y only) in a
// register, vy (it depends on x only) in a shared-memory ring of 128
// planes. The advances run in chunks of 48 (a whole number of the
// three-way unroll, so the chunk loop has no remainder code; advances
// past the end compute planes that are not written), and at the start
// of each chunk the block folds the vy of the planes the next chunk
// reads.
// Extents of any size work: a row or plane index beyond the grid wraps
// as often as it must, and z-columns beyond Z are neither read nor
// written.
//
// Arithmetic as advection_kernel.py:121-151: dt*rdx and dt*rdy are
// folded into the face velocities in float32 and rounded to the storage
// type; per sub-step rc + v*where(v >= 0, r_m - rc, rc - r_p) along x,
// then along y. In bfloat16 every operation is rounded to bfloat16,
// as the reference computes in the storage type; float32 is built with
// --fmad=false, so both agree with the plain PyTorch version bit for
// bit.
//
// Bound on the H100: bytes. One pass at 512^3, float32: 2 * 2^27 * 4 B =
// 1.07 GB, 0.32 ms at 3.35 TB/s; 10 float ops per cell-update (0.14 ms
// at 67 TFLOP/s for spp = 7).
//
// C entry point: dccrg_rotation_step(); returns cudaGetLastError() of
// the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90
constexpr int kPrefetch = 3;         // planes of rho loaded ahead
constexpr int kChunk = 48;           // x advances per chunk
constexpr int kRing = 128;           // planes of folded vy in the ring

template <typename T> struct Store;
template <> struct Store<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float pack(float v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 pack(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Store<T>::load(Store<T>::pack(v));
}

// c mod n for a coordinate that usually lies in [0, n) already.
__device__ __forceinline__ int wrap(int c, int n) {
  if (c >= 0 && c < n) return c;
  c %= n;
  return c < 0 ? c + n : c;
}

// One upwind sub-step of one cell (advection_kernel.py:121-151).
template <typename T>
__device__ __forceinline__ float sub_step(float rm, float rc, float rp,
                                          float ym, float yp, float cx,
                                          float cy) {
  const float dxt = rnd<T>(cx * (cx >= 0.f ? rnd<T>(rm - rc)
                                            : rnd<T>(rc - rp)));
  const float dyt = rnd<T>(cy * (cy >= 0.f ? rnd<T>(ym - rc)
                                            : rnd<T>(rc - yp)));
  return rnd<T>(rnd<T>(rc + dxt) + dyt);
}

// TZ z-columns per block, two per thread (threadIdx.x < TZ / 2).
template <typename T, int S, int TZ>
__global__ void __launch_bounds__(1024)
rotation_stream(const T* __restrict__ rho, const T* __restrict__ vxf,
                const T* __restrict__ vyf, T* __restrict__ out, const int X,
                const int Y, const int Z, const int by, const int nbz,
                const float cdx, const float cdy) {
  constexpr int TX = TZ / 2;  // threads along z
  constexpr int RS = S * TX;  // float2 of one row's level planes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.y;  // W = by + 2 * S
  const int zt = threadIdx.x, j = threadIdx.y;
  // At a chunk's start the ring holds the planes this chunk reads, the
  // last advance may still read planes of the chunk before, and the
  // planes of the next chunk are written: 2 * kChunk + 1 planes at most.
  static_assert(2 * kChunk + 1 <= kRing && kChunk % 3 == 0, "vy ring");
  // [2][W][S][TX] float2: level planes by parity of the advance, then
  // the folded vy of plane p at cyr[p & (kRing - 1)] and again kRing
  // further on, so that level s reads it at a constant offset -s from
  // the advance's base
  float2* lvl = reinterpret_cast<float2*>(smem_raw);
  float* cyr = reinterpret_cast<float*>(lvl + 2 * W * RS);
  float2* const mine = lvl + j * RS + zt;
  const int parity_stride = W * RS;

  const int bz = blockIdx.x % nbz, bj = blockIdx.x / nbz;
  const int y0 = bj * by;  // the band's first output row
  const int gz = bz * TZ + 2 * zt;
  const bool zin0 = gz < Z, zin1 = gz + 1 < Z;
  const int gy = wrap(y0 + j - S, Y);
  const float cx = rnd<T>(Store<T>::load(vxf[gy]) * cdx);
  // folded vy of planes p0 .. p0 + kChunk - 1; vy_face carries an 8-row
  // wrap margin: index x + 8 holds vy[x]
  auto fill = [&](int p0) {
    for (int k = j * TX + zt; k < kChunk; k += W * TX) {
      const float c = rnd<T>(Store<T>::load(vyf[wrap(p0 + k, X) + 8]) * cdy);
      cyr[(p0 + k) & (kRing - 1)] = c;
      cyr[((p0 + k) & (kRing - 1)) + kRing] = c;
    }
  };
  fill(-2 * S);  // the planes the first chunk reads

  const long long xs = (long long)Y * Z;
  const T* src = rho + (long long)gy * Z + gz;
  T* dst = out + (long long)gy * Z + gz;
  bool act[S + 1];
#pragma unroll
  for (int s = 1; s <= S; ++s) act[s] = j >= s && j < W - s;
  const bool writes = j >= S && j < S + by && y0 + j - S < Y;

  auto load = [&](int x) {
    const T* p = src + wrap(x, X) * xs;
    return make_float2(zin0 ? Store<T>::load(p[0]) : 0.f,
                       zin1 ? Store<T>::load(p[1]) : 0.f);
  };
  float2 pf[kPrefetch];
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p) pf[p] = load(p - S);
  float2 a[S][3];  // level s's last three planes (registers)
#pragma unroll
  for (int s = 0; s < S; ++s)
    a[s][0] = a[s][1] = a[s][2] = make_float2(0.f, 0.f);

  for (int t0 = -S; t0 < X + S; t0 += kChunk) {
    fill(t0 + kChunk - S);  // the planes the next chunk reads
    // unrolled by the windows' length, so their shifts become renames
#pragma unroll 3
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      const float2 v0 = pf[0];
#pragma unroll
      for (int p = 0; p + 1 < kPrefetch; ++p) pf[p] = pf[p + 1];
      pf[kPrefetch - 1] = load(t + kPrefetch);
      __syncthreads();  // the last advance's level planes are written
      const int cur = (t + S) & 1;
      const float2* rb = mine + cur * parity_stride;
      float2* wb = mine + (cur ^ 1) * parity_stride;
      const float* cyp = cyr + (t & (kRing - 1)) + kRing;
      a[0][0] = a[0][1];
      a[0][1] = a[0][2];
      a[0][2] = v0;
      wb[0] = v0;
#pragma unroll
      for (int s = 1; s <= S; ++s) {
        float2 r = make_float2(0.f, 0.f);
        if (act[s]) {
          const float2 rm = a[s - 1][0], rc = a[s - 1][1], rp = a[s - 1][2];
          const float2 ym = rb[(s - 1) * TX - RS], yp = rb[(s - 1) * TX + RS];
          const float cy = cyp[-s];
          r.x = sub_step<T>(rm.x, rc.x, rp.x, ym.x, yp.x, cx, cy);
          r.y = sub_step<T>(rm.y, rc.y, rp.y, ym.y, yp.y, cx, cy);
        }
        if (s < S) {
          a[s][0] = a[s][1];
          a[s][1] = a[s][2];
          a[s][2] = r;
          wb[s * TX] = r;
        } else if (writes && t - S >= 0 && t - S < X) {
          T* o = dst + (long long)(t - S) * xs;
          if (zin0) o[0] = Store<T>::pack(r.x);
          if (zin1) o[1] = Store<T>::pack(r.y);
        }
      }
    }
  }
}

template <typename T, int S, int TZ>
int launch_s(const void* rho, const void* vxf, const void* vyf, void* out,
             int X, int Y, int Z, int by, float cdx, float cdy,
             void* stream) {
  const int W = by + 2 * S;
  if (W * (TZ / 2) > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)S * W * TZ + 2 * kRing) * sizeof(float);
  const int nby = (Y + by - 1) / by, nbz = (Z + TZ - 1) / TZ;
  const long long blocks = (long long)nby * nbz;
  if (smem > kMaxSmem || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rotation_stream<T, S, TZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rotation_stream<T, S, TZ><<<(unsigned)blocks, dim3(TZ / 2, W), smem,
                              (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vxf, (const T*)vyf, (T*)out, X, Y, Z, by, nbz,
      cdx, cdy);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_tz(const void* rho, const void* vxf, const void* vyf, void* out,
              int X, int Y, int Z, int by, int tz, float cdx, float cdy,
              void* stream) {
  switch (tz) {
    case 8:
      return launch_s<T, S, 8>(rho, vxf, vyf, out, X, Y, Z, by, cdx, cdy,
                               stream);
    case 16:
      return launch_s<T, S, 16>(rho, vxf, vyf, out, X, Y, Z, by, cdx, cdy,
                                stream);
    case 32:
      return launch_s<T, S, 32>(rho, vxf, vyf, out, X, Y, Z, by, cdx, cdy,
                                stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* rho, const void* vxf, const void* vyf, void* out,
           int X, int Y, int Z, int spp, int by, int tz, float cdx,
           float cdy, int device, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || by < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
#define DCCRG_ROT_CASE(S)                                                  \
  case S:                                                                  \
    return launch_tz<T, S>(rho, vxf, vyf, out, X, Y, Z, by, tz, cdx, cdy, \
                           stream);
  switch (spp) {
    DCCRG_ROT_CASE(1)
    DCCRG_ROT_CASE(2)
    DCCRG_ROT_CASE(3)
    DCCRG_ROT_CASE(4)
    DCCRG_ROT_CASE(5)
    DCCRG_ROT_CASE(6)
    DCCRG_ROT_CASE(7)
    DCCRG_ROT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCCRG_ROT_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (rho, vx_face, vy_face, out alike).
// vx_face holds Y values, vy_face X + 16 (vy[(i - 8) mod X] at index i).
// tile: a band of `by` rows of y and `tz` (8, 16 or 32) z-columns per
// block, two per thread; (by + 2 * spp) * tz / 2 <= 1024 threads.
extern "C" int dccrg_rotation_step(int dtype, const void* rho,
                                   const void* vx_face, const void* vy_face,
                                   void* out, int X, int Y, int Z, int spp,
                                   int by, int tz, float cdx, float cdy,
                                   int device, void* stream) {
  if (dtype == 0)
    return launch<float>(rho, vx_face, vy_face, out, X, Y, Z, spp, by, tz,
                         cdx, cdy, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rho, vx_face, vy_face, out, X, Y, Z, spp,
                                 by, tz, cdx, cdy, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_rotation_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
