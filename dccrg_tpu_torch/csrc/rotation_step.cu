// Rotation-advection step: `spp` upwind steps of the benchmark's
// separable solid-body rotation field per HBM pass.
//
// Replaces the Pallas kernel `make_rotation_step`
// (dccrg_tpu/ops/advection_kernel.py:40). rho is [X, Y, Z] with Z
// contiguous; the field is periodic in x and y and has no flux in z, so
// every z column is independent. Each block holds an (x, y) tile of
// TZ z-columns with a spp-wide periodic halo in x AND y in shared memory
// (the TPU kernel spanned all of y per tile; 512 rows of y do not fit a
// block), runs the spp sub-steps over shrinking regions and writes the
// interior once: one read and one write of rho per pass.
//
// Thread (zz, j) = (threadIdx.x, threadIdx.y) owns tile column j at
// depth zz: TZ threads along z make each warp's loads and stores one
// contiguous run, and the thread walks its column along x keeping the
// x-neighbours in registers, so a sub-step costs three shared-memory
// reads per cell. The folded face velocities are computed once per
// block into shared memory (vx depends on y only, vy on x only).
//
// Arithmetic as advection_kernel.py:121-151: dt*rdx and dt*rdy are
// folded into the face velocities in float32 and rounded to the storage
// type; per sub-step rc + v*where(v >= 0, r_m - rc, rc - r_p) along x,
// then along y. In bfloat16 every operation is rounded to bfloat16, as
// the reference computes in the storage type; float32 is built with
// --fmad=false, so both agree with the plain PyTorch version bit for bit.
//
// Bound on the H100: bytes. One pass at 512^3, float32: 2 * 2^27 * 4 B =
// 1.07 GB, 0.32 ms at 3.35 TB/s; 10 float ops per cell-update (0.14 ms
// at 67 TFLOP/s for spp = 7). The halo costs shared-memory traffic and
// recomputation (1.95x cell-updates at 16x16 tiles, spp = 7) and halo
// re-reads that mostly come from L2, not HBM bytes.
//
// C entry point: dccrg_rotation_step(); returns cudaGetLastError() of
// the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90

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

template <typename T, int TZ>
__global__ void rotation_kernel(const T* __restrict__ rho,
                                const T* __restrict__ vxf,
                                const T* __restrict__ vyf,
                                T* __restrict__ out, const int X, const int Y,
                                const int Z, const int H, const int txy,
                                const int nby, const int nbz, const float cdx,
                                const float cdy) {
  extern __shared__ float smem[];
  const int W = txy + 2 * H;
  const int SI = W * TZ;  // shared stride of one tile row (x step)
  float* cur = smem;
  float* nxt = smem + W * SI;
  float* cxs = smem + 2 * W * SI;  // folded vx of tile column j (y)
  float* cys = cxs + W;            // folded vy of tile row i (x)

  const int zz = threadIdx.x;
  const int j = threadIdx.y;
  const int b = blockIdx.x;
  const int bk = b % nbz;
  const int q0 = b / nbz;
  const int bj = q0 % nby;
  const int bi = q0 / nby;
  // unwrapped global (x, y) of tile cell (0, 0); z of this thread
  const int x0 = bi * txy - H, y0 = bj * txy - H;
  const int gz = bk * TZ + zz;
  const bool zin = gz < Z;
  const int gy = wrap(y0 + j, Y);

  if (zz == 0) {
    // vy_face carries an 8-row wrap margin: index x + 8 holds vy[x]
    cxs[j] = rnd<T>(Store<T>::load(vxf[gy]) * cdx);
    cys[j] = rnd<T>(Store<T>::load(vyf[wrap(x0 + j, X) + 8]) * cdy);
  }
  const long long xstride = (long long)Y * Z;
  const long long col = (long long)gy * Z + gz;
  float* dst = cur + j * TZ + zz;
#pragma unroll 6
  for (int i = 0; i < W; ++i) {
    const int gx = wrap(x0 + i, X);
    dst[i * SI] = zin ? Store<T>::load(rho[gx * xstride + col]) : 0.f;
  }
  __syncthreads();

  for (int s = 1; s <= H; ++s) {
    const bool last = s == H;
    if (j >= s && j < W - s) {
      const float cx = cxs[j];
      const float* src = cur + j * TZ + zz;
      float* nx = nxt + j * TZ + zz;
      float rm = src[(s - 1) * SI];
      float rc = src[s * SI];
      for (int i = s; i < W - s; ++i) {
        const int c = i * SI;
        const float rp = src[c + SI];
        const float ym = src[c - TZ];
        const float yp = src[c + TZ];
        const float cy = cys[i];
        const float dxm = rnd<T>(rm - rc);
        const float dxp = rnd<T>(rc - rp);
        const float dxt = rnd<T>(cx * (cx >= 0.f ? dxm : dxp));
        const float dyp = rnd<T>(rc - yp);
        const float dym = rnd<T>(ym - rc);
        const float dyt = rnd<T>(cy * (cy >= 0.f ? dym : dyp));
        const float r = rnd<T>(rnd<T>(rc + dxt) + dyt);
        if (last) {
          // the interior: i, j in [H, H + txy), so ox, oy >= 0
          const int ox = x0 + i, oy = y0 + j;
          if (ox < X && oy < Y && zin)
            out[ox * xstride + (long long)oy * Z + gz] = Store<T>::pack(r);
        } else {
          nx[c] = r;
        }
        rm = rc;
        rc = rp;
      }
    }
    if (!last) {
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

template <typename T, int TZ>
int launch_tz(const void* rho, const void* vxf, const void* vyf, void* out,
              int X, int Y, int Z, int spp, int txy, float cdx, float cdy,
              void* stream) {
  const int W = txy + 2 * spp;
  if (W * TZ > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)W * W * TZ + 2 * (size_t)W) * sizeof(float);
  const int nbx = (X + txy - 1) / txy, nby = (Y + txy - 1) / txy;
  const int nbz = (Z + TZ - 1) / TZ;
  const long long blocks = (long long)nbx * nby * nbz;
  if (smem > kMaxSmem || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      rotation_kernel<T, TZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rotation_kernel<T, TZ><<<(unsigned)blocks, dim3(TZ, W), smem,
                           (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vxf, (const T*)vyf, (T*)out, X, Y, Z, spp,
      txy, nby, nbz, cdx, cdy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* rho, const void* vxf, const void* vyf, void* out,
           int X, int Y, int Z, int spp, int txy, int tz, float cdx,
           float cdy, int device, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || spp < 1 || spp > 8 || txy < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (tz) {
    case 8:
      return launch_tz<T, 8>(rho, vxf, vyf, out, X, Y, Z, spp, txy, cdx, cdy,
                             stream);
    case 16:
      return launch_tz<T, 16>(rho, vxf, vyf, out, X, Y, Z, spp, txy, cdx,
                              cdy, stream);
    case 32:
      return launch_tz<T, 32>(rho, vxf, vyf, out, X, Y, Z, spp, txy, cdx,
                              cdy, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (rho, vx_face, vy_face, out alike).
// vx_face holds Y values, vy_face X + 16 (vy[(i - 8) mod X] at index i).
// tile: txy cells of x and y per block, tz (8, 16 or 32) of z.
extern "C" int dccrg_rotation_step(int dtype, const void* rho,
                                   const void* vx_face, const void* vy_face,
                                   void* out, int X, int Y, int Z, int spp,
                                   int txy, int tz, float cdx, float cdy,
                                   int device, void* stream) {
  if (dtype == 0)
    return launch<float>(rho, vx_face, vy_face, out, X, Y, Z, spp, txy, tz,
                         cdx, cdy, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rho, vx_face, vy_face, out, X, Y, Z, spp,
                                 txy, tz, cdx, cdy, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_rotation_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
