// Bulk stencil pass of the grid step loop: `k` sub-steps of the upwind
// advection flux over a single-device closed-form plan, one HBM pass.
//
// Replaces the Pallas kernel `make_bulk_pass`
// (dccrg_tpu/ops/roll_executor.py:183). That kernel walks the flat row
// array as [G, 8, 128] windows with halos sized by the largest flat
// shift; at 512^3 the z shift alone is nx*ny rows, megabytes, against a
// block's 227 KB of shared memory. Here rows are grid order
// (flat = x + nx*(y + ny*z)), so the pass tiles [nz, ny, nx] bricks
// instead: each block loads one brick of every input field plus a halo
// of k*reach cells per axis into shared memory, applies the flux k times
// over shrinking regions, and writes its interior once. A warp walks a
// window row along x (32 lanes on 32 neighbouring cells, so loads and
// stores are coalesced and no lane divides an index), and the brick's x
// extent is chosen so a window row is a whole number of warps wide.
// Periodic wraps are done exactly at load time; slots that cross a
// non-periodic edge are masked from the cell coordinates, as
// grid._synth_col does (the y and z tests once per row).
//
// With k = 1 nothing is carried between sub-steps, and staging bricks
// in shared memory only serialises each block's loads before its
// compute: that pass (bulk_upwind_direct) has each thread compute one
// cell from its neighbours read straight from device memory through
// the read-only cache, a warp along x and eight rows of y per block, so
// neighbour reads hit L1/L2 and HBM sees each input about once.
//
// The flux is a compile-time functor: the upwind flux of
// dccrg_tpu/models/advection.py:107-129 over fields density, vx, vy,
// with its arithmetic in the same order (per slot: x face then y face;
// acc - where(face_pos, up_pos*m, 0), then + where(face_neg, up_neg*m, 0),
// both unconditionally). Storage is float32 or bfloat16, the arithmetic
// float32; the carried density is rounded to the storage type after
// every sub-step, as the reference's step loop rounds its state. Built
// with --fmad=false, so float32 results equal the plain PyTorch version.
//
// Bound on the H100: bytes. At 512^3, float32, k = 1 the pass reads 3
// fields and writes 1: 4 * 2^27 * 4 B = 2.15 GB, 0.64 ms at 3.35 TB/s;
// about 49 float ops per cell (0.10 ms at 67 TFLOP/s). Neighbour and
// brick-halo re-reads mostly hit L1/L2.
//
// C entry point: dccrg_bulk_upwind(); returns cudaGetLastError() of the
// launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>

namespace {

constexpr int kMaxSlots = 26;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90

struct Geom {
  int nx, ny, nz;     // grid extents
  int px, py, pz;     // periodic flags
  int bx, by, bz;     // brick interior
  int rx, ry, rz;     // reach of one sub-step per axis
  int hx, hy, hz;     // halo = k * reach
  int wx, wy, wz;     // window = brick + 2 * halo
  int nbx, nby, nbz;  // bricks per axis
  int k;              // sub-steps per pass
};

struct Slots {
  int n;
  int ox[kMaxSlots], oy[kMaxSlots], oz[kMaxSlots];  // cell offsets
  int fx[kMaxSlots], fy[kMaxSlots];  // face sign in x / y: +1, -1 or 0
};

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
__device__ __forceinline__ float round_to(float v) {
  return Store<T>::load(Store<T>::pack(v));
}

// Wrap a coordinate into [0, n) on a periodic axis; false when it lies
// outside a non-periodic one.
__device__ __forceinline__ bool wrap(int& c, int n, int periodic) {
  if (c >= 0 && c < n) return true;
  if (!periodic) return false;
  c %= n;
  if (c < 0) c += n;
  return true;
}

// One dimension's face term of one slot (models/advection.py:118-125).
__device__ __forceinline__ float face_term(float acc, float rc, float rn,
                                           float vc, float vn, float c,
                                           bool valid, int face) {
  const float v = 0.5f * (vc + vn);
  const float up_pos = v >= 0.f ? rc : rn;
  const float up_neg = v >= 0.f ? rn : rc;
  const float m = v * c;
  const bool fp = valid && face == 1;
  const bool fn = valid && face == -1;
  acc = acc - (fp ? up_pos * m : 0.f);
  acc = acc + (fn ? up_neg * m : 0.f);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bulk_upwind_kernel(const T* __restrict__ rho, const T* __restrict__ vx,
                   const T* __restrict__ vy, T* __restrict__ out,
                   const Geom g, const Slots s, const float c0,
                   const float c1) {
  extern __shared__ float smem[];
  const int W = g.wx * g.wy * g.wz;
  float* sr = smem;
  float* svx = smem + W;
  float* svy = smem + 2 * W;
  float* sr2 = smem + 3 * W;

  const int lane = threadIdx.x;  // along x
  const int warp = threadIdx.y;
  const int n_warps = blockDim.y;
  const int b = blockIdx.x;
  const int bi = b % g.nbx;
  const int bj = (b / g.nbx) % g.nby;
  const int bk = b / (g.nbx * g.nby);
  // unwrapped global coordinates of window cell (0, 0, 0)
  const int x0 = bi * g.bx - g.hx;
  const int y0 = bj * g.by - g.hy;
  const int z0 = bk * g.bz - g.hz;
  const long long nxy = (long long)g.nx * g.ny;

  // load: one window row (fixed y, z) per warp at a time
  for (int r = warp; r < g.wy * g.wz; r += n_warps) {
    int gy = y0 + r % g.wy, gz = z0 + r / g.wy;
    const bool row_in = wrap(gy, g.ny, g.py) && wrap(gz, g.nz, g.pz);
    const long long base = (long long)g.nx * gy + nxy * gz;
    const int lr = r * g.wx;
    for (int lx = lane; lx < g.wx; lx += 32) {
      int gx = x0 + lx;
      float a = 0.f, u = 0.f, w = 0.f;
      if (row_in && wrap(gx, g.nx, g.px)) {
        const long long f = base + gx;
        a = Store<T>::load(rho[f]);
        u = Store<T>::load(vx[f]);
        w = Store<T>::load(vy[f]);
      }
      sr[lr + lx] = a;
      svx[lr + lx] = u;
      svy[lr + lx] = w;
    }
  }
  __syncthreads();

  const int sy = g.wx, sz = g.wx * g.wy;
  float* cur = sr;
  float* nxt = sr2;
  for (int t = 1; t <= g.k; ++t) {
    const int lox = t * g.rx, loy = t * g.ry, loz = t * g.rz;
    const int ex = g.wx - 2 * lox, ey = g.wy - 2 * loy, ez = g.wz - 2 * loz;
    const bool last = t == g.k;
    for (int r = warp; r < ey * ez; r += n_warps) {
      const int ly = loy + r % ey, lz = loz + r / ey;
      const int gy = y0 + ly, gz = z0 + lz;  // unwrapped
      // slots valid for this row's y and z (non-periodic edges)
      unsigned row_ok = 0;
      for (int j = 0; j < s.n; ++j) {
        bool v = true;
        if (!g.py && s.oy[j]) {
          const int c = gy + s.oy[j];
          v = v && c >= 0 && c < g.ny;
        }
        if (!g.pz && s.oz[j]) {
          const int c = gz + s.oz[j];
          v = v && c >= 0 && c < g.nz;
        }
        row_ok |= (unsigned)v << j;
      }
      const int lrow = sy * ly + sz * lz;
      for (int lx = lox + lane; lx < lox + ex; lx += 32) {
        const int li = lrow + lx;
        const int gx = x0 + lx;
        const float rc = cur[li], vxc = svx[li], vyc = svy[li];
        float acc = 0.f;
        for (int j = 0; j < s.n; ++j) {
          bool valid = (row_ok >> j) & 1u;
          if (!g.px && s.ox[j]) {
            const int c = gx + s.ox[j];
            valid = valid && c >= 0 && c < g.nx;
          }
          const int ln = li + s.ox[j] + sy * s.oy[j] + sz * s.oz[j];
          const float rn = valid ? cur[ln] : 0.f;
          const float vxn = valid ? svx[ln] : 0.f;
          const float vyn = valid ? svy[ln] : 0.f;
          acc = face_term(acc, rc, rn, vxc, vxn, c0, valid, s.fx[j]);
          acc = face_term(acc, rc, rn, vyc, vyn, c1, valid, s.fy[j]);
        }
        const float res = rc + acc;
        if (last) {
          // the interior: gx, gy, gz >= 0; ragged bricks stop at the edge
          if (gx < g.nx && gy < g.ny && gz < g.nz)
            out[gx + (long long)g.nx * gy + nxy * gz] = Store<T>::pack(res);
        } else {
          nxt[li] = round_to<T>(res);
        }
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

// k = 1: one cell per thread, neighbours read from device memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bulk_upwind_direct(const T* __restrict__ rho, const T* __restrict__ vx,
                   const T* __restrict__ vy, T* __restrict__ out,
                   const Geom g, const Slots s, const float c0,
                   const float c1) {
  const int gx = blockIdx.x * 32 + threadIdx.x;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y;
  if (gx >= g.nx || gy >= g.ny) return;
  const long long nxy = (long long)g.nx * g.ny;
  for (int gz = blockIdx.z; gz < g.nz; gz += gridDim.z) {
    const long long f = gx + (long long)g.nx * gy + nxy * gz;
    const float rc = Store<T>::load(rho[f]);
    const float vxc = Store<T>::load(vx[f]);
    const float vyc = Store<T>::load(vy[f]);
    float acc = 0.f;
    for (int j = 0; j < s.n; ++j) {
      int tx = gx + s.ox[j], ty = gy + s.oy[j], tz = gz + s.oz[j];
      const bool valid = wrap(tx, g.nx, g.px) && wrap(ty, g.ny, g.py) &&
                         wrap(tz, g.nz, g.pz);
      float rn = 0.f, vxn = 0.f, vyn = 0.f;
      if (valid) {
        const long long fn = tx + (long long)g.nx * ty + nxy * tz;
        rn = Store<T>::load(rho[fn]);
        vxn = Store<T>::load(vx[fn]);
        vyn = Store<T>::load(vy[fn]);
      }
      acc = face_term(acc, rc, rn, vxc, vxn, c0, valid, s.fx[j]);
      acc = face_term(acc, rc, rn, vyc, vyn, c1, valid, s.fy[j]);
    }
    out[f] = Store<T>::pack(rc + acc);
  }
}

template <typename T>
int launch(const void* rho, const void* vx, const void* vy, void* out,
           const int* gi, const int* si, int n_slots, float c0, float c1,
           int device, void* stream) {
  Geom g;
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.bx = gi[6]; g.by = gi[7]; g.bz = gi[8];
  g.rx = gi[9]; g.ry = gi[10]; g.rz = gi[11];
  g.k = gi[12];
  if (n_slots < 0 || n_slots > kMaxSlots || g.k < 1 || g.bx < 1 ||
      g.by < 1 || g.bz < 1 || g.nx < 1 || g.ny < 1 || g.nz < 1)
    return (int)cudaErrorInvalidValue;
  g.hx = g.k * g.rx; g.hy = g.k * g.ry; g.hz = g.k * g.rz;
  g.wx = g.bx + 2 * g.hx; g.wy = g.by + 2 * g.hy; g.wz = g.bz + 2 * g.hz;
  g.nbx = (g.nx + g.bx - 1) / g.bx;
  g.nby = (g.ny + g.by - 1) / g.by;
  g.nbz = (g.nz + g.bz - 1) / g.bz;
  Slots s;
  s.n = n_slots;
  for (int j = 0; j < n_slots; ++j) {
    s.ox[j] = si[5 * j]; s.oy[j] = si[5 * j + 1]; s.oz[j] = si[5 * j + 2];
    s.fx[j] = si[5 * j + 3]; s.fy[j] = si[5 * j + 4];
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (g.k == 1) {
    const dim3 grid((g.nx + 31) / 32, (g.ny + kThreads / 32 - 1) /
                    (kThreads / 32), g.nz < 65535 ? g.nz : 65535);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    bulk_upwind_direct<T><<<grid, dim3(32, kThreads / 32), 0,
                            (cudaStream_t)stream>>>(
        (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, s, c0, c1);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)4 * g.wx * g.wy * g.wz * sizeof(float);
  const long long blocks = (long long)g.nbx * g.nby * g.nbz;
  if (smem > kMaxSmem || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(bulk_upwind_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  bulk_upwind_kernel<T><<<(unsigned)blocks, dim3(32, kThreads / 32), smem,
                          (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, s, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four arrays the same type).
// geom: nx, ny, nz, px, py, pz, bx, by, bz, rx, ry, rz, k.
// slots: n_slots rows of (ox, oy, oz, fx, fy).
extern "C" int dccrg_bulk_upwind(int dtype, const void* rho, const void* vx,
                                 const void* vy, void* out, const int* geom,
                                 const int* slots, int n_slots, float c0,
                                 float c1, int device, void* stream) {
  if (dtype == 0)
    return launch<float>(rho, vx, vy, out, geom, slots, n_slots, c0, c1,
                         device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rho, vx, vy, out, geom, slots, n_slots, c0,
                                 c1, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_bulk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
