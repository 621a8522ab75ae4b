// Batched bulk pass of the fleet (kernel A'): one step of a fleet
// kernel's slot-wise twin over B independent grids of one bucket.
//
// Replaces the Pallas kernel `make_bulk_pass(..., batch=B)` that
// `make_fleet_bulk_step` builds (dccrg_tpu/ops/roll_executor.py:707,
// pallas_call at :347). That kernel adds a leading slot axis to the
// [G, 8, 128] flat-window grid of kernel A, reads each slot's extras
// from a [B, E] block, leaves the rows whose flat roll crosses a
// periodic wrap wrong and lets a vmapped fixup epilogue repair them.
// Here rows are grid order (flat = x + nx*(y + ny*z)) on a
// single-device closed-form plan, so each thread computes one cell of
// one slot from its neighbours' 3-D coordinates: periodic axes wrap
// exactly, non-periodic ones mask from the cell's coordinates as
// grid._synth_col does, and every row comes out right. No epilogue
// runs after it.
//
// Layout: `state` is the fleet's [B, R] field with row stride R
// (R = L + 1: n0 grid cells, L - n0 capacity pad rows, one zero row);
// slot b's rows start at b*R. The pass writes all R rows of every slot
// of a new [B, R] tensor: the grid cells (fleet_bulk_cells), then the
// pad rows, which have no valid neighbour, and the zero row, copied
// (fleet_bulk_tail). `extras` is the [B, E] float32 per-slot parameter
// block on the device; the kernel reads column 0 (dt or cfl), so a
// step needs no host read.
//
// A block is one warp along x (32 neighbouring cells: coalesced loads
// and stores) by eight rows of y; blockIdx.z walks slot x z-chunk, and
// each thread marches its column through kChunkZ planes of z. It wraps
// and masks its x-1, x, x+1 and y-1, y, y+1 coordinates once and keeps
// the 3x3 patches of planes z-1 and z in registers, so each step loads
// one new patch (9 values, not 26) and adds the 26 slots from registers
// in the default neighbourhood's order (z-major, x fastest: the order
// of hood.offs_const, which the wrapper checks), unrolled at compile
// time. Patch reads are the cell's x and y neighbours, so most hit
// L1/L2 and HBM sees each value about once.
//
// The flux is a compile-time functor, with the arithmetic of the
// twins in dccrg_tpu_torch/fleet.py (the reference's fleet.py:208-236)
// in the same order:
//   diffuse:  acc += valid_j ? (n_j - c) : 0;       out = c + dt*acc
//   advect_x: acc += (up_j && valid_j) ? n_j : 0;   out = (1-cfl)*c + cfl*acc
// with up_j true for the slot (-1, 0, 0) only (the twin's test
// ox < 0, oy == 0, oz == 0 on the cube). Storage is float32 or
// bfloat16; `n_j - c` and every partial sum are rounded to the storage
// type, as PyTorch's bfloat16 arithmetic rounds them, and the finish
// runs in float32 (the reference promotes bf16 * float32 to float32)
// with one rounding at the store. Built with --fmad=false, so the pass
// equals its plain PyTorch version bit for bit.
//
// Bound on the H100: bytes. At 128 slots x 64^3 float32 one step reads
// and writes 2 * 33.55M floats, 268 MB, 80.1 us at 3.35 TB/s; about 54
// float ops per cell, 1.8 GFLOP, 27 us at 67 TFLOP/s.
//
// C entry point: dccrg_fleet_bulk(); returns cudaGetLastError() of the
// launches (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRowsY = 8;
constexpr int kChunkZ = 16;  // z planes one thread marches

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int B;           // slots
  int E;           // extras per slot (columns of `extras`)
  long long n0;    // grid cells per slot
  long long L;     // rows per slot written by the flux (n0 + pad)
  long long R;     // row stride (L + 1)
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

// fleet.py _make_diffuse_slotwise: acc + where(mask, nbr - c, 0)
struct Diffuse {
  // whether slot (dx, dy, dz) (each 0, 1, 2 for -1, 0, +1) is read
  static __device__ __forceinline__ constexpr bool reads(int, int, int) {
    return true;
  }
  // whether column (dx, dy) is read in any plane
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
};

// fleet.py _make_advect_x_slotwise: acc + where(up & mask, nbr, 0)
struct AdvectX {
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
};

// The 3x3 patch of plane z around (x, y): entry 3*dy + dx (each 0, 1, 2
// for -1, 0, +1), 0 where the cell lies outside a non-periodic edge.
// Entries F never reads in any plane stay unloaded.
template <typename T, typename F>
__device__ __forceinline__ void load_plane(float (&v)[9], const T* src,
                                           long long zo, bool zv,
                                           const long long (&xo)[3],
                                           const long long (&yo)[3],
                                           const bool (&xv)[3],
                                           const bool (&yv)[3]) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float n = 0.f;
      if ((F::reads_column(dx, dy) || (dx == 1 && dy == 1)) && zv &&
          xv[dx] && yv[dy])
        n = Store<T>::load(src[xo[dx] + yo[dy] + zo]);
      v[3 * dy + dx] = n;
    }
  }
}

// The slots of plane dz (0, 1, 2 for z-1, z, z+1) in slot order, added
// to acc; plane 1 skips the cell itself.
template <typename T, typename F>
__device__ __forceinline__ void add_plane(float& acc, const float (&v)[9],
                                          int dz, bool zv, float c,
                                          const bool (&xv)[3],
                                          const bool (&yv)[3]) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      if (dz == 1 && dy == 1 && dx == 1) continue;
      float t = 0.f;
      if (F::reads(dx, dy, dz) && zv && xv[dx] && yv[dy])
        t = F::template term<T>(c, v[3 * dy + dx]);
      acc = round_to<T>(acc + t);
    }
  }
}

template <typename T, typename F>
__global__ void __launch_bounds__(32 * kRowsY)
fleet_bulk_cells(const T* __restrict__ in, T* __restrict__ out,
                 const float* __restrict__ extras, const Geom g) {
  const int gx = blockIdx.x * 32 + threadIdx.x;
  const int gy = blockIdx.y * kRowsY + threadIdx.y;
  if (gx >= g.nx || gy >= g.ny) return;
  const long long nxy = (long long)g.nx * g.ny;
  // wrapped coordinates (as row offsets) and validity of x-1, x, x+1
  // and y-1, y, y+1
  long long xo[3], yo[3];
  bool xv[3], yv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    int tx = gx + d - 1, ty = gy + d - 1;
    xv[d] = wrap(tx, g.nx, g.px);
    yv[d] = wrap(ty, g.ny, g.py);
    xo[d] = tx;
    yo[d] = (long long)g.nx * ty;
  }
  const int n_chunks = (g.nz + kChunkZ - 1) / kChunkZ;
  const long long n_work = (long long)g.B * n_chunks;
  for (long long w = blockIdx.z; w < n_work; w += gridDim.z) {
    const int b = (int)(w / n_chunks);
    const int z0 = (int)(w - (long long)b * n_chunks) * kChunkZ;
    const int z1 = min(z0 + kChunkZ, g.nz);
    const T* src = in + b * g.R;
    T* dst = out + b * g.R;
    const float p = extras[(long long)b * g.E];
    // planes z-1 and z in registers; plane z+1 is loaded per step
    float lo[9], mid[9], hi[9];
    int tz = z0 - 1;
    bool zv_lo = wrap(tz, g.nz, g.pz);
    load_plane<T, F>(lo, src, nxy * tz, zv_lo, xo, yo, xv, yv);
    load_plane<T, F>(mid, src, nxy * z0, true, xo, yo, xv, yv);
    for (int z = z0; z < z1; ++z) {
      tz = z + 1;
      const bool zv_hi = wrap(tz, g.nz, g.pz);
      load_plane<T, F>(hi, src, nxy * tz, zv_hi, xo, yo, xv, yv);
      const float c = mid[4];
      float acc = 0.f;
      add_plane<T, F>(acc, lo, 0, zv_lo, c, xv, yv);
      add_plane<T, F>(acc, mid, 1, true, c, xv, yv);
      add_plane<T, F>(acc, hi, 2, zv_hi, c, xv, yv);
      dst[xo[1] + yo[1] + nxy * z] = Store<T>::pack(F::finish(c, acc, p));
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        lo[k] = mid[k];
        mid[k] = hi[k];
      }
      zv_lo = true;
    }
  }
}

// Rows [n0, R) of every slot: pad rows have no valid neighbour, so the
// sum stays +0; the zero row (R - 1) is copied.
template <typename T, typename F>
__global__ void fleet_bulk_tail(const T* __restrict__ in, T* __restrict__ out,
                                const float* __restrict__ extras,
                                const Geom g) {
  const long long per = g.R - g.n0;
  const long long total = (long long)g.B * per;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(i / per);
    const long long r = g.n0 + i % per;
    const long long at = b * g.R + r;
    if (r < g.L) {
      const float c = Store<T>::load(in[at]);
      out[at] = Store<T>::pack(F::finish(c, 0.f, extras[(long long)b * g.E]));
    } else {
      out[at] = in[at];
    }
  }
}

template <typename T, typename F>
int launch(const void* in, void* out, const float* extras, const Geom& g,
           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_work = (long long)g.B * ((g.nz + kChunkZ - 1) / kChunkZ);
  const dim3 grid((g.nx + 31) / 32, (g.ny + kRowsY - 1) / kRowsY,
                  n_work < 65535 ? (unsigned)n_work : 65535u);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fleet_bulk_cells<T, F><<<grid, dim3(32, kRowsY), 0, st>>>(
      (const T*)in, (T*)out, extras, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long tail = (long long)g.B * (g.R - g.n0);
  const long long blocks = (tail + 255) / 256;
  fleet_bulk_tail<T, F><<<blocks < 4096 ? (unsigned)blocks : 4096u, 256, 0,
                          st>>>((const T*)in, (T*)out, extras, g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (state and out the same type).
// flux: 0 = diffuse, 1 = advect_x.
// geom: nx, ny, nz, px, py, pz, B, E.
extern "C" int dccrg_fleet_bulk(int dtype, int flux, const void* state,
                                void* out, const float* extras,
                                const int* geom, long long n0, long long L,
                                long long R, int device, void* stream) {
  Geom g;
  g.nx = geom[0]; g.ny = geom[1]; g.nz = geom[2];
  g.px = geom[3]; g.py = geom[4]; g.pz = geom[5];
  g.B = geom[6]; g.E = geom[7];
  g.n0 = n0; g.L = L; g.R = R;
  if (g.nx < 1 || g.ny < 1 || g.nz < 1 || g.B < 1 || g.E < 1 ||
      n0 != (long long)g.nx * g.ny * g.nz || L < n0 || R != L + 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0 && flux == 0)
    return launch<float, Diffuse>(state, out, extras, g, stream);
  if (dtype == 0 && flux == 1)
    return launch<float, AdvectX>(state, out, extras, g, stream);
  if (dtype == 1 && flux == 0)
    return launch<__nv_bfloat16, Diffuse>(state, out, extras, g, stream);
  if (dtype == 1 && flux == 1)
    return launch<__nv_bfloat16, AdvectX>(state, out, extras, g, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_fleet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
