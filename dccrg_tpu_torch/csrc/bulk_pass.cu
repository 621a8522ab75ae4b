// Bulk stencil pass of the grid step loop: one sub-step of a device flux
// (csrc/fluxes.cuh: the upwind advection flux, the fleet twins diffuse
// and advect_x) over a single-device closed-form plan.
//
// Replaces the Pallas kernel `make_bulk_pass`
// (dccrg_tpu/ops/roll_executor.py:183). That kernel walks the flat row
// array as [G, 8, 128] windows with halos sized by the largest flat
// shift, leaves the rows whose flat roll crosses a periodic wrap wrong
// and has a fixup epilogue repair them. Here rows are grid order
// (flat = x + nx*(y + ny*z)) and every neighbour is read at its exact
// 3-D position, periodic wraps included, so every row written is right
// and nothing follows the kernel. One launch is one step; the step loop
// launches once per step, each launch reading the previous one's output
// in the storage type, as the reference rounds its state between steps.
//
// Bound on the H100: bytes. At 512^3, float32, the pass reads 3 fields
// and writes 1: 4 * 2^27 * 4 B = 2.15 GB, 0.64 ms at 3.35 TB/s; 25
// float ops a cell, one face term of 6 for each of the four face slots
// and the final add (0.05 ms at 67 TFLOP/s). Two routes:
//
// Plane tiles (bulk_planes), for the face neighbourhood's four x / y
// slots in the order the neighbourhood lists them (-y, -x, +x, +y): the
// main path. A block owns a 128 x 16 (x, y) tile and marches a chunk of
// z. The set has no z reach, so every plane is computed alone. Each
// z-plane's tile of the three fields, with one halo row in y and 8 halo
// columns in x on each side, is staged in shared memory by cp.async in
// 16-byte chunks, in a ring of 3 planes: the plane computed and two that
// load meanwhile, so the loads overlap the arithmetic. Periodic edges
// are wrapped per chunk at load time; chunks beyond a non-periodic edge
// are zero-filled, and the slot's mask drops them. A thread computes V
// cells along x (4 float32, 8 bfloat16) from 16-byte shared-memory
// reads, with the four slots unrolled and the non-periodic masks fixed
// once per block, and writes them with one 16-byte store. Extents that
// are not a multiple of V, or unaligned arrays, take the same kernel
// with element-wise loads and stores.
//
// Direct (bulk_direct of bulk_direct.cuh, the template a generated
// flux instantiates too), for every other flux and slot set (the upwind
// flux on the 26-cube of a neighbourhood of length 1 and on user
// neighbourhoods; diffuse and advect_x on the neighbourhoods of length
// 0, 1 and 2): a thread owns one (x, y) column and walks a chunk of
// kDirectZ consecutive z-planes of it, so the planes a cell's z
// neighbours lie in are the block's own, in L1 or L2; the flux's slot
// table (at most 124 slots, from a device buffer) is staged in shared
// memory once a block with each slot's flat row offset. A cell at least
// the table's reach inside the grid on every axis reads each neighbour
// at its row plus that offset, with no wrap and no mask (every warp but
// those at the faces); the rest wrap each coordinate. The slot loop
// runs in the table's order, unrolled by four so a group's loads issue
// together. At 512^3 float32 the single-field fluxes move 1 field in
// and 1 out, 2 * 2^27 * 4 B, 0.3205 ms at 3.35 TB/s.
//
// The upwind flux is that of dccrg_tpu/models/advection.py:107-129
// over fields density, vx, vy, with its arithmetic in the same order
// (per slot: x face then y face; acc - where(face_pos, up_pos*m, 0),
// then + where(face_neg, up_neg*m, 0)). A face term whose face flag is
// 0, or whose slot is masked, adds or subtracts an exact 0 to a sum that
// is never -0.0 (it starts at +0.0 and every step ends in an addition),
// so the plane tiles leave those terms out. Storage is float32 or
// bfloat16; the upwind arithmetic is float32, its result rounded to the
// storage type once; the single-field twins round each term and partial
// sum to the storage type (fluxes.cuh). Built with --fmad=false, so
// results equal the plain PyTorch version bit for bit.
//
// C entry points: dccrg_bulk_upwind() (the face set's plane tiles) and
// dccrg_bulk_direct() (any flux, any slot table); each returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "bulk_direct.cuh"
#include "fluxes.cuh"

namespace {

using namespace fluxes;

constexpr int kThreads = 256;
constexpr int kTileX = 128, kTileY = 16;  // plane tile: x cells, y rows
constexpr int kPad = 8;                   // x halo columns on each side
constexpr int kRowW = kTileX + 2 * kPad;  // staged columns
constexpr int kStages = 3;                // planes in the ring
constexpr int kRows = kTileY + 2;         // staged rows of one field

// the face set in neighbourhood order, as (ox, oy, oz, fx, fy)
constexpr int kFace4[4][5] = {
    {0, -1, 0, 0, -1}, {-1, 0, 0, -1, 0}, {1, 0, 0, 1, 0}, {0, 1, 0, 0, 1}};

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int zc;          // z-planes per block (plane tiles)
};

// 16 bytes of shared memory as floats, and V floats back to 16 bytes
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 16-byte asynchronous copy to shared memory; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Plane tiles of the face set, unrolled.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
bulk_planes(const T* __restrict__ rho, const T* __restrict__ vx,
            const T* __restrict__ vy, T* __restrict__ out, const Geom g,
            const float c0, const float c1) {
  constexpr int V = 16 / sizeof(T);   // cells per thread along x
  constexpr int LPR = kTileX / V;     // threads per tile row
  constexpr int RG = kThreads / LPR;  // tile rows computed at once
  constexpr int RPT = kTileY / RG;    // tile rows per thread
  constexpr int CPR = kRowW / V;      // 16-byte chunks per staged row
  constexpr int field = kRows * kRowW;  // one field's staged plane
  constexpr int stage = 3 * field;      // one ring slot
  static_assert(kPad % V == 0 && RPT * RG == kTileY, "tile geometry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int ntx = (g.nx + kTileX - 1) / kTileX;
  const int nty = (g.ny + kTileY - 1) / kTileY;
  const int b = blockIdx.x;
  const int x0 = (b % ntx) * kTileX;
  const int y0 = ((b / ntx) % nty) * kTileY;
  const int zs = (b / (ntx * nty)) * g.zc;
  const int np = min(g.zc, g.nz - zs);  // planes of this block
  const long long nxy = (long long)g.nx * g.ny;

  // stage plane i (z = zs + i) of the three fields into slot i % kStages
  auto load_plane = [&](int i) {
    T* st = smem + (i % kStages) * stage;
    const long long zoff = (long long)(zs + i) * nxy;
    if (VEC) {
      for (int k = threadIdx.x; k < 3 * kRows * CPR; k += kThreads) {
        const int row = k / CPR, c = k - row * CPR;
        const int f = row / kRows;
        int gy = y0 - 1 + (row - f * kRows), gx = x0 - kPad + c * V;
        const T* base = f == 0 ? rho : (f == 1 ? vx : vy);
        // nx % V == 0, so a chunk lies wholly inside or outside the grid
        const bool ok = wrap(gy, g.ny, g.py) && wrap(gx, g.nx, g.px);
        cp_async16(st + row * kRowW + c * V,
                   ok ? base + zoff + (long long)gy * g.nx + gx : base, ok);
      }
    } else {
      for (int k = threadIdx.x; k < 3 * kRows * kRowW; k += kThreads) {
        const int row = k / kRowW, e = k - row * kRowW;
        const int f = row / kRows;
        int gy = y0 - 1 + (row - f * kRows), gx = x0 - kPad + e;
        const T* base = f == 0 ? rho : (f == 1 ? vx : vy);
        const bool ok = wrap(gy, g.ny, g.py) && wrap(gx, g.nx, g.px);
        st[row * kRowW + e] =
            ok ? base[zoff + (long long)gy * g.nx + gx] : Store<T>::pack(0.f);
      }
    }
  };

  const int lx = threadIdx.x % LPR, rg = threadIdx.x / LPR;
  const int gx0 = x0 + lx * V;  // global x of the thread's first cell
  // the non-periodic masks: bit c for cell c's -x / +x neighbour
  unsigned xm_ok = 0, xp_ok = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    xm_ok |= (unsigned)(g.px || gx0 + c > 0) << c;
    xp_ok |= (unsigned)(g.px || gx0 + c + 1 < g.nx) << c;
  }

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < np) load_plane(i);
    cp_async_commit();
  }
  for (int i = 0; i < np; ++i) {
    // slot (i + kStages - 1) % kStages held plane i - 1, freed by the
    // last sync
    if (i + kStages - 1 < np) load_plane(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // plane i has landed
    __syncthreads();
    const long long zoff = (long long)(zs + i) * nxy;
    const T* st = smem + (i % kStages) * stage;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int ry = rg + k * RG;
      const int gy = y0 + ry;
      const bool ym_ok = g.py || gy > 0;
      const bool yp_ok = g.py || gy + 1 < g.ny;
      const T* rr = st + (ry + 1) * kRowW + kPad + lx * V;
      const T* ur = rr + field;
      const T* wr = rr + 2 * field;
      float R[V + 2], U[V + 2], W[V], RM[V], RP[V], WM[V], WP[V];
      load_vec(rr, R + 1);
      R[0] = Store<T>::load(rr[-1]);
      R[V + 1] = Store<T>::load(rr[V]);
      load_vec(ur, U + 1);
      U[0] = Store<T>::load(ur[-1]);
      U[V + 1] = Store<T>::load(ur[V]);
      load_vec(wr, W);
      load_vec(rr - kRowW, RM);
      load_vec(rr + kRowW, RP);
      load_vec(wr - kRowW, WM);
      load_vec(wr + kRowW, WP);
      float res[V];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float rc = R[c + 1], uc = U[c + 1], wc = W[c];
        float acc = 0.f;
        if (ym_ok) {  // slot -y: the y face's negative side
          const float v = 0.5f * (wc + WM[c]);
          acc = acc + (v >= 0.f ? RM[c] : rc) * (v * c1);
        }
        if ((xm_ok >> c) & 1u) {  // slot -x
          const float v = 0.5f * (uc + U[c]);
          acc = acc + (v >= 0.f ? R[c] : rc) * (v * c0);
        }
        if ((xp_ok >> c) & 1u) {  // slot +x
          const float v = 0.5f * (uc + U[c + 2]);
          acc = acc - (v >= 0.f ? rc : R[c + 2]) * (v * c0);
        }
        if (yp_ok) {  // slot +y
          const float v = 0.5f * (wc + WP[c]);
          acc = acc - (v >= 0.f ? rc : RP[c]) * (v * c1);
        }
        res[c] = rc + acc;
      }
      if (gy < g.ny) {
        T* o = out + zoff + (long long)gy * g.nx + gx0;
        if (VEC) {
          if (gx0 < g.nx) store_vec(o, res);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c)
            if (gx0 + c < g.nx) o[c] = Store<T>::pack(res[c]);
        }
      }
    }
    __syncthreads();  // slot i % kStages is reloaded next iteration
  }
}

bool is_face4(const int* si, int n_slots) {
  if (n_slots != 4) return false;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 5; ++i)
      if (si[5 * j + i] != kFace4[j][i]) return false;
  return true;
}

template <typename T, bool VEC>
int launch_planes(const void* rho, const void* vx, const void* vy, void* out,
                  const Geom& g, float c0, float c1, void* stream) {
  const size_t smem = (size_t)kStages * 3 * kRows * kRowW * sizeof(T);
  const long long blocks = (long long)((g.nx + kTileX - 1) / kTileX) *
                           ((g.ny + kTileY - 1) / kTileY) *
                           ((g.nz + g.zc - 1) / g.zc);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_planes<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  bulk_planes<T, VEC><<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, c0, c1);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* rho, const void* vx, const void* vy, void* out,
           const int* gi, const int* si, int n_slots, float c0, float c1,
           int device, void* stream) {
  Geom g;
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.zc = gi[8];
  if (!is_face4(si, n_slots) || g.nx < 1 || g.ny < 1 || g.nz < 1 ||
      gi[6] != kTileX || gi[7] != kTileY || g.zc < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  constexpr int V = 16 / sizeof(T);
  const bool aligned = g.nx % V == 0 &&
                       ((uintptr_t)rho | (uintptr_t)vx | (uintptr_t)vy |
                        (uintptr_t)out) % 16 == 0;
  return aligned ? launch_planes<T, true>(rho, vx, vy, out, g, c0, c1, stream)
                 : launch_planes<T, false>(rho, vx, vy, out, g, c0, c1,
                                           stream);
}

template <typename T, typename F>
int launch_direct(const void* const* in, void* out, const int* gi,
                  const void* slots, int n_slots, Coef k, int device,
                  void* stream) {
  direct::Ptrs p = {};
  for (int q = 0; q < F::kFields; ++q) p.in[q] = in[q];
  p.out[0] = out;
  const long long n0 = (long long)gi[0] * gi[1] * gi[2];
  return direct::launch_direct<direct::Named<T, F>>(
      p, gi, n0, n0, slots, nullptr, n_slots, k, device, stream);
}

template <typename T>
int launch_direct(int flux, const void* const* in, void* out, const int* gi,
                  const void* slots, int n_slots, Coef k, int device,
                  void* stream) {
  switch (flux) {
    case Diffuse::kCode:
      return launch_direct<T, Diffuse>(in, out, gi, slots, n_slots, k, device,
                                       stream);
    case AdvectX::kCode:
      return launch_direct<T, AdvectX>(in, out, gi, slots, n_slots, k, device,
                                       stream);
    case UpwindXY::kCode:
      return launch_direct<T, UpwindXY>(in, out, gi, slots, n_slots, k,
                                        device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four arrays the same type).
// geom: nx, ny, nz, px, py, pz, tile x, tile y, z-planes per block.
// The face set's plane tiles: tile 128 x 16, slots the four rows of
// (ox, oy, oz, fx, fy) in kFace4's order; any other set takes
// dccrg_bulk_direct.
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

// dtype as above; flux: a functor's kCode (fluxes.cuh); in: the flux's
// kFields field pointers, field 0 the carried one; geom: nx, ny, nz,
// px, py, pz, and the table's reach rx, ry, rz (the largest |offset|
// per axis: a cell that far inside the grid reads its neighbours
// unwrapped); slots: a device buffer of n_slots int4 rows (ox, oy, oz,
// code) in the neighbourhood's order, at most 124; a, b: Coef.
extern "C" int dccrg_bulk_direct(int dtype, int flux, const void* const* in,
                                 void* out, const int* geom,
                                 const void* slots, int n_slots, float a,
                                 float b, int device, void* stream) {
  const Coef k = {a, b};
  if (dtype == 0)
    return launch_direct<float>(flux, in, out, geom, slots, n_slots, k,
                                device, stream);
  if (dtype == 1)
    return launch_direct<__nv_bfloat16>(flux, in, out, geom, slots, n_slots,
                                        k, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_bulk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
