// Kernel A's direct route and kernel A''s slot-table route, as templates
// over a flux functor: the named device fluxes of fluxes.cuh through
// `Named` (kernel A, bulk_pass.cu) and `NamedFleet` (kernel A',
// fleet_bulk_pass.cu), and any flux that ops/flux_gen.py generates from
// a user SlotwiseKernel's slot functions.
//
// A functor F states:
// - kIn fields read (field 0 first) and kOut written, each in its own
//   storage type: F::load_cell / F::load_nbr read a row's fields as
//   float32 values (load_nbr only the fields the flux reads at a
//   neighbour), F::store writes the outputs' float32 values (already
//   rounded to their storage) and, on the slot-table route, F::copy a
//   row's output words unchanged (a frozen fleet slot, the zero row);
// - a Carry of registers, F::init / F::slot / F::finish over it: slot
//   j's neighbour values (+0.0 where the slot is masked), its table
//   row's `code`, its `offs_const` row `o` (when kOffs) and its mask;
// - Params, passed by value to the launch (the named fluxes' Coef, a
//   generated flux's host scalars), and a pointer to the row of
//   per-slot extras of a fleet slot (null on kernel A); on the
//   slot-table route F::fleet_params(k, ex) gives the Params a fleet
//   slot's thread uses (a named flux's Coef from its extras);
// - kPadRows: rows [n0, L) are computed as cells with every slot masked
//   (a generated flux: the plain path runs its slot functions there);
//   without it they are left to the caller.
//
// Direct route (kernel A): a thread owns one (x, y) column and walks a
// chunk of kDirectZ consecutive z-planes of it; the slot table (at most
// 124 slots, from a device buffer) is staged in shared memory once a
// block with each slot's flat row offset. A cell at least the table's
// reach inside the grid on every axis reads each neighbour at its row
// plus that offset, with no wrap and no mask (every warp but those at
// the faces); the rest wrap each coordinate (fluxes::wrap). The slot
// loop runs in the table's order, unrolled by four. With kPadRows one
// more layer of blocks takes the pad rows.
//
// Slot-table route (kernel A'): one cell per thread marching kChunkZ
// planes of z of one bucket slot, the table in shared memory with each
// slot's flat row offset and the table's reach (taken from the table by
// each block). A warp is 32 cells of one row: a row at least the reach
// inside the grid along y and z reads each neighbour at its row plus the
// slot's offset, x wrapped once by a select (kRow); the rest read every
// neighbour at its wrapped coordinate; blocks past the grid's work
// items take rows [n0, R) of every slot (pad rows computed with every
// slot masked, the zero row copied) and a frozen slot's blocks copy
// its rows.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "fluxes.cuh"
#include "flux_rt.cuh"

namespace direct {

using fluxes::wrap;

constexpr int kMaxSlots = 124;  // the cube of a neighbourhood of length 2
constexpr int kDirectZ = 8;     // direct route: z-planes a thread walks
constexpr int kThreads = 256;
constexpr int kMaxFields = 8;
constexpr int kChunkZ = 16;               // slot-table route: z planes
constexpr int kDirY = kThreads / 32;      // rows of a block
constexpr int kMaxTailBlocks = 1024;

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int rx, ry, rz;  // the slot table's reach per axis
  long long n0;    // grid cells (rows [0, n0) are grid order)
  long long L;     // rows written (n0 + pad rows)
};

struct Ptrs {
  const void* in[kMaxFields];
  void* out[kMaxFields];
  const void* prev[kMaxFields];  // a fleet slot's old output rows
};

// The named device fluxes of fluxes.cuh (storage T for every field, one
// output, field 0) in the functor form.
template <typename T, typename Fl>
struct Named {
  static constexpr int kIn = Fl::kFields;
  static constexpr int kOut = 1;
  static constexpr bool kOffs = false;
  static constexpr bool kPadRows = false;
  using Params = fluxes::Coef;
  struct Carry {
    float r;
  };
  __device__ __forceinline__ static void load_cell(const void* const* in,
                                                   long long i,
                                                   float (&v)[kIn]) {
#pragma unroll
    for (int q = 0; q < kIn; ++q)
      v[q] = fluxes::Store<T>::load(static_cast<const T*>(in[q])[i]);
  }
  __device__ __forceinline__ static void load_nbr(const void* const* in,
                                                  long long i,
                                                  float (&v)[kIn]) {
    load_cell(in, i, v);
  }
  __device__ __forceinline__ static void init(Carry& a, const float (&)[kIn],
                                              const Params&, const float*) {
    a.r = 0.f;
  }
  __device__ __forceinline__ static void slot(Carry& a, const float (&c)[kIn],
                                              const float (&n)[kIn], int code,
                                              const int*, bool valid,
                                              const Params& k, const float*) {
    a.r = Fl::template add<T>(a.r, c, n, valid, code, k);
  }
  __device__ __forceinline__ static void finish(float (&o)[kOut],
                                                const Carry& a,
                                                const float (&c)[kIn],
                                                const Params& k,
                                                const float*) {
    o[0] = Fl::template finish<T>(c, a.r, k);
  }
  __device__ __forceinline__ static void store(void* const* out, long long i,
                                               const float (&o)[kOut]) {
    static_cast<T*>(out[0])[i] = fluxes::Store<T>::pack(o[0]);
  }
};

// A named flux on kernel A''s slot-table route: its Coef is the fleet
// slot's extras column 0 (dt or cfl), read once a thread
// (fleet_params); a frozen slot's rows are copied as raw words.
template <typename T, typename Fl>
struct NamedFleet : Named<T, Fl> {
  static constexpr int kIn = Fl::kFields;
  using Params = fluxes::Coef;
  __device__ __forceinline__ static Params fleet_params(const Params&,
                                                        const float* ex) {
    return {ex[0], 0.f};
  }
  __device__ __forceinline__ static void copy(const void* const* prev,
                                              void* const* out, long long i) {
    using Bits = typename fluxes::Store<T>::Bits;
    static_cast<Bits*>(out[0])[i] = static_cast<const Bits*>(prev[0])[i];
  }
};

// A generated functor (ops/flux_gen.py) in the template's form: its
// slot reads no table code, its pad rows are computed, and its per-slot
// extras are read where its functions read them.
template <typename G>
struct Generated : G {
  static constexpr bool kPadRows = true;
  __device__ __forceinline__ static typename G::Params fleet_params(
      const typename G::Params& k, const float*) {
    return k;
  }
  __device__ __forceinline__ static void slot(typename G::Carry& a,
                                              const float (&c)[G::kIn],
                                              const float (&n)[G::kIn], int,
                                              const int* o, bool m,
                                              const typename G::Params& k,
                                              const float* ex) {
    G::slot(a, c, n, o, m, k, ex);
  }
};

// how a cell reads its neighbours: at its row plus the slot's flat
// offset (inside the grid by the table's reach), the same with x wrapped
// once by a select (kRow: y and z inside by the reach, x any, the reach
// along x at most nx), at its wrapped coordinate, or none (a pad row:
// every slot masked)
enum Mode { kInterior, kRow, kEdge, kPad };

// one cell of row f at (gx, gy, gz): its slots in the table's order
template <typename F, Mode M>
__device__ __forceinline__ void cell(const Ptrs& p, const Geom& g,
                                     long long f, int gx, int gy, int gz,
                                     const int4* tab, const long long* dl,
                                     const int4* oc, int n_slots,
                                     const typename F::Params& k,
                                     const float* ex) {
  constexpr int NI = F::kIn;
  const long long nxy = (long long)g.nx * g.ny;
  float c[NI];
  F::load_cell(p.in, f, c);
  typename F::Carry acc;
  F::init(acc, c, k, ex);
  if (M == kInterior) {
#pragma unroll 4
    for (int j = 0; j < n_slots; ++j) {
      float n[NI];
      F::load_nbr(p.in, f + dl[j], n);
      int o[3] = {0, 0, 0};
      if (F::kOffs) {
        o[0] = oc[j].x; o[1] = oc[j].y; o[2] = oc[j].z;
      }
      F::slot(acc, c, n, tab[j].w, o, true, k, ex);
    }
  } else if (M == kRow) {
#pragma unroll 4
    for (int j = 0; j < n_slots; ++j) {
      const int4 e = tab[j];
      const int tx = gx + e.x;
      const bool lo = tx < 0, hi = tx >= g.nx;
      const bool valid = (!lo && !hi) || g.px;
      float n[NI];
#pragma unroll
      for (int q = 0; q < NI; ++q) n[q] = 0.f;
      if (valid)
        F::load_nbr(p.in, f + dl[j] + (lo ? g.nx : hi ? -g.nx : 0), n);
      int o[3] = {0, 0, 0};
      if (F::kOffs) {
        o[0] = oc[j].x; o[1] = oc[j].y; o[2] = oc[j].z;
      }
      F::slot(acc, c, n, e.w, o, valid, k, ex);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < n_slots; ++j) {
      const int4 e = tab[j];
      int tx = gx + e.x, ty = gy + e.y, tz = gz + e.z;
      const bool valid = M == kEdge && wrap(tx, g.nx, g.px) &&
                         wrap(ty, g.ny, g.py) && wrap(tz, g.nz, g.pz);
      float n[NI];
#pragma unroll
      for (int q = 0; q < NI; ++q) n[q] = 0.f;
      if (valid) F::load_nbr(p.in, tx + (long long)g.nx * ty + nxy * tz, n);
      int o[3] = {0, 0, 0};
      if (F::kOffs) {
        o[0] = oc[j].x; o[1] = oc[j].y; o[2] = oc[j].z;
      }
      F::slot(acc, c, n, e.w, o, valid, k, ex);
    }
  }
  float out[F::kOut];
  F::finish(out, acc, c, k, ex);
  F::store(p.out, f, out);
}

// kernel A's direct route; with F::kPadRows and pad rows (L > n0) one
// more layer of blocks (blockIdx.z == gridDim.z - 1) takes rows [n0, L)
template <typename F>
__global__ void __launch_bounds__(kThreads)
bulk_direct(const Ptrs p, const Geom g, const int4* __restrict__ slots,
            const int4* __restrict__ offs, const int n_slots,
            const typename F::Params k) {
  __shared__ int4 tab[kMaxSlots];
  __shared__ long long dl[kMaxSlots];  // each slot's flat row offset
  __shared__ int4 oc[F::kOffs ? kMaxSlots : 1];
  const long long nxy = (long long)g.nx * g.ny;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  for (int j = tid; j < n_slots; j += kThreads) {
    const int4 e = slots[j];
    tab[j] = e;
    dl[j] = e.x + (long long)g.nx * e.y + nxy * e.z;
    if (F::kOffs) oc[j] = offs[j];
  }
  __syncthreads();
  if (F::kPadRows && g.L > g.n0 && blockIdx.z == gridDim.z - 1) {
    // pad rows: every slot masked
    const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
    for (long long f = g.n0 + tid + (long long)kThreads *
                                        (blockIdx.x + gridDim.x * blockIdx.y);
         f < g.L; f += stride)
      cell<F, kPad>(p, g, f, 0, 0, 0, tab, dl, oc, n_slots, k, nullptr);
    return;
  }
  const int gx = blockIdx.x * 32 + threadIdx.x;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y;
  if (gx >= g.nx || gy >= g.ny) return;
  const bool in_xy = gx >= g.rx && gx < g.nx - g.rx && gy >= g.ry &&
                     gy < g.ny - g.ry;
  const int z0 = blockIdx.z * kDirectZ;
  const int z1 = min(z0 + kDirectZ, g.nz);
  for (int gz = z0; gz < z1; ++gz) {
    const long long f = gx + (long long)g.nx * gy + nxy * gz;
    if (in_xy && gz >= g.rz && gz < g.nz - g.rz)
      cell<F, kInterior>(p, g, f, gx, gy, gz, tab, dl, oc, n_slots, k,
                         nullptr);
    else
      cell<F, kEdge>(p, g, f, gx, gy, gz, tab, dl, oc, n_slots, k, nullptr);
  }
}

// geom: nx, ny, nz, px, py, pz, rx, ry, rz
inline bool read_geom(const int* gi, long long n0, long long L, Geom& g) {
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.rx = gi[6]; g.ry = gi[7]; g.rz = gi[8];
  g.n0 = n0; g.L = L;
  return g.nx >= 1 && g.ny >= 1 && g.nz >= 1 && g.rx >= 0 && g.ry >= 0 &&
         g.rz >= 0 && n0 == (long long)g.nx * g.ny * g.nz && L >= n0;
}

template <typename F>
int launch_direct(const Ptrs& p, const int* gi, long long n0, long long L,
                  const void* slots, const void* offs, int n_slots,
                  const typename F::Params& k, int device, void* stream) {
  Geom g;
  if (!read_geom(gi, n0, L, g) || n_slots < 0 || n_slots > kMaxSlots ||
      (n_slots > 0 && slots == nullptr) ||
      (F::kOffs && n_slots > 0 && offs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const bool pad = F::kPadRows && L > n0;
  const dim3 grid((g.nx + 31) / 32, (g.ny + kThreads / 32 - 1) /
                  (kThreads / 32), (g.nz + kDirectZ - 1) / kDirectZ + pad);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  bulk_direct<F><<<grid, dim3(32, kThreads / 32), 0, (cudaStream_t)stream>>>(
      p, g, (const int4*)slots, (const int4*)offs, n_slots, k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// kernel A''s slot-table route
// ---------------------------------------------------------------------

struct FleetGeom {
  Geom g;
  int B;            // bucket slots
  int E;            // extras a slot (columns of `extras`)
  long long R;      // row stride (L + 1)
  int n_main;       // blocks of grid cells; the rest take rows [n0, R)
  int per_slot;     // work items of one slot
  int dtx, dty;     // tiles of a plane along x and y
};

__device__ __forceinline__ bool frozen(const int* budget, int b, int step) {
  return budget != nullptr && budget[b] <= step;
}

// the pointers of bucket slot b (rows at b * R)
template <typename F>
__device__ __forceinline__ Ptrs slot_ptrs(const Ptrs& p, long long base,
                                          const int* isz, const int* osz) {
  Ptrs q;
#pragma unroll
  for (int i = 0; i < F::kIn; ++i)
    q.in[i] = static_cast<const char*>(p.in[i]) + base * isz[i];
#pragma unroll
  for (int i = 0; i < F::kOut; ++i) {
    q.out[i] = static_cast<char*>(p.out[i]) + base * osz[i];
    q.prev[i] = static_cast<const char*>(p.prev[i]) + base * osz[i];
  }
  return q;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
fleet_slots(const Ptrs p, const FleetGeom fg, const int4* __restrict__ slots,
            const int4* __restrict__ offs, const int n_slots,
            const float* __restrict__ extras, const int* __restrict__ budget,
            const int step, const typename F::Params k, const int4 isz4,
            const int4 isz8, const int4 osz4, const int4 osz8) {
  __shared__ int4 tab[kMaxSlots];
  __shared__ long long dl[kMaxSlots];
  __shared__ int4 oc[F::kOffs ? kMaxSlots : 1];
  const Geom& g = fg.g;
  const int isz[8] = {isz4.x, isz4.y, isz4.z, isz4.w,
                      isz8.x, isz8.y, isz8.z, isz8.w};
  const int osz[8] = {osz4.x, osz4.y, osz4.z, osz4.w,
                      osz8.x, osz8.y, osz8.z, osz8.w};
  __shared__ int reach[3];  // the table's reach along x, y, z
  const long long nxy = (long long)g.nx * g.ny;
  if (threadIdx.x < 3) reach[threadIdx.x] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n_slots; j += kThreads) {
    const int4 e = slots[j];
    tab[j] = e;
    dl[j] = e.x + (long long)g.nx * e.y + nxy * e.z;
    if (F::kOffs) oc[j] = offs[j];
    atomicMax(&reach[0], abs(e.x));
    atomicMax(&reach[1], abs(e.y));
    atomicMax(&reach[2], abs(e.z));
  }
  __syncthreads();
  if ((int)blockIdx.x >= fg.n_main) {
    // rows [n0, R) of every slot: pad rows computed with every slot
    // masked, the zero row (and a frozen slot's rows) copied
    const long long per = fg.R - g.n0;
    const long long total = (long long)fg.B * per;
    const long long stride = (long long)(gridDim.x - fg.n_main) * kThreads;
    for (long long i = (long long)(blockIdx.x - fg.n_main) * kThreads +
                       threadIdx.x;
         i < total; i += stride) {
      const int b = (int)(i / per);
      const long long r = g.n0 + (i - (long long)b * per);
      const Ptrs q = slot_ptrs<F>(p, (long long)b * fg.R, isz, osz);
      if (r < g.L && !frozen(budget, b, step))
        cell<F, kPad>(q, g, r, 0, 0, 0, tab, dl, oc, n_slots,
                      F::fleet_params(k, extras + (long long)b * fg.E),
                      extras + (long long)b * fg.E);
      else
        F::copy(q.prev, q.out, r);
    }
    return;
  }
  const int w = blockIdx.x;
  const int b = w / fg.per_slot;
  int item = w - b * fg.per_slot;
  const int tz = item / (fg.dtx * fg.dty);
  item -= tz * fg.dtx * fg.dty;
  const int ty = item / fg.dtx;
  const int gx = (item - ty * fg.dtx) * 32 + threadIdx.x % 32;
  const int gy = ty * kDirY + threadIdx.x / 32;
  if (gx >= g.nx || gy >= g.ny) return;
  const int z0 = tz * kChunkZ;
  const int z1 = min(z0 + kChunkZ, g.nz);
  const long long col = gx + (long long)g.nx * gy;
  const Ptrs q = slot_ptrs<F>(p, (long long)b * fg.R, isz, osz);
  if (frozen(budget, b, step)) {
    for (int z = z0; z < z1; ++z) F::copy(q.prev, q.out, col + nxy * z);
    return;
  }
  const float* ex = extras + (long long)b * fg.E;
  const typename F::Params kb = F::fleet_params(k, ex);
  // a warp is one row of y of one plane: the test is uniform across it
  const bool row_y = reach[0] <= g.nx && gy >= reach[1] &&
                     gy < g.ny - reach[1];
  for (int z = z0; z < z1; ++z) {
    if (row_y && z >= reach[2] && z < g.nz - reach[2])
      cell<F, kRow>(q, g, col + nxy * z, gx, gy, z, tab, dl, oc, n_slots, kb,
                    ex);
    else
      cell<F, kEdge>(q, g, col + nxy * z, gx, gy, z, tab, dl, oc, n_slots,
                     kb, ex);
  }
}

// sizes: bytes of an element of each field in / out
template <typename F>
int launch_fleet(const Ptrs& p, const int* gi, long long n0, long long L,
                 long long R, int B, int E, const void* slots,
                 const void* offs, int n_slots, const float* extras,
                 const int* budget, int step, const int* in_sizes,
                 const int* out_sizes, const typename F::Params& k,
                 int device, void* stream) {
  FleetGeom fg = {};
  if (!read_geom(gi, n0, L, fg.g) || B < 1 || E < 0 || R != L + 1 ||
      n_slots < 0 || n_slots > kMaxSlots ||
      (n_slots > 0 && slots == nullptr) ||
      (F::kOffs && n_slots > 0 && offs == nullptr) ||
      (E > 0 && extras == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  fg.B = B; fg.E = E; fg.R = R;
  fg.dtx = (fg.g.nx + 31) / 32;
  fg.dty = (fg.g.ny + kDirY - 1) / kDirY;
  const long long per =
      (long long)fg.dtx * fg.dty * ((fg.g.nz + kChunkZ - 1) / kChunkZ);
  const long long n_main = (long long)B * per;
  const long long tail = ((long long)B * (R - n0) + kThreads - 1) / kThreads;
  const int n_tail = tail < kMaxTailBlocks ? (int)tail : kMaxTailBlocks;
  if (per > INT_MAX || n_main + n_tail > INT_MAX)
    return (int)cudaErrorInvalidValue;
  fg.per_slot = (int)per;
  fg.n_main = (int)n_main;
  int s[32] = {0};
  for (int i = 0; i < F::kIn; ++i) s[i] = in_sizes[i];
  for (int i = 0; i < F::kOut; ++i) s[8 + i] = out_sizes[i];
  fleet_slots<F><<<(unsigned)(n_main + n_tail), kThreads, 0,
                   (cudaStream_t)stream>>>(
      p, fg, (const int4*)slots, (const int4*)offs, n_slots, extras, budget,
      step, k, make_int4(s[0], s[1], s[2], s[3]),
      make_int4(s[4], s[5], s[6], s[7]), make_int4(s[8], s[9], s[10], s[11]),
      make_int4(s[12], s[13], s[14], s[15]));
  return (int)cudaGetLastError();
}

}  // namespace direct
