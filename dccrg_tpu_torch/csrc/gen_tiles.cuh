// Kernels A and A' over a generated flux whose slot table is compiled
// in: the tiled routes.
//
// ops/flux_gen.py writes a generated flux (GenFlux) and, since a grid's
// slot table is fixed for its life, the table itself (GenSlots: the
// reach per axis and every slot's call of the slot function unrolled in
// offs_const order, the cell offset and the offs_const row as template
// arguments and literals) into one source a (flux, table). These
// templates instantiate it: kernel A's tiled route (launch<G, S,
// false>, the counterpart of the direct route of bulk_direct.cuh, which
// replaces the reference's make_bulk_pass over a traced SlotwiseKernel,
// dccrg_tpu/ops/roll_executor.py:183, sub-steps :279-310) and kernel
// A''s (launch<G, S, true>, the counterpart of the slot-table route,
// replacing make_bulk_pass(batch=) via make_fleet_bulk_step, :707).
//
// Bound on the H100: bytes for most fluxes (each field read once and
// written once), operations for a heavy slot function over many slots.
// The runtime-table routes issued, a slot, a 64-bit offset load from
// shared memory and its address arithmetic, one global load a field
// read at the neighbour, the offs_const row's loads and the selects on
// it, and a runtime mask: instructions, not bytes, set their pace. Here
// the compiler sees the table, so a slot is its own arithmetic plus one
// shared load a field it reads at the neighbour, at a constant offset:
// the selects on offs and on a literal mask fold, and a neighbour value
// that goes unused is never read.
//
// A block of 256 threads, TX = S::kTX along x (32, a warp, or 64) and
// TY = 256 / TX along y, owns a TX x TY CY (x, y) tile of one grid
// (kernel A) or one bucket slot's grid (kernel A') and marches a chunk
// of zc planes of z; a thread computes CY cells consecutive along y
// (S::kCellsY), slot by slot, so that one shared load serves the cells
// that share a row and their ordered chains interleave. The form
// (kCellsY, kMinBlocks, kTX, kAsync) is ops/flux_gen.py's gen_form.
// Each field the flux reads at a neighbour (G::kStaged of them) is
// staged plane by plane, with a halo of the table's reach RX, RY along
// x and y, as float32 values (a bfloat16 field widened once, at the
// stage) in a ring of 2 RZ + 2 planes in shared memory: the 2 RZ + 1
// planes a cell of plane z reads, and the plane that lands while they
// are read. A plane is fetched before the cells of the current plane
// are computed and lands after them, one barrier a plane: into
// registers and stored into the ring after the compute, or (kAsync)
// each float32 element by a 4-byte cp.async straight into the ring,
// zero-filled outside a face (a bfloat16 field keeps the register
// path: cp.async copies 4, 8 or 16 bytes). Staging is element by
// element (coalesced along x), so a fleet slot's base, which is
// 16-byte aligned for few slots, and any extent need no special case,
// and a periodic wrap (any number of periods: a reach of 2 on an extent
// of 1 or 2) is resolved where a halo element is fetched. A position
// outside a non-periodic face is staged as +0.0, the value of a masked
// slot's neighbour. A cell whose every slot is valid (the block does
// not reach a non-periodic face within the reach) runs the slot
// sequence with the literal mask `true`; the others with each slot's
// mask from the cell's coordinates (EdgeValid). Pad rows [n0, L) run
// it with every slot masked in the blocks past the grid's work items,
// which on kernel A' also copy the zero row and a frozen slot's pad
// rows; a frozen slot's grid blocks copy its cells as raw words.
//
// The arithmetic of each slot and its order are the runtime-table
// functor's (the same GenFlux::slot, called in offs_const order), so
// both routes and the plain PyTorch pass agree bit for bit
// (--fmad=false). ops/roll_executor.py PassSpec.gen_tile and
// FleetPassSpec.gen_tile state the tile, the z chunk, the shared memory
// and the rule that picks this route.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "bulk_direct.cuh"

namespace tiles {

constexpr int kThreads = 256;        // a block: S::kTX along x, the rest y
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kMaxTailBlocks = 1024;

// The staged tile of a functor staging NS fields over a table of reach
// (RX, RY, RZ), TX threads along x and CY cells a thread along y: W x H
// positions a plane, a ring of NR planes, KP positions a thread stages.
template <int NS, int RX, int RY, int RZ, int CY, int TX>
struct Tile {
  static constexpr int TY = kThreads / TX;  // threads along y
  static constexpr int W = TX + 2 * RX;
  static constexpr int H = TY * CY + 2 * RY;
  static constexpr int HW = W * H;
  static constexpr int NR = 2 * RZ + 2;
  static constexpr int PLANE = NS * HW;  // floats of a staged plane
  static constexpr int KP = (HW + kThreads - 1) / kThreads;
  static constexpr int kSmem = NR * PLANE * 4;
};

struct Geom {
  int nx, ny, nz;    // grid extents
  int px, py, pz;    // periodic flags
  int zc;            // z planes a block marches
  int n_tx, n_ty;    // tiles along x and y
  int per_slot;      // work items of one grid (tiles times z chunks)
  int n_main;        // blocks of grid cells; the rest take rows [n0, R)
  int B, E;          // grids (bucket slots; 1 on kernel A), extras a slot
  long long n0;      // grid cells
  long long L;       // rows computed (n0 + pad rows)
  long long R;       // rows of a grid: L + 1 on kernel A' (the zero row)
};

// the neighbour values of a thread's cell y (of its CY along y): slot
// J's staged fields at the constant offset (OX, OY + y) of the ring
// plane of OZ, read at q[OZ + RZ] (that plane's position of cell 0)
template <typename G, typename T, int RZ>
struct TileNbr {
  const float* q[2 * RZ + 1];
  template <int J, int OX, int OY, int OZ>
  DCCRG_HD void get(int y, float (&n)[G::kIn]) const {
    float s[G::kStaged];
#pragma unroll
    for (int i = 0; i < G::kStaged; ++i)
      s[i] = q[OZ + RZ][i * T::HW + (OY + y) * T::W + OX];
#pragma unroll
    for (int i = 0; i < G::kIn; ++i) n[i] = 0.f;
    G::unstage(s, n);
  }
};

// a pad row's neighbours: every slot masked, +0.0
template <typename G>
struct ZeroNbr {
  template <int J, int OX, int OY, int OZ>
  DCCRG_HD void get(int, float (&n)[G::kIn]) const {
#pragma unroll
    for (int i = 0; i < G::kIn; ++i) n[i] = 0.f;
  }
};

struct AllValid {
  template <int J, int OX, int OY, int OZ>
  DCCRG_HD bool at(int) const { return true; }
};

struct NoneValid {
  template <int J, int OX, int OY, int OZ>
  DCCRG_HD bool at(int) const { return false; }
};

// a slot's mask from the coordinates of the thread's cell y: a periodic
// axis wraps any offset; a non-periodic one is valid inside the grid
struct EdgeValid {
  int x, y0, z, nx, ny, nz, px, py, pz;
  template <int J, int OX, int OY, int OZ>
  DCCRG_HD bool at(int y) const {
    return (px || (unsigned)(x + OX) < (unsigned)nx) &&
           (py || (unsigned)(y0 + y + OY) < (unsigned)ny) &&
           (pz || (unsigned)(z + OZ) < (unsigned)nz);
  }
};

// a 4-byte cp.async into shared memory, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

template <typename G, typename S, bool FLEET>
__global__ void __launch_bounds__(kThreads, S::kMinBlocks)
gen_tiles(const direct::Ptrs p, const Geom g, const typename G::Params k,
          const float* __restrict__ extras, const int* __restrict__ budget,
          const int step, const int4 isz4, const int4 isz8, const int4 osz4,
          const int4 osz8) {
  constexpr int RX = S::kRx, RY = S::kRy, RZ = S::kRz, CY = S::kCellsY;
  constexpr int TX = S::kTX;
  using T = Tile<G::kStaged, RX, RY, RZ, CY, TX>;
  constexpr int TY = T::TY;
  extern __shared__ float ring[];
  const int isz[8] = {isz4.x, isz4.y, isz4.z, isz4.w,
                      isz8.x, isz8.y, isz8.z, isz8.w};
  const int osz[8] = {osz4.x, osz4.y, osz4.z, osz4.w,
                      osz8.x, osz8.y, osz8.z, osz8.w};
  const int tid = threadIdx.x;
  const long long nxy = (long long)g.nx * g.ny;

  if ((int)blockIdx.x >= g.n_main) {
    // rows [n0, R) of every grid: pad rows with every slot masked; on
    // kernel A' the zero row and a frozen slot's rows copied
    const long long per = g.R - g.n0;
    const long long total = (long long)g.B * per;
    const long long stride = (long long)(gridDim.x - g.n_main) * kThreads;
    for (long long i = (long long)(blockIdx.x - g.n_main) * kThreads + tid;
         i < total; i += stride) {
      const int b = (int)(i / per);
      const long long r = g.n0 + (i - (long long)b * per);
      const direct::Ptrs q =
          FLEET ? direct::slot_ptrs<G>(p, (long long)b * g.R, isz, osz) : p;
      if (r < g.L && !(FLEET && direct::frozen(budget, b, step))) {
        const float* ex = FLEET ? extras + (long long)b * g.E : nullptr;
        float c[1][G::kIn];
        G::load_cell(q.in, r, c[0]);
        typename G::Carry a[1];
        G::init(a[0], c[0], k, ex);
        S::template run<G, 1>(a, c, k, ex, ZeroNbr<G>{}, NoneValid{});
        float o[G::kOut];
        G::finish(o, a[0], c[0], k, ex);
        G::store(q.out, r, o);
      } else if (FLEET) {
        G::copy(q.prev, q.out, r);
      }
    }
    return;
  }

  const int w = blockIdx.x;
  const int b = FLEET ? w / g.per_slot : 0;
  int item = w - b * g.per_slot;
  const int tz = item / (g.n_tx * g.n_ty);
  item -= tz * g.n_tx * g.n_ty;
  const int ty = item / g.n_tx;
  const int x0 = (item - ty * g.n_tx) * TX, y0 = ty * TY * CY;
  const int z0 = tz * g.zc;
  const int np = min(g.zc, g.nz - z0);
  const int lx = tid % TX, ly = (tid / TX) * CY;
  const int x = x0 + lx, y = y0 + ly;  // the thread's cells: y .. y + CY - 1
  const direct::Ptrs q =
      FLEET ? direct::slot_ptrs<G>(p, (long long)b * g.R, isz, osz) : p;
  if (FLEET && direct::frozen(budget, b, step)) {
    for (int j = 0; j < CY; ++j)
      if (x < g.nx && y + j < g.ny)
        for (int z = z0; z < z0 + np; ++z)
          G::copy(q.prev, q.out, x + (long long)g.nx * (y + j) + nxy * z);
    return;
  }
  const float* ex = FLEET ? extras + (long long)b * g.E : nullptr;

  // the positions this thread stages: their offset in a plane, -1
  // outside a non-periodic face (staged +0.0), -2 past the tile
  int src[T::KP];
#pragma unroll
  for (int i = 0; i < T::KP; ++i) {
    const int e = tid + i * kThreads;
    src[i] = -2;
    if (e < T::HW) {
      int cx = x0 - RX + e % T::W, cy = y0 - RY + e / T::W;
      const bool ok = fluxes::wrap(cx, g.nx, g.px) &&
                      fluxes::wrap(cy, g.ny, g.py);
      src[i] = ok ? cx + g.nx * cy : -1;
    }
  }
  // staged field s goes by cp.async (the async form, 4-byte storage)
  auto by_copy = [](int s) { return S::kAsync && G::staged_wide(s); };
  // plane j of the march (z = z0 - RZ + j): into registers, and from
  // them into ring slot j % NR; the async form's 4-byte fields straight
  // into the ring by cp.async (one group a plane)
  auto fetch = [&](int j, float (&v)[T::KP][G::kStaged]) {
    int gz = z0 - RZ + j;
    const bool zok = fluxes::wrap(gz, g.nz, g.pz);
    const long long pb = nxy * gz;
    if constexpr (S::kAsync) {
      float* d = ring + (j % T::NR) * T::PLANE + tid;
#pragma unroll
      for (int i = 0; i < T::KP; ++i) {
        const bool ok = zok && src[i] >= 0;
#pragma unroll
        for (int s = 0; s < G::kStaged; ++s) {
          const void* in = q.in[G::staged_field(s)];
          if (by_copy(s)) {
            if (src[i] != -2)
              cp_async4(d + s * T::HW + i * kThreads,
                        ok ? static_cast<const float*>(in) + pb + src[i]
                           : in,
                        ok ? 4 : 0);
          } else {
            v[i][s] = ok ? flux_rt::ld_bf16(in, pb + src[i]) : 0.f;
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
#pragma unroll
      for (int i = 0; i < T::KP; ++i) {
        if (zok && src[i] >= 0) {
          G::load_staged(q.in, pb + src[i], v[i]);
        } else {
#pragma unroll
          for (int s = 0; s < G::kStaged; ++s) v[i][s] = 0.f;
        }
      }
    }
  };
  auto put = [&](int j, const float (&v)[T::KP][G::kStaged]) {
    float* d = ring + (j % T::NR) * T::PLANE + tid;
#pragma unroll
    for (int i = 0; i < T::KP; ++i)
      if (src[i] != -2)
#pragma unroll
        for (int s = 0; s < G::kStaged; ++s)
          if (!by_copy(s)) d[s * T::HW + i * kThreads] = v[i][s];
    if constexpr (S::kAsync) asm volatile("cp.async.wait_all;\n" ::);
  };
  {
    float v[2 * RZ + 1][T::KP][G::kStaged];
#pragma unroll
    for (int j = 0; j < 2 * RZ + 1; ++j) fetch(j, v[j]);
#pragma unroll
    for (int j = 0; j < 2 * RZ + 1; ++j) put(j, v[j]);
  }
  __syncthreads();

  // every slot valid for every cell of the tile, unless the tile lies
  // within the reach of a non-periodic face along x or y
  const int xm = min(x0 + TX, g.nx) - 1, ym = min(y0 + TY * CY, g.ny) - 1;
  const bool edge_xy = (!g.px && (x0 < RX || xm + RX >= g.nx)) ||
                       (!g.py && (y0 < RY || ym + RY >= g.ny));
  const int at = (ly + RY) * T::W + lx + RX;  // cell 0 in a plane
  int r0 = 0;  // ring slot of plane it (z - RZ)
  for (int it = 0; it < np; ++it) {
    const bool more = it + 1 < np;
    float v[T::KP][G::kStaged];
    if (more) fetch(it + 2 * RZ + 1, v);
    if (x < g.nx && y < g.ny) {
      TileNbr<G, T, RZ> nb;
#pragma unroll
      for (int d = 0; d < 2 * RZ + 1; ++d) {
        const int s = r0 + d < T::NR ? r0 + d : r0 + d - T::NR;
        nb.q[d] = ring + s * T::PLANE + at;
      }
      const int z = z0 + it;
      const long long f = x + (long long)g.nx * y + nxy * z;
      float c[CY][G::kIn];
      typename G::Carry a[CY];
#pragma unroll
      for (int j = 0; j < CY; ++j) {
        // a row past the grid (its cells are computed, not stored)
        // reads no field beyond the staged ones
        if (y + j < g.ny) {
          G::load_unstaged(q.in, f + (long long)g.nx * j, c[j]);
        } else {
#pragma unroll
          for (int i = 0; i < G::kIn; ++i) c[j][i] = 0.f;
        }
        float s[G::kStaged];
#pragma unroll
        for (int i = 0; i < G::kStaged; ++i)
          s[i] = nb.q[RZ][i * T::HW + j * T::W];
        G::unstage(s, c[j]);
        G::init(a[j], c[j], k, ex);
      }
      if (edge_xy || (!g.pz && (z < RZ || z + RZ >= g.nz)))
        S::template run<G, CY>(a, c, k, ex, nb,
                               EdgeValid{x, y, z, g.nx, g.ny, g.nz, g.px,
                                         g.py, g.pz});
      else
        S::template run<G, CY>(a, c, k, ex, nb, AllValid{});
#pragma unroll
      for (int j = 0; j < CY; ++j) {
        float o[G::kOut];
        G::finish(o, a[j], c[j], k, ex);
        if (y + j < g.ny) G::store(q.out, f + (long long)g.nx * j, o);
      }
    }
    if (more) put(it + 2 * RZ + 1, v);
    __syncthreads();
    r0 = r0 + 1 == T::NR ? 0 : r0 + 1;
  }
}

// geom: nx, ny, nz, px, py, pz, zc. Kernel A: R == L, B == 1, no
// extras, budget or sizes; kernel A': R == L + 1, sizes: bytes of an
// element of each field in / out.
template <typename G, typename S, bool FLEET>
int launch(const direct::Ptrs& p, const int* gi, long long n0, long long L,
           long long R, int B, int E, const float* extras,
           const int* budget, int step, const int* in_sizes,
           const int* out_sizes, const typename G::Params& k, int device,
           void* stream) {
  using T = Tile<G::kStaged, S::kRx, S::kRy, S::kRz, S::kCellsY, S::kTX>;
  Geom g = {};
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.zc = gi[6];
  const long long nxy = (long long)g.nx * g.ny;
  if (g.nx < 1 || g.ny < 1 || g.nz < 1 || g.zc < 1 || nxy > INT_MAX ||
      n0 != nxy * g.nz || L < n0 || B < 1 || E < 0 ||
      R != (FLEET ? L + 1 : L) || (FLEET && E > 0 && extras == nullptr) ||
      T::kSmem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  g.n_tx = (g.nx + S::kTX - 1) / S::kTX;
  g.n_ty = (g.ny + T::TY * S::kCellsY - 1) / (T::TY * S::kCellsY);
  const long long per =
      (long long)g.n_tx * g.n_ty * ((g.nz + g.zc - 1) / g.zc);
  const long long n_main = per * B;
  const long long tail = ((long long)B * (R - n0) + kThreads - 1) / kThreads;
  const int n_tail = tail < kMaxTailBlocks ? (int)tail : kMaxTailBlocks;
  if (n_main + n_tail > INT_MAX) return (int)cudaErrorInvalidValue;
  g.per_slot = (int)per;
  g.n_main = (int)n_main;
  g.B = B; g.E = E;
  g.n0 = n0; g.L = L; g.R = R;
  int s[16] = {0};
  if (FLEET) {
    for (int i = 0; i < G::kIn; ++i) s[i] = in_sizes[i];
    for (int i = 0; i < G::kOut; ++i) s[8 + i] = out_sizes[i];
  }
  auto kern = gen_tiles<G, S, FLEET>;
  if (T::kSmem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(unsigned)(n_main + n_tail), kThreads, T::kSmem,
         (cudaStream_t)stream>>>(
      p, g, k, extras, budget, step, make_int4(s[0], s[1], s[2], s[3]),
      make_int4(s[4], s[5], s[6], s[7]), make_int4(s[8], s[9], s[10], s[11]),
      make_int4(s[12], s[13], s[14], s[15]));
  return (int)cudaGetLastError();
}

}  // namespace tiles
