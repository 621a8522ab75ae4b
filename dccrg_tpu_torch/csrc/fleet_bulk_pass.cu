// Batched bulk pass of the fleet (kernel A'): one step of a fleet
// kernel's slot-wise twin over B independent grids of one bucket, with
// the per-slot budget freeze.
//
// Replaces the Pallas kernel `make_bulk_pass(..., batch=B)` that
// `make_fleet_bulk_step` builds (dccrg_tpu/ops/roll_executor.py:707,
// pallas_call at :347). That kernel adds a leading slot axis to the
// [G, 8, 128] flat-window grid of kernel A, reads each slot's extras
// from a [B, E] block, leaves the rows whose flat roll crosses a
// periodic wrap wrong and lets a vmapped fixup epilogue repair them;
// the reference's fori_loop then keeps the old bytes of every slot
// whose budget is spent (dccrg_tpu/fleet.py:569-582). Here rows are
// grid order (flat = x + nx*(y + ny*z)) on a single-device closed-form
// plan and every neighbour is read at its 3-D position: periodic axes
// wrap exactly, non-periodic ones mask from the cell's coordinates as
// grid._synth_col does, and every row comes out right. No epilogue
// runs after it, and the freeze runs inside it: one launch is one
// fleet step.
//
// Layout: `state` is the fleet's [B, R] field with row stride R
// (R = L + 1: n0 grid cells, L - n0 capacity pad rows, one zero row);
// slot b's rows start at b*R, which is not 16-byte aligned for most b
// (R is odd whenever L is even). The pass writes all R rows of every
// slot of a new [B, R] tensor. `extras` is the [B, E] float32 per-slot
// parameter block on the device (column 0 read: dt or cfl); `budget`
// the int32 [B] step budgets, or null when every slot is live. A slot
// with budget[b] <= step is frozen: its rows are copied as raw 16- or
// 32-bit words, so NaN payloads, -0.0 and bf16 bit patterns stay
// exactly, as torch.where keeps them.
//
// Bound on the H100: bytes. At 128 slots x 64^3 float32 one step reads
// and writes 2 * 33.55M floats, 268 MB, 80.1 us at 3.35 TB/s. The
// ordered chain of a `diffuse` cell is 52 separate FADDs (26 n - c, 26
// partial sums; the finish adds a multiply and an add), 1.74G FADDs a
// step, 52 us at the 128 FP32 lanes a clock of 132 SMs; with the loads
// and the address arithmetic the instructions issued come close to the
// bytes' time, so the design keeps both few and overlaps them.
//
// Three routes, each in one launch with the pad rows and the zero row
// (blocks past the grid's work items take those rows, and a frozen
// slot's blocks copy its rows). The 26-cube of the default
// neighbourhood of length 1 (the fleet's default `hood_len`) takes the
// plane route or the direct route, both unrolled over the cube; any
// other neighbourhood (a bucket of `hood_len` 0 or 2) the slot-table
// route:
//
// Planes (fleet_planes), for x extents up to 256 that are a multiple
// of V = 16 bytes' elements (the fleet's buckets). A block owns one
// slot's band of `by` rows of y, the whole x extent, and marches a
// chunk of z (the longest of 64, 32, 16 planes that still gives three
// blocks an SM: fewer re-staged halo planes and block start-ups). Each
// z-plane of the band, with one halo row in y on each side, is staged
// in shared memory by cp.async 16-byte copies in a ring of kStages
// planes, three in flight ahead of the one being read. Slot bases are not 16-byte aligned, but with nx a
// multiple of V every row of a slot lies at the same offset from a
// chunk boundary (the slot base's), so each run of rows is copied as
// the aligned chunks that cover it and read at that one offset; the
// chunk that would pass the end of the allocation is cut short
// (cp.async's source size) and zero-filled. Periodic x wraps are
// indices into the staged row, periodic y and z wraps are the rows and
// planes staged. A thread computes kCellsY cells consecutive in y at
// one x (lanes along x: conflict-free shared reads), keeps the
// 3 x (kCellsY + 2) patches of planes z-1 and z in registers and reads
// only the new plane's patch per step (4.5 shared reads a cell),
// rotating the three patch buffers by unrolling the march three-fold
// instead of moving registers. The cells' ordered chains are
// independent, so they interleave. A grid with a non-periodic axis
// takes an instantiation that masks each term; an all-periodic one
// masks nothing.
//
// Direct (fleet_direct), for every other x extent or an unaligned
// allocation: one cell per thread marching 16 planes of z with the 3x3
// patches of planes z-1 and z in registers and the new patch read
// through the cache.
//
// Slot table, for any other neighbourhood: the slot-table template of
// bulk_direct.cuh (direct::launch_fleet, the route a generated flux
// takes too) over the flux in its fleet form (direct::NamedFleet): one
// cell per thread marching 16 planes of z, the flux's slot table (the
// slots it reads, in hood.offs_const order: at most 124, diffuse's at
// length 2; from a device buffer) staged in shared memory with each
// slot's flat row offset. A warp (32 cells of one row) whose row lies
// the table's reach inside the grid along y and z reads each neighbour
// at its row plus that offset, x wrapped once by a select; the others
// read every neighbour at its wrapped coordinate (wrap(): a reach of 2
// crosses an extent of 1 or 2 more than once).
//
// The flux is a compile-time functor (csrc/fluxes.cuh), with the
// arithmetic of the twins in dccrg_tpu_torch/fleet.py (the reference's
// fleet.py:208-236) in the same order:
//   diffuse:  acc += valid_j ? (n_j - c) : 0;       out = c + dt*acc
//   advect_x: acc += (up_j && valid_j) ? n_j : 0;   out = (1-cfl)*c + cfl*acc
// with up_j true for the slot (-1, 0, 0) only on the cube (the twin's
// test ox < 0, oy == 0, oz == 0; (-2, 0, 0) too at length 2). The slots
// are added in the neighbourhood's order (on the cube z-major, x
// fastest: the order of hood.offs_const, which the wrapper checks).
// The plane and slot-table routes leave out the terms a flux never
// reads: each adds an exact +0.0 to a sum
// that starts at +0.0 and so is never -0.0, which changes no bit.
// Storage is float32 or bfloat16; `n_j - c` and every partial sum are
// rounded to the storage type, as PyTorch's bfloat16 arithmetic rounds
// them, and the finish runs in float32 (the reference promotes
// bf16 * float32 to float32) with one rounding at the store. Built
// with --fmad=false, so the pass equals its plain PyTorch version bit
// for bit.
//
// C entry point: dccrg_fleet_bulk(); returns cudaGetLastError() of the
// launch (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "bulk_direct.cuh"
#include "fluxes.cuh"

namespace {

using namespace fluxes;

constexpr int kThreads = 256;
constexpr int kMaxTailBlocks = 1024;
// plane route
constexpr int kMaxPlaneX = 256;      // widest x extent
constexpr int kCellsY = 4;           // cells a thread computes, along y
constexpr int kStages = 4;           // planes in the ring
constexpr int kChunksPerThread = 2;  // 16-byte chunks a thread stages
constexpr int kPlaneChunks[3] = {64, 32, 16};  // z chunks, longest first
constexpr int kMinBlocksPerSM = 3;   // blocks a z chunk must leave an SM
constexpr int kCopyDepth = 16;       // loads in flight of a frozen copy
// direct route
constexpr int kChunkZ = 16;          // z planes a thread marches
constexpr int kDirY = kThreads / 32; // rows of a block

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int B;           // slots
  int E;           // extras per slot (columns of `extras`)
  long long n0;    // grid cells per slot
  long long L;     // rows per slot written by the flux (n0 + pad)
  long long R;     // row stride (L + 1)
  long long total; // B * R, the allocation's elements
  int n_main;      // blocks of grid cells; the rest take rows [n0, R)
  int per_slot;    // work items of one slot
  // plane route
  int tx, ty;      // threads along x (a multiple of 32) and along y
  int by;          // rows of a band (kCellsY * ty)
  int win1;        // ring-slot region of a halo row (elements)
  int win_main;    // ring-slot region of a band's rows (elements)
  int zc;          // z planes a block marches
  int n_zc;        // z chunks of a slot
  // direct route
  int dtx, dty;    // tiles of a plane along x and y
};

// wrap() for a coordinate at most one period outside [0, n)
__device__ __forceinline__ bool wrap1(int& c, int n, int periodic) {
  if (c < 0) {
    c += n;
    return periodic;
  }
  if (c >= n) {
    c -= n;
    return periodic;
  }
  return true;
}

// 16-byte asynchronous copy to shared memory of the first `bytes`
// bytes of src; the rest of the 16 is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool frozen(const int* budget, int b, int step) {
  return budget != nullptr && budget[b] <= step;
}

// Rows [n0, R) of every slot, grid-strided over the tail blocks: pad
// rows have no valid neighbour, so the sum stays +0; the zero row
// (R - 1) and every row of a frozen slot are copied.
template <typename T, typename F>
__device__ void tail_rows(const T* __restrict__ in, T* __restrict__ out,
                          const float* __restrict__ extras,
                          const int* __restrict__ budget, int step,
                          const Geom& g) {
  using Bits = typename Store<T>::Bits;
  const long long per = g.R - g.n0;
  const long long total = (long long)g.B * per;
  const long long stride = (long long)(gridDim.x - g.n_main) * blockDim.x;
  for (long long i = (long long)(blockIdx.x - g.n_main) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int b = (int)(i / per);
    const long long r = g.n0 + (i - (long long)b * per);
    const long long at = b * g.R + r;
    if (r < g.L && !frozen(budget, b, step)) {
      const float c = Store<T>::load(in[at]);
      out[at] = Store<T>::pack(F::finish(c, 0.f, extras[(long long)b * g.E]));
    } else {
      reinterpret_cast<Bits*>(out)[at] =
          reinterpret_cast<const Bits*>(in)[at];
    }
  }
}

// ---------------------------------------------------------------------
// plane route
// ---------------------------------------------------------------------

constexpr int kPatchRows = kCellsY + 2;

// one plane's patches of a thread: rows y-1 .. y+kCellsY of the
// thread's cells, columns x-1, x, x+1; zv: the plane lies inside the
// grid (always, on a periodic z axis)
struct Patch {
  float v[kPatchRows][3];
  bool zv;
};

template <typename T, typename F, bool MASK>
__global__ void __launch_bounds__(kThreads, 2)
fleet_planes(const T* __restrict__ in, T* __restrict__ out,
             const float* __restrict__ extras,
             const int* __restrict__ budget, const int step, const Geom g) {
  using Bits = typename Store<T>::Bits;
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte chunk
  if ((int)blockIdx.x >= g.n_main) {
    tail_rows<T, F>(in, out, extras, budget, step, g);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int w = blockIdx.x;
  const int b = w / g.per_slot;
  const int item = w - b * g.per_slot;
  const int band = item / g.n_zc;
  const int y0 = band * g.by;
  const int z0 = (item - band * g.n_zc) * g.zc;
  const int np = min(g.zc, g.nz - z0);  // planes computed
  const int nyb = min(g.by, g.ny - y0);    // rows of the band
  const int nx = g.nx;
  const int nxy = nx * g.ny;
  const long long base = (long long)b * g.R;

  if (frozen(budget, b, step)) {
    // the band's rows of each plane are contiguous: copy them raw,
    // kCopyDepth loads in flight a thread
    const Bits* __restrict__ s = reinterpret_cast<const Bits*>(in) + base;
    Bits* __restrict__ d = reinterpret_cast<Bits*>(out) + base;
    const int seg = nyb * nx, n = np * seg;
    for (int e0 = threadIdx.x; e0 < n; e0 += kCopyDepth * kThreads) {
      Bits v[kCopyDepth];
      int o[kCopyDepth];
#pragma unroll
      for (int u = 0; u < kCopyDepth; ++u) {
        const int e = e0 + u * kThreads;
        const int z = e / seg;
        o[u] = (z0 + z) * nxy + y0 * nx + (e - z * seg);
        if (e < n) v[u] = s[o[u]];
      }
#pragma unroll
      for (int u = 0; u < kCopyDepth; ++u)
        if (e0 + u * kThreads < n) d[o[u]] = v[u];
    }
    return;
  }
  const float p = extras[(long long)b * g.E];

  // A staged plane holds three pieces, each a contiguous run of rows:
  // the top halo row (y0 - 1, wrapped), the band's rows and the bottom
  // halo row (y0 + nyb, wrapped), each in its own region of the ring
  // slot, copied as the aligned 16-byte chunks that cover it. nx is a
  // multiple of V, so every row of the slot starts at the same offset
  // `sh` from a chunk boundary (the slot base's), and a run of n
  // elements takes n / V + 1 chunks. Rows outside a non-periodic edge
  // are not staged: every term that would read them is masked. A
  // thread copies the same (at most kChunksPerThread) chunks of every
  // plane.
  const int sh = (int)(base & (V - 1));
  const int plane_sz = 2 * g.win1 + g.win_main;
  const int off_piece[3] = {0, g.win1, g.win1 + g.win_main};
  int gy_top = y0 - 1, gy_bot = y0 + nyb;
  const bool ok_top = wrap(gy_top, g.ny, g.py);
  const bool ok_bot = wrap(gy_bot, g.ny, g.py);
  const int c_halo = nx / V + 1, c_main = nyb * nx / V + 1;
  // per chunk: its source offset in the slot's plane and its offset in
  // the ring slot
  int ch_src[kChunksPerThread], ch_dst[kChunksPerThread];
  bool ch_ok[kChunksPerThread];
#pragma unroll
  for (int u = 0; u < kChunksPerThread; ++u) {
    int c = threadIdx.x + u * kThreads;
    int ro = gy_top * nx, dst = off_piece[0];
    bool ok = ok_top;
    if (c >= c_halo) {
      c -= c_halo;
      ro = y0 * nx;
      dst = off_piece[1];
      ok = true;
      if (c >= c_main) {
        c -= c_main;
        ro = gy_bot * nx;
        dst = off_piece[2];
        ok = ok_bot && c < c_halo;
      }
    }
    ch_src[u] = ro - sh + c * V;
    ch_dst[u] = dst + c * V;
    ch_ok[u] = ok;
  }
  const T* slot_in = in + base;
  // a chunk reaches at most V elements past its slot's grid rows, so
  // only the slots at the end of the allocation may need a short copy
  const bool clip = (long long)(g.B - 1 - b) * g.R < 2 * V;

  // stage plane k (z = z0 - 1 + k) into ring slot k % kStages
  auto stage = [&](int k) {
    int gz = z0 - 1 + k;
    if (!wrap1(gz, g.nz, g.pz)) return;  // masked plane: nothing to read
    T* st = smem + (k % kStages) * plane_sz;
    const int pzr = gz * nxy;
#pragma unroll
    for (int u = 0; u < kChunksPerThread; ++u) {
      if (!ch_ok[u]) continue;
      const int src = pzr + ch_src[u];
      int bytes = 16;
      if (clip) {
        const long long left = g.total - (base + src);
        bytes = left >= V ? 16 : (left > 0 ? (int)left * (int)sizeof(T) : 0);
      }
      cp_async16(st + ch_dst[u], bytes ? slot_in + src : in, bytes);
    }
  };

  // this thread's cells: x, rows y0 + ly .. y0 + ly + kCellsY - 1.
  // Threads past the grid compute clamped copies and store nothing.
  const int lx = threadIdx.x % g.tx, lt = threadIdx.x / g.tx;
  const bool act = lx < nx && lt < g.ty;
  const int x = min(lx, nx - 1);
  const int ly = min(lt, g.ty - 1) * kCellsY;
  int xm = x - 1, xp = x + 1;
  const bool xv[3] = {wrap(xm, nx, g.px), true, wrap(xp, nx, g.px)};
  if (!xv[0]) xm = x;
  if (!xv[2]) xp = x;
  // per patch row (band row ly - 1 + r): its validity and the offsets
  // of its x - 1, x, x + 1 in a ring slot
  bool yv[kPatchRows];
  int roff[kPatchRows][3];
#pragma unroll
  for (int r = 0; r < kPatchRows; ++r) {
    const int t = ly - 1 + r;  // -1 .. by
    int gy = y0 + t;
    yv[r] = wrap(gy, g.ny, g.py);
    const int row = sh + (t < 0 ? off_piece[0]
                                : (t < nyb ? off_piece[1] + t * nx
                                           : off_piece[2]));
    roff[r][0] = row + xm;
    roff[r][1] = row + x;
    roff[r][2] = row + xp;
  }

  // the thread's patch of plane k, read from the ring
  auto read = [&](Patch& P, int k) {
    int gz = z0 - 1 + k;
    P.zv = wrap1(gz, g.nz, g.pz);
    const T* st = smem + (k % kStages) * plane_sz;
#pragma unroll
    for (int r = 0; r < kPatchRows; ++r) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        bool used = false;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          used |= (r - dy >= 0 && r - dy < kCellsY &&
                   (F::reads_column(dx, dy) || (dx == 1 && dy == 1)));
        P.v[r][dx] = used ? Store<T>::load(st[roff[r][dx]]) : 0.f;
      }
    }
  };

  // plane z's cells from the patches of z-1, z, z+1
  auto compute = [&](const Patch& lo, const Patch& mid, const Patch& hi,
                     int z) {
    float acc[kCellsY], c[kCellsY];
#pragma unroll
    for (int j = 0; j < kCellsY; ++j) {
      c[j] = mid.v[j + 1][1];
      acc[j] = 0.f;
    }
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (dz == 1 && dy == 1 && dx == 1) continue;
          if (!F::reads(dx, dy, dz)) continue;
          const Patch& Q = dz == 0 ? lo : (dz == 1 ? mid : hi);
#pragma unroll
          for (int j = 0; j < kCellsY; ++j) {
            float t = F::template term<T>(c[j], Q.v[j + dy][dx]);
            if (MASK && !(Q.zv && yv[j + dy] && xv[dx])) t = 0.f;
            acc[j] = round_to<T>(acc[j] + t);
          }
        }
    if (!act) return;
    T* d = out + base + z * nxy + (y0 + ly) * nx + x;
    // one branch for a thread whose cells all lie in the band, so the
    // compiler keeps the cells' chains together (interleaved) rather
    // than sinking each into its own conditional store
    if (ly + kCellsY <= nyb) {
#pragma unroll
      for (int j = 0; j < kCellsY; ++j)
        d[j * nx] = Store<T>::pack(F::finish(c[j], acc[j], p));
    } else {
#pragma unroll
      for (int j = 0; j < kCellsY; ++j)
        if (ly + j < nyb)
          d[j * nx] = Store<T>::pack(F::finish(c[j], acc[j], p));
    }
  };

  const int NP = np + 2;  // planes staged: z0 - 1 .. z0 + np
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < NP) stage(k);
    cp_async_commit();
  }
  // wait for plane k; the slot of plane k - 1, read by every thread
  // before this barrier, takes plane k + kStages - 1
  auto advance = [&](Patch& P, int k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (k + kStages - 1 < NP) stage(k + kStages - 1);
    cp_async_commit();
    read(P, k);
  };
  Patch A, B, C;
  advance(A, 0);
  advance(B, 1);
  for (int k = 2; k < NP; k += 3) {
    advance(C, k);
    compute(A, B, C, z0 + k - 2);
    if (k + 1 >= NP) break;
    advance(A, k + 1);
    compute(B, C, A, z0 + k - 1);
    if (k + 2 >= NP) break;
    advance(B, k + 2);
    compute(C, A, B, z0 + k);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// direct route
// ---------------------------------------------------------------------

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

// A block is 32 cells along x by kDirY rows of y of one slot, and each
// thread marches its column through a chunk of kChunkZ planes.
template <typename T, typename F>
__global__ void __launch_bounds__(kThreads)
fleet_direct(const T* __restrict__ in, T* __restrict__ out,
             const float* __restrict__ extras,
             const int* __restrict__ budget, const int step, const Geom g) {
  using Bits = typename Store<T>::Bits;
  if ((int)blockIdx.x >= g.n_main) {
    tail_rows<T, F>(in, out, extras, budget, step, g);
    return;
  }
  const int w = blockIdx.x;
  const int b = w / g.per_slot;
  int item = w - b * g.per_slot;
  const int tz = item / (g.dtx * g.dty);
  item -= tz * g.dtx * g.dty;
  const int ty = item / g.dtx;
  const int gx = (item - ty * g.dtx) * 32 + threadIdx.x % 32;
  const int gy = ty * kDirY + threadIdx.x / 32;
  if (gx >= g.nx || gy >= g.ny) return;
  const int z0 = tz * kChunkZ;
  const int z1 = min(z0 + kChunkZ, g.nz);
  const long long nxy = (long long)g.nx * g.ny;
  const long long cell = gx + (long long)g.nx * gy;
  if (frozen(budget, b, step)) {
    const Bits* s = reinterpret_cast<const Bits*>(in) + b * g.R;
    Bits* d = reinterpret_cast<Bits*>(out) + b * g.R;
    for (int z = z0; z < z1; ++z) d[cell + nxy * z] = s[cell + nxy * z];
    return;
  }
  // wrapped coordinates (as row offsets) and validity of x-1, x, x+1
  // and y-1, y, y+1
  long long xo[3], yo[3];
  bool xv[3], yv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    int tx = gx + d - 1, tyy = gy + d - 1;
    xv[d] = wrap(tx, g.nx, g.px);
    yv[d] = wrap(tyy, g.ny, g.py);
    xo[d] = tx;
    yo[d] = (long long)g.nx * tyy;
  }
  const T* src = in + b * g.R;
  T* dst = out + b * g.R;
  const float p = extras[(long long)b * g.E];
  // planes z-1 and z in registers; plane z+1 is loaded per step
  float lo[9], mid[9], hi[9];
  int zz = z0 - 1;
  bool zv_lo = wrap(zz, g.nz, g.pz);
  load_plane<T, F>(lo, src, nxy * zz, zv_lo, xo, yo, xv, yv);
  load_plane<T, F>(mid, src, nxy * z0, true, xo, yo, xv, yv);
  for (int z = z0; z < z1; ++z) {
    zz = z + 1;
    const bool zv_hi = wrap(zz, g.nz, g.pz);
    load_plane<T, F>(hi, src, nxy * zz, zv_hi, xo, yo, xv, yv);
    const float c = mid[4];
    float acc = 0.f;
    add_plane<T, F>(acc, lo, 0, zv_lo, c, xv, yv);
    add_plane<T, F>(acc, mid, 1, true, c, xv, yv);
    add_plane<T, F>(acc, hi, 2, zv_hi, c, xv, yv);
    dst[cell + nxy * z] = Store<T>::pack(F::finish(c, acc, p));
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      lo[k] = mid[k];
      mid[k] = hi[k];
    }
    zv_lo = true;
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

// whether the plane route takes this grid and allocation
bool planes_fit(const Geom& g, const void* state, int itemsize) {
  return g.nx <= kMaxPlaneX && g.nx % (16 / itemsize) == 0 &&
         g.R < INT_MAX && (uintptr_t)state % 16 == 0;
}

int tail_blocks(const Geom& g) {
  const long long tail = (long long)g.B * (g.R - g.n0);
  const long long blocks = (tail + kThreads - 1) / kThreads;
  return blocks < kMaxTailBlocks ? (int)blocks : kMaxTailBlocks;
}

// the plane (0) and direct (1) routes
template <typename T, typename F>
int launch(const void* in, void* out, const float* extras, const int* budget,
           int step, Geom g, int route, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  long long n_main;
  if (route == 0) {
    if (!planes_fit(g, in, sizeof(T))) return (int)cudaErrorInvalidValue;
    constexpr int V = 16 / sizeof(T);
    g.tx = (g.nx + 31) / 32 * 32;
    g.ty = kThreads / g.tx;
    g.by = kCellsY * g.ty;
    // a run of n elements (a multiple of V) at any alignment spans at
    // most n / V + 1 chunks of V
    g.win1 = (g.nx / V + 1) * V;
    g.win_main = (g.by * g.nx / V + 1) * V;
    if ((2 * g.win1 + g.win_main) / V > kChunksPerThread * kThreads)
      return (int)cudaErrorInvalidValue;
    int sms = 0, dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long bands = (long long)g.B * ((g.ny + g.by - 1) / g.by);
    for (int zc : kPlaneChunks) {
      g.zc = zc;
      if (bands * ((g.nz + zc - 1) / zc) >= (long long)kMinBlocksPerSM * sms)
        break;
    }
    g.n_zc = (g.nz + g.zc - 1) / g.zc;
    const long long per = (long long)((g.ny + g.by - 1) / g.by) * g.n_zc;
    if (per > INT_MAX) return (int)cudaErrorInvalidValue;
    g.per_slot = (int)per;
  } else {
    g.dtx = (g.nx + 31) / 32;
    g.dty = (g.ny + kDirY - 1) / kDirY;
    const long long per =
        (long long)g.dtx * g.dty * ((g.nz + kChunkZ - 1) / kChunkZ);
    if (per > INT_MAX) return (int)cudaErrorInvalidValue;
    g.per_slot = (int)per;
  }
  n_main = (long long)g.B * g.per_slot;
  const int n_tail = tail_blocks(g);
  if (n_main + n_tail > INT_MAX) return (int)cudaErrorInvalidValue;
  g.n_main = (int)n_main;
  const unsigned blocks = (unsigned)(n_main + n_tail);
  if (route == 0) {
    const size_t smem =
        (size_t)kStages * (2 * g.win1 + g.win_main) * sizeof(T);
    if (g.px && g.py && g.pz)
      fleet_planes<T, F, false><<<blocks, kThreads, smem, st>>>(
          (const T*)in, (T*)out, extras, budget, step, g);
    else
      fleet_planes<T, F, true><<<blocks, kThreads, smem, st>>>(
          (const T*)in, (T*)out, extras, budget, step, g);
  } else {
    fleet_direct<T, F><<<blocks, kThreads, 0, st>>>(
        (const T*)in, (T*)out, extras, budget, step, g);
  }
  return (int)cudaGetLastError();
}

// the slot-table route (2): bulk_direct.cuh's template over the flux's
// fleet form
template <typename T, typename F>
int launch_slots(const void* in, void* out, const float* extras,
                 const int* budget, int step, const Geom& g,
                 const void* slots, int n_slots, int device, void* stream) {
  direct::Ptrs p = {};
  p.in[0] = in;
  p.out[0] = out;
  p.prev[0] = in;
  const int gi[9] = {g.nx, g.ny, g.nz, g.px, g.py, g.pz, 0, 0, 0};
  const int size = sizeof(T);
  return direct::launch_fleet<direct::NamedFleet<T, F>>(
      p, gi, g.n0, g.L, g.R, g.B, g.E, slots, nullptr, n_slots, extras,
      budget, step, &size, &size, {0.f, 0.f}, device, stream);
}

template <typename T, typename F>
int dispatch(const void* in, void* out, const float* extras,
             const int* budget, int step, const Geom& g, int route,
             const void* slots, int n_slots, int device, void* stream) {
  if (route == 2)
    return launch_slots<T, F>(in, out, extras, budget, step, g, slots,
                              n_slots, device, stream);
  return launch<T, F>(in, out, extras, budget, step, g, route, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (state and out the same type).
// flux: a functor's kCode (fluxes.cuh: 0 = diffuse, 1 = advect_x).
// route: 0 = planes, 1 = direct (both the 26-cube in its default
// order), 2 = the slot table `slots` (a device buffer of n_slots int4
// rows (ox, oy, oz, code) in the neighbourhood's order, at most 124;
// ignored by the other routes). geom: nx, ny, nz, px, py, pz, B, E.
// budget: int32 [B] or null (every slot live); a slot with
// budget[b] <= step is copied unchanged.
extern "C" int dccrg_fleet_bulk(int dtype, int flux, int route,
                                const void* state, void* out,
                                const float* extras, const int* budget,
                                int step, const int* geom, long long n0,
                                long long L, long long R, const void* slots,
                                int n_slots, int device, void* stream) {
  Geom g = {};
  g.nx = geom[0]; g.ny = geom[1]; g.nz = geom[2];
  g.px = geom[3]; g.py = geom[4]; g.pz = geom[5];
  g.B = geom[6]; g.E = geom[7];
  g.n0 = n0; g.L = L; g.R = R;
  g.total = (long long)g.B * R;
  if (g.nx < 1 || g.ny < 1 || g.nz < 1 || g.B < 1 || g.E < 1 ||
      n0 != (long long)g.nx * g.ny * g.nz || L < n0 || R != L + 1 ||
      route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0 && flux == 0)
    return dispatch<float, Diffuse>(state, out, extras, budget, step, g,
                                    route, slots, n_slots, device, stream);
  if (dtype == 0 && flux == 1)
    return dispatch<float, AdvectX>(state, out, extras, budget, step, g,
                                    route, slots, n_slots, device, stream);
  if (dtype == 1 && flux == 0)
    return dispatch<__nv_bfloat16, Diffuse>(state, out, extras, budget, step,
                                            g, route, slots, n_slots, device,
                                            stream);
  if (dtype == 1 && flux == 1)
    return dispatch<__nv_bfloat16, AdvectX>(state, out, extras, budget, step,
                                            g, route, slots, n_slots, device,
                                            stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_fleet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
