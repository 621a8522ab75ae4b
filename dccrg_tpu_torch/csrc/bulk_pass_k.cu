// Temporally blocked bulk pass of the grid step loop: k sub-steps of the
// upwind advection flux over a single-device closed-form plan in one
// pass over device memory (DCCRG_BULK_SPP = k, 2..8).
//
// Replaces the k >= 2 form of the Pallas kernel `make_bulk_pass`
// (dccrg_tpu/ops/roll_executor.py:183; its sub-step loop :279-310). That
// kernel stages flat [G, 8, 128] windows with halos of k times the
// largest flat shift and applies the k sub-steps over shrinking row
// regions. Here rows are grid order (flat = x + nx*(y + ny*z)), so a
// block stages a 3-D window of the grid with a halo of k times the
// stencil's reach per axis and recomputes the halo over shrinking
// regions: sub-step t covers the interior plus k - t reaches, so the
// last one covers the interior alone, which is the only part written.
// Every window cell holds the value at its global coordinate modulo the
// extent on a periodic axis (a halo wider than the grid wraps more than
// once), and is zero beyond a non-periodic edge, where the slot's mask,
// taken from the unwrapped global coordinate, drops it. The carried
// density is rounded to the storage type after every sub-step, as the
// reference rounds its carry (`carry = res.astype(dtypes[f])`, :310);
// vx and vy are static and staged once.
//
// Bound on the H100: bytes, as for one step, but spread over k steps.
// At 512^3, float32, a pass reads 3 fields and writes 1: 4 * 2^27 * 4 B
// = 2.15 GB, 0.641 ms at 3.35 TB/s, 0.641 / k ms a step; the float ops
// the function needs grow with k (16 + 9k a cell, the face coefficients
// static over the pass: 0.176 ms a pass at k = 8, 67 TFLOP/s), so
// bytes bound every k up to 8. What the design pays on top is the halo's
// recomputation and the instructions around each flux, which decide
// whether k steps on chip beat k one-step passes.
//
// Two routes, chosen in Python (ops/roll_executor.py PassSpec.deep) and
// checked again here:
//
// Plane tiles (bulk_planes_k), for the face neighbourhood's four x / y
// slots in neighbourhood order (-y, -x, +x, +y): the main path. The set
// has no z reach, so every z-plane is computed alone: a block owns one
// 128-wide (x, y) tile (16 to 22 rows, so that the window with its halo
// of k cells fills strips of 8 rows) and marches a chunk of z-planes. A
// thread holds a strip of 8 rows of one column and the static face
// coefficients of its cells in registers (k is a template argument, so
// the sub-steps and rows unroll); the only shared memory is two density
// buffers of the window (44,064 B at k = 8), and two blocks share an SM,
// one loading while the other computes. The fluxes keep the one-step
// plane kernel's order of operations (csrc/bulk_pass.cu, bulk_planes).
//
// Bricks (bulk_bricks_k), for every other slot set (the 26-cube of a
// neighbourhood of length 1, user neighbourhoods): a block stages a
// bx x by x bz brick with a halo of k times the slots' reach per axis,
// the slot loop at run time in the direct kernel's order of operations
// (csrc/bulk_pass.cu, bulk_upwind_direct). A brick whose window does
// not fit a block's shared memory is declined by the rule, before any
// launch, and the step loop runs one-step launches instead.
//
// Built with --fmad=false: a k-deep pass equals k one-step launches, and
// k applications of the plain PyTorch version, bit for bit, in float32
// and in bfloat16.
//
// C entry point: dccrg_bulk_upwind_k(); returns cudaGetLastError() of
// the launch (0 on success), or cudaErrorInvalidValue for geometry the
// rule declines.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxSlots = 26;
constexpr int kMaxK = 8;
constexpr int kWarps = 8;  // a brick block is 32 x kWarps threads
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90
constexpr int kCellBytes = 4 * sizeof(float);  // bricks: density x 2, vx, vy
constexpr int kTileX = 128;   // plane tile: interior x cells
constexpr int kLanesX = 160;  // plane tile: threads along x (5 warps)
constexpr int kStrip = 8;     // plane tile: rows a thread holds

// the face set in neighbourhood order, as (ox, oy, oz, fx, fy)
constexpr int kFace4[4][5] = {
    {0, -1, 0, 0, -1}, {-1, 0, 0, -1, 0}, {1, 0, 0, 1, 0}, {0, 1, 0, 0, 1}};

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int k;           // sub-steps per pass
  int bx, by, bz;  // interior of a block's window (bz = 1 on plane tiles)
  int hx, hy, hz;  // halo = k * reach
  int wx, wy, wz;  // window = interior + 2 * halo
  int rx, ry, rz;  // reach of one sub-step
  int nbx, nby, nbz;  // blocks per axis
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

// Wrap a coordinate into [0, n) on a periodic axis (any number of times
// around); false when it lies outside a non-periodic one.
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

// Stage the block's window of the three fields as floats: window cell
// (lx, ly, lz) holds the grid cell at unwrapped (x0 + lx, y0 + ly,
// z0 + lz), wrapped on periodic axes, zero beyond a non-periodic edge.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ rho,
                                      const T* __restrict__ vx,
                                      const T* __restrict__ vy, float* sr,
                                      float* su, float* sw, const Geom& g,
                                      int x0, int y0, int z0) {
  const long long nxy = (long long)g.nx * g.ny;
  for (int r = threadIdx.y; r < g.wy * g.wz; r += kWarps) {
    int gy = y0 + r % g.wy, gz = z0 + r / g.wy;
    const bool row_in = wrap(gy, g.ny, g.py) && wrap(gz, g.nz, g.pz);
    const long long base = (long long)g.nx * gy + nxy * gz;
    const int lr = r * g.wx;
    for (int lx = threadIdx.x; lx < g.wx; lx += 32) {
      int gx = x0 + lx;
      float a = 0.f, u = 0.f, w = 0.f;
      if (row_in && wrap(gx, g.nx, g.px)) {
        const long long f = base + gx;
        a = Store<T>::load(rho[f]);
        u = Store<T>::load(vx[f]);
        w = Store<T>::load(vy[f]);
      }
      sr[lr + lx] = a;
      su[lr + lx] = u;
      sw[lr + lx] = w;
    }
  }
}

// Plane tiles of the face set. The window is W = kTileX + 2K columns by
// HP rows (16 + 2K rounded up to a multiple of kStrip; the interior is
// HP - 2K rows) of one z-plane. A thread owns one column of kStrip rows
// (threadIdx.x the column, of kLanesX, threadIdx.y the strip) and keeps
// its densities and the face coefficients of its cells in registers;
// the coefficients are static over the pass: for each face m = v * c,
// with v the face velocity 0.5 * (u + u'), and the sign of v, which
// picks the upwind side. A face's flux (v >= 0 ? lower : upper) * m is
// the same product for the two cells it joins, so each y face is
// computed once in a strip. After each sub-step every thread writes its
// strip to shared memory (two buffers, one barrier a sub-step), where
// the neighbour columns and the rows beyond the strip are read. Rows
// outside sub-step t's region [t, HP - t) are skipped (a strip's rows
// share a warp, so the skip does not diverge); lanes outside it compute
// values that no cell of a later region reads (the padding keeps their
// reads inside the buffers). A block marches g.bz z-planes of its tile;
// two blocks fit an SM (64 registers a thread at most), so one loads
// while the other computes.
template <typename T, int K>
__global__ void __launch_bounds__(kLanesX * ((16 + 2 * K + kStrip - 1) /
                                             kStrip), 2)
bulk_planes_k(const T* __restrict__ rho, const T* __restrict__ vx,
              const T* __restrict__ vy, T* __restrict__ out, const Geom g,
              const float c0, const float c1) {
  constexpr int W = kTileX + 2 * K;
  constexpr int HP = (16 + 2 * K + kStrip - 1) / kStrip * kStrip;
  constexpr int TY = HP - 2 * K;  // interior rows
  constexpr int S = kLanesX + 2;  // row stride: a pad column each side
  static_assert(W <= kLanesX, "a window row fits the lanes");
  // rows -1 .. HP and columns -1 .. kLanesX, at [row + 1][col + 1]
  __shared__ float buf[2][HP + 2][S];

  const int c = threadIdx.x;            // window column
  const int j0 = threadIdx.y * kStrip;  // the strip's first window row
  const int b = blockIdx.x;
  const int x0 = (b % g.nbx) * kTileX - K;  // unwrapped, window column 0
  const int y0 = ((b / g.nbx) % g.nby) * TY - K;
  const int zs = (b / (g.nbx * g.nby)) * g.bz;
  const int np = min(g.bz, g.nz - zs);  // planes of this block
  const long long nxy = (long long)g.nx * g.ny;
  const int ugx = x0 + c;  // unwrapped
  int gx = ugx;
  const bool x_in = c < W && wrap(gx, g.nx, g.px);
  // the strip's rows in the grid (-1 outside a non-periodic edge)
  int rows[kStrip];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    int gy = y0 + j0 + i;
    rows[i] = x_in && wrap(gy, g.ny, g.py) ? gy : -1;
  }
  // the y faces' valid bits (mY[i] below row j0 + i) and the x faces'
  unsigned vY = 0;
#pragma unroll
  for (int i = 0; i <= kStrip; ++i) {
    const int gy = y0 + j0 + i - 1;  // the lower row, unwrapped
    vY |= (unsigned)(g.py || (gy >= 0 && gy + 1 < g.ny)) << i;
  }
  const bool vL = g.px || ugx > 0;
  const bool vR = g.px || ugx + 1 < g.nx;

  // the strip of plane zs + p, loaded into registers (while one block
  // of the SM loads, the other computes)
  float pr[kStrip], pu[kStrip], pw[kStrip];
  auto fetch = [&](int p) {
    const long long zoff = (long long)(zs + p) * nxy + gx;
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      float a = 0.f, q = 0.f, e = 0.f;
      if (rows[i] >= 0) {
        const long long f = zoff + (long long)g.nx * rows[i];
        a = Store<T>::load(rho[f]);
        q = Store<T>::load(vx[f]);
        e = Store<T>::load(vy[f]);
      }
      pr[i] = a; pu[i] = q; pw[i] = e;
    }
  };
  for (int p = 0; p < np; ++p) {
    fetch(p);
    float r[kStrip], u[kStrip], w[kStrip];
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      r[i] = pr[i]; u[i] = pu[i]; w[i] = pw[i];
    }
    const long long zoff = (long long)(zs + p) * nxy;
    __syncthreads();  // the previous plane's last reads are done
    // the velocities go through shared memory to the neighbours (vx in
    // buffer 0, vy in buffer 1)
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      buf[0][j0 + i + 1][c + 1] = u[i];
      buf[1][j0 + i + 1][c + 1] = w[i];
    }
    __syncthreads();
    // the faces: the left and right x faces of each cell, and the y
    // faces below each row and above the last
    float mL[kStrip], mR[kStrip], mY[kStrip + 1];
    unsigned sL = 0, sR = 0, sY = 0;
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      float v = 0.5f * (u[i] + buf[0][j0 + i + 1][c]);
      mL[i] = v * c0;
      sL |= (unsigned)(v >= 0.f) << i;
      v = 0.5f * (u[i] + buf[0][j0 + i + 1][c + 2]);
      mR[i] = v * c0;
      sR |= (unsigned)(v >= 0.f) << i;
    }
#pragma unroll
    for (int i = 0; i <= kStrip; ++i) {
      const float lo = i > 0 ? w[i - 1] : buf[1][j0][c + 1];
      const float hi = i < kStrip ? w[i] : buf[1][j0 + kStrip + 1][c + 1];
      const float v = 0.5f * (lo + hi);
      mY[i] = v * c1;
      sY |= (unsigned)(v >= 0.f) << i;
    }
    __syncthreads();  // every thread has read the velocities
#pragma unroll
    for (int i = 0; i < kStrip; ++i) buf[0][j0 + i + 1][c + 1] = r[i];
    __syncthreads();

#pragma unroll
    for (int t = 1; t <= K; ++t) {
      const float(*cur)[S] = buf[(t - 1) & 1];
      float(*nxt)[S] = buf[t & 1];
      // sub-step t over the strip's rows; with `check`, only those in
      // [t, HP - t). A masked slot adds a selected +0.0, which leaves
      // the sum as the one-step kernel's skip leaves it (the sum is
      // never -0.0), and keeps the rows free of branches.
      auto sweep = [&](auto check) {
        // the flux through the face below the strip, from the old rows
        float fb = ((sY & 1u) ? cur[j0][c + 1] : r[0]) * mY[0];
        const float above = cur[j0 + kStrip + 1][c + 1];
#pragma unroll
        for (int i = 0; i < kStrip; ++i) {
          const int j = j0 + i;
          const float rc = r[i];
          const float rn = i + 1 < kStrip ? r[i + 1] : above;
          const float fa = ((sY >> (i + 1)) & 1u ? rc : rn) * mY[i + 1];
          if (!decltype(check)::value || (j >= t && j < HP - t)) {
            const float rl = cur[j + 1][c], rr = cur[j + 1][c + 2];
            const float fl = ((sL >> i) & 1u ? rl : rc) * mL[i];
            const float fr = ((sR >> i) & 1u ? rc : rr) * mR[i];
            float acc = 0.f;
            acc = acc + ((vY >> i) & 1u ? fb : 0.f);        // slot -y
            acc = acc + (vL ? fl : 0.f);                    // slot -x
            acc = acc - (vR ? fr : 0.f);                    // slot +x
            acc = acc - ((vY >> (i + 1)) & 1u ? fa : 0.f);  // slot +y
            const float res = rc + acc;
            if (t == K) {
              // the interior; ragged tiles stop at the grid's edge
              const int gy = y0 + j;
              if (c >= K && c < K + kTileX && ugx < g.nx && gy < g.ny)
                out[zoff + (long long)g.nx * gy + ugx] = Store<T>::pack(res);
            } else {
              r[i] = round_to<T>(res);
              nxt[j + 1][c + 1] = r[i];
            }
          }
          fb = fa;
        }
      };
      // a strip wholly inside the region skips the row checks (at
      // k <= 4: deeper passes run 640 threads at 48 registers, where
      // a second copy of the sweep spills)
      if (K <= 4 && j0 >= t && j0 + kStrip <= HP - t)
        sweep(std::false_type());
      else if (j0 + kStrip > t && j0 < HP - t)
        sweep(std::true_type());
      if (t < K) __syncthreads();
    }
  }
}

// Bricks of any other slot set, the slot loop at run time.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
bulk_bricks_k(const T* __restrict__ rho, const T* __restrict__ vx,
              const T* __restrict__ vy, T* __restrict__ out, const Geom g,
              const Slots s, const float c0, const float c1) {
  extern __shared__ float smem[];
  const int A = g.wx * g.wy * g.wz;
  float* su = smem;
  float* sw = smem + A;
  float* cur = smem + 2 * A;
  float* nxt = smem + 3 * A;

  const int b = blockIdx.x;
  const int x0 = (b % g.nbx) * g.bx - g.hx;  // unwrapped, window cell 0
  const int y0 = ((b / g.nbx) % g.nby) * g.by - g.hy;
  const int z0 = (b / (g.nbx * g.nby)) * g.bz - g.hz;
  const long long nxy = (long long)g.nx * g.ny;
  stage<T>(rho, vx, vy, cur, su, sw, g, x0, y0, z0);
  __syncthreads();

  const int sy = g.wx, sz = g.wx * g.wy;
  for (int t = 1; t <= g.k; ++t) {
    const int lox = t * g.rx, loy = t * g.ry, loz = t * g.rz;
    const int ex = g.wx - 2 * lox, ey = g.wy - 2 * loy, ez = g.wz - 2 * loz;
    const bool last = t == g.k;
    for (int r = threadIdx.y; r < ey * ez; r += kWarps) {
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
      for (int lx = lox + threadIdx.x; lx < lox + ex; lx += 32) {
        const int li = lrow + lx;
        const int gx = x0 + lx;
        const float rc = cur[li], vxc = su[li], vyc = sw[li];
        float acc = 0.f;
        for (int j = 0; j < s.n; ++j) {
          bool valid = (row_ok >> j) & 1u;
          if (!g.px && s.ox[j]) {
            const int c = gx + s.ox[j];
            valid = valid && c >= 0 && c < g.nx;
          }
          const int ln = li + s.ox[j] + sy * s.oy[j] + sz * s.oz[j];
          const float rn = valid ? cur[ln] : 0.f;
          const float vxn = valid ? su[ln] : 0.f;
          const float vyn = valid ? sw[ln] : 0.f;
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

bool is_face4(const int* si, int n_slots) {
  if (n_slots != 4) return false;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 5; ++i)
      if (si[5 * j + i] != kFace4[j][i]) return false;
  return true;
}

template <typename T, int K>
int launch_planes(const void* rho, const void* vx, const void* vy, void* out,
                  const Geom& g, float c0, float c1, long long blocks,
                  void* stream) {
  constexpr int strips = (16 + 2 * K + kStrip - 1) / kStrip;
  bulk_planes_k<T, K><<<(unsigned)blocks, dim3(kLanesX, strips), 0,
                        (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, c0, c1);
  return (int)cudaGetLastError();
}

// Check the launch against the card's limits and opt the kernel into
// its dynamic shared memory.
template <typename K>
int prepare(K kernel, size_t smem, long long blocks) {
  if (smem > kMaxSmem || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch(int route, const void* rho, const void* vx, const void* vy,
           void* out, const int* gi, const int* si, int n_slots, float c0,
           float c1, int device, void* stream) {
  Geom g;
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.k = gi[6];
  g.bx = gi[7]; g.by = gi[8]; g.bz = gi[9];
  g.rx = gi[10]; g.ry = gi[11]; g.rz = gi[12];
  if (n_slots < 0 || n_slots > kMaxSlots || g.k < 2 || g.k > kMaxK ||
      g.nx < 1 || g.ny < 1 || g.nz < 1 || g.bx < 1 || g.by < 1 ||
      g.bz < 1 || g.rx < 0 || g.ry < 0 || g.rz < 0)
    return (int)cudaErrorInvalidValue;
  const bool face = route == 0;
  // the plane route is the face set's: reach 1 in x and y, none in z,
  // on the kernel's own tile
  const int tile_y = (16 + 2 * g.k + kStrip - 1) / kStrip * kStrip - 2 * g.k;
  if (face && (!is_face4(si, n_slots) || g.bx != kTileX ||
               g.by != tile_y || g.rx != 1 || g.ry != 1 || g.rz != 0))
    return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  g.hx = g.k * g.rx; g.hy = g.k * g.ry; g.hz = g.k * g.rz;
  g.wx = g.bx + 2 * g.hx; g.wy = g.by + 2 * g.hy; g.wz = g.bz + 2 * g.hz;
  g.nbx = (g.nx + g.bx - 1) / g.bx;
  g.nby = (g.ny + g.by - 1) / g.by;
  g.nbz = (g.nz + g.bz - 1) / g.bz;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)g.nbx * g.nby * g.nbz;
  if (face) {
    // static shared memory: two density buffers of the padded window,
    // 2 * 34 * 162 floats at k = 8 (44,064 B)
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    switch (g.k) {
      case 2: return launch_planes<T, 2>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      case 3: return launch_planes<T, 3>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      case 4: return launch_planes<T, 4>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      case 5: return launch_planes<T, 5>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      case 6: return launch_planes<T, 6>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      case 7: return launch_planes<T, 7>(rho, vx, vy, out, g, c0, c1,
                                         blocks, stream);
      default: return launch_planes<T, 8>(rho, vx, vy, out, g, c0, c1,
                                          blocks, stream);
    }
  }
  // the shared-memory rule of PassSpec.deep: 16 B a window cell
  const size_t smem = (size_t)kCellBytes * g.wx * g.wy * g.wz;
  const dim3 threads(32, kWarps);
  Slots s;
  s.n = n_slots;
  for (int j = 0; j < n_slots; ++j) {
    s.ox[j] = si[5 * j]; s.oy[j] = si[5 * j + 1]; s.oz[j] = si[5 * j + 2];
    s.fx[j] = si[5 * j + 3]; s.fy[j] = si[5 * j + 4];
    // the halo must cover every slot's offset
    if (s.ox[j] > g.rx || -s.ox[j] > g.rx || s.oy[j] > g.ry ||
        -s.oy[j] > g.ry || s.oz[j] > g.rz || -s.oz[j] > g.rz)
      return (int)cudaErrorInvalidValue;
  }
  int rc = prepare(bulk_bricks_k<T>, smem, blocks);
  if (rc != 0) return rc;
  bulk_bricks_k<T><<<(unsigned)blocks, threads, smem,
                     (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, s, c0, c1);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four arrays the same type).
// route: 0 = plane tiles (the face set), 1 = bricks (any slot set).
// geom: nx, ny, nz, px, py, pz, k, bx, by, bz, rx, ry, rz: the interior
// of a block's window and the reach of one sub-step per axis (plane
// tiles: 128 x (16 + 2k rounded up to 8, less 2k), bz the z-planes a
// block marches, reach 1, 1, 0). slots: n_slots rows of
// (ox, oy, oz, fx, fy). `out` must not alias an input.
extern "C" int dccrg_bulk_upwind_k(int dtype, int route, const void* rho,
                                   const void* vx, const void* vy, void* out,
                                   const int* geom, const int* slots,
                                   int n_slots, float c0, float c1,
                                   int device, void* stream) {
  if (dtype == 0)
    return launch<float>(route, rho, vx, vy, out, geom, slots, n_slots, c0,
                         c1, device, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(route, rho, vx, vy, out, geom, slots,
                                 n_slots, c0, c1, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_bulk_k_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
