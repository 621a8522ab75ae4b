// Temporally blocked bulk pass of the grid step loop: k sub-steps of a
// device flux (csrc/fluxes.cuh: the upwind advection flux, the fleet
// twins diffuse and advect_x) over a single-device closed-form plan in
// one pass over device memory (DCCRG_BULK_SPP = k, 2..8).
//
// Replaces the k >= 2 form of the Pallas kernel `make_bulk_pass`
// (dccrg_tpu/ops/roll_executor.py:183; its sub-step loop :279-310). That
// kernel stages flat [G, 8, 128] windows with halos of k times the
// largest flat shift and applies the k sub-steps over shrinking row
// regions, recomputing every window's halo. Here rows are grid order
// (flat = x + nx*(y + ny*z)) and every neighbour is read at its exact
// 3-D position: a value at a global coordinate is the grid's value
// modulo the extent on a periodic axis (a halo wider than the grid
// wraps more than once) and zero beyond a non-periodic edge, where the
// slot's mask, taken from the unwrapped coordinate, drops it. The
// carried field is rounded to the storage type after every sub-step,
// as the reference rounds its carry (`carry = res.astype(dtypes[f])`,
// :310); the upwind flux's vx and vy are static over the pass.
//
// Bound on the H100: bytes, as for one step, but spread over k steps.
// At 512^3, float32, a pass reads 3 fields and writes 1: 4 * 2^27 * 4 B
// = 2.15 GB, 0.641 ms at 3.35 TB/s, 0.641 / k ms a step; the float ops
// the function needs grow with k (16 + 9k a cell, the face coefficients
// static over the pass: 0.176 ms a pass at k = 8, 67 TFLOP/s), so
// bytes bound every k up to 8. What a design pays on top is the
// recomputed halo, the re-read bytes and the instructions around each
// flux.
//
// Two routes, chosen in Python (ops/roll_executor.py PassSpec.deep) and
// checked again here:
//
// Plane route (bulk_planes_k), for the face neighbourhood's four x / y
// slots in neighbourhood order (-y, -x, +x, +y): the main path. The set
// has no z reach, so every z-plane is a 2-D problem of its own, and the
// k sub-steps stream through it as time-skewed levels: a block walks a
// y segment of one plane's band of columns one input row an iteration,
// level t computing the row t below the newest, so a row of a level is
// computed once, the y halo only in the segment's first and last 2k
// iterations; the x halo is k lanes each side of a 256-column band. At
// 512^3 that is at most 1.2 thread-cells a useful cell-step and 1.1
// times the bound's bytes at any k up to 8 (PassSpec.deep_cost). Rows
// land by cp.async six iterations ahead of use; the static face
// coefficients live in registers; one barrier an iteration.
//
// Bricks (bulk_bricks_k), for every other flux and slot set (the upwind
// flux on the 26-cube of a neighbourhood of length 1 and on user
// neighbourhoods; diffuse and advect_x, one field staged a plane): the
// same streaming along z. A block owns an (x, y) tile with a halo of k reaches and a
// z segment; level t runs t planes (t times the z reach, if more)
// behind the input, over the tile less t reaches, in rings of planes in
// shared memory, the slot loop at run time in the direct kernel's order
// of operations (csrc/bulk_pass.cu, bulk_direct). A set whose
// reach exceeds 2 or whose smallest tile does not fit two blocks an SM
// is declined by the rule before any launch. The bricks pay only where
// the halo adds little to a long slot loop over a card's worth of
// blocks: on the card the 26-cube ran 1.11 to 1.32 times faster than
// two direct launches at k = 2 from 128^3 up, and won or lost at k = 3
// by size; sets of 4 or 5 face terms lost at every k. So the step loop
// takes them only as PassSpec.deep_pays says, by a rule per flux.
//
// Built with --fmad=false: a k-deep pass equals k one-step launches, and
// k applications of the plain PyTorch version, bit for bit, in float32
// and in bfloat16.
//
// C entry points: dccrg_bulk_upwind_k() (the plane route) and
// dccrg_bulk_bricks() (any flux); each returns cudaGetLastError() of
// the launch (0 on success), or cudaErrorInvalidValue for geometry the
// rule declines.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

#include "fluxes.cuh"

namespace {

using namespace fluxes;

constexpr int kMaxSlots = 124;  // the cube of a neighbourhood of length 2
constexpr int kMaxK = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90
// bricks: two blocks an SM, each in half of an SM's 228 KB less the
// 1 KB the system keeps per block (PassSpec's _BRICK_SMEM)
constexpr size_t kBrickSmem = (233472 - 2 * 1024) / 2;
constexpr int kBrickThreads = 512;   // bricks: threads a block
constexpr int kBrickElems = 8;       // bricks: staged elements a thread
constexpr int kMaxReach = 2;         // bricks: reach per axis (5 mask bits)
constexpr int kBandMax = 256;  // plane route: widest band of interior columns
constexpr int kPadX = 16;      // plane route: lanes each side of the band
constexpr int kStageX = 8;     // plane route: staged halo columns each side
constexpr int kInOff = 16;     // plane route: first staged column in a row
constexpr int kRing = 8;       // plane route: input rows in shared memory

// the face set in neighbourhood order, as (ox, oy, oz, fx, fy)
constexpr int kFace4[4][5] = {
    {0, -1, 0, 0, -1}, {-1, 0, 0, -1, 0}, {1, 0, 0, 1, 0}, {0, 1, 0, 0, 1}};

struct Geom {
  int nx, ny, nz;  // grid extents
  int px, py, pz;  // periodic flags
  int k;           // sub-steps per pass
  int bx, by, bz;  // a block's interior (planes: band, segment rows, 1)
  int hx, hy, hz;  // halo = k * reach
  int wx, wy, wz;  // window = interior + 2 * halo
  int rx, ry, rz;  // reach of one sub-step
  int nbx, nby, nbz;  // blocks per axis
};

// a flux's fields, field 0 the carried one
template <typename T> struct Fields {
  const T* f[3];
};

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

// Shared memory of a plane block: the input ring (kRing rows of the
// three fields in the storage type, kInRow elements a row) and the
// two-row rings of levels 1 .. K-1 (floats, kLvRow a row), sized for the
// widest band so that every offset is a constant.
constexpr int kInRow = kBandMax + 48;
constexpr int kLvRow = kBandMax + 2 * kPadX + 2;
constexpr size_t plane_smem(int k, int item) {
  return (size_t)kRing * 3 * kInRow * item +
         (size_t)2 * (k - 1) * kLvRow * sizeof(float);
}

// Shared memory of a brick block with a W x H window: the input ring
// (K sk + rz + 2 planes of the flux's nf fields) and the rings of
// levels 1 .. K-1 (sk + rz + 1 planes each), floats; then two buffers
// of the slot tables (K (n + 1) int4 each) and the column and row masks.
__host__ __device__ constexpr size_t brick_tab_offset(int W, int H, int k,
                                                      int rz, int nf) {
  return ((size_t)4 * W * H *
              (nf * (k * (rz > 1 ? rz : 1) + rz + 2) +
               (k - 1) * ((rz > 1 ? rz : 1) + rz + 1)) + 15) / 16 * 16;
}
constexpr size_t brick_smem(int W, int H, int k, int rz, int n, int nf) {
  return brick_tab_offset(W, H, k, rz, nf) + (size_t)16 * 2 * k * (n + 1) +
         (size_t)4 * (W + H);
}

// Plane route of the face set: time-skewed levels streamed along y.
//
// A block owns one z-plane's band of g.bx interior columns (a multiple
// of 32, at most kBandMax) and a segment of g.by interior rows. Thread
// j holds unwrapped column x0 - kPadX + j (lanes = band + 2 kPadX; the
// k halo columns each side are recomputed, the lanes beyond them idle)
// for every sub-step: iteration i brings input row ya - K + i (level 0)
// and level t computes the row t below it, so each level runs one row
// behind the one before and every row of a level is computed once. The
// y halo is thus computed once a segment (2K rows of warm-up and
// drain), not once a tile. A cell's vertical neighbours at level t - 1
// are the thread's own values of this and the last iteration, kept in
// registers; its x neighbours come from the level's two-row ring in
// shared memory, written an iteration earlier, so one barrier an
// iteration orders everything. The face coefficients (m = v * c with
// v = 0.5 (u + u'), and the upwind sign) are static: each is computed
// once a row, when the row's velocities land, and kept in registers
// for the K iterations that use it (the loop unrolls by K + 1, so the
// register rings never move). Each y face's flux is computed once and
// carried to the next row, and the slots are summed in the one-step
// kernel's order (-y, -x, +x, +y), so the result is bit for bit that
// of K one-step launches. Input rows land kRing - 2 iterations ahead:
// by cp.async in 16-byte chunks (VEC: nx a multiple of the chunk and
// the arrays aligned; a chunk wraps as a whole on a periodic edge and
// is zero-filled beyond a non-periodic one), or else element by element
// through registers, stored an iteration after they were loaded. Level
// K writes its row's interior columns straight to device memory. MASK
// is the non-periodic form, whose x and y faces at an edge add a
// selected +0.0. Three blocks an SM (72 registers) up to K = 4, two
// (96) above, where the register rings of three spill more than the
// third block gains: each was the faster on the card at its K.
template <typename T, int K, bool MASK>
__global__ void __launch_bounds__(kBandMax + 2 * kPadX, K <= 4 ? 3 : 2)
bulk_planes_k(const T* __restrict__ rho, const T* __restrict__ vx,
              const T* __restrict__ vy, T* __restrict__ out, const Geom g,
              const float c0, const float c1, const bool vec) {
  constexpr int R = K + 1;        // register rings: rows ya - K + i - t
  constexpr int D = kRing - 2;    // input rows in flight
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int band = g.bx;
  const int lanes = band + 2 * kPadX;
  constexpr int IW = kInRow;
  constexpr int LW = kLvRow;
  const int SW = band + 2 * kStageX;  // staged columns of a field row
  T* sin = reinterpret_cast<T*>(smem_raw);
  float* slv = reinterpret_cast<float*>(smem_raw + (size_t)kRing * 3 * IW *
                                                       sizeof(T));

  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int x0 = (b % g.nbx) * band;
  const int ya = ((b / g.nbx) % g.nby) * g.by;
  const int z = b / (g.nbx * g.nby);
  const int N = min(g.by, g.ny - ya) + 2 * K;  // iterations
  const long long zoff = (long long)z * g.nx * g.ny;
  const int ugx = x0 - kPadX + j;  // unwrapped column of this thread
  const bool pL = !MASK || g.px || ugx > 0;
  const bool pR = !MASK || g.px || ugx + 1 < g.nx;
  const bool mine = j >= kPadX && j < kPadX + band && ugx < g.nx;

  auto row_base = [&](int i, bool& ok) {
    int gy = ya - K + i;
    ok = wrap(gy, g.ny, g.py);
    return zoff + (long long)gy * g.nx;
  };
  auto slot = [&](int i) { return sin + (i & (kRing - 1)) * 3 * IW; };
  // vec: thread j < 3 SW / V copies one 16-byte chunk of a field row
  const int per = SW / V;
  const int qf = j / per;
  const int qo = qf * IW + kInOff + (j - qf * per) * V;  // in a slot
  int qgx = x0 - kStageX + (j - qf * per) * V;
  const bool qin = vec && j < 3 * per;
  const bool qx_ok = wrap(qgx, g.nx, g.px);
  const T* qsrc = qf == 0 ? rho : (qf == 1 ? vx : vy);
  auto issue = [&](int i) {  // cp.async of row i into its slot
    bool ok;
    const long long rb = row_base(i, ok);
    if (qin) {
      const bool v = ok && qx_ok;
      cp_async16(slot(i) + qo, v ? qsrc + rb + qgx : qsrc, v);
    }
  };
  // else element q = j + m * lanes (< 3 SW) of the staged row, loaded
  // into registers an iteration before it is stored
  T pend[3];
  auto fetch = [&](int i) {
    bool ok;
    const long long rb = row_base(i, ok);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int q = j + m * lanes, f = q / SW;
      int gx = x0 - kStageX + (q - f * SW);
      const T* src = f == 0 ? rho : (f == 1 ? vx : vy);
      pend[m] = q < 3 * SW && ok && wrap(gx, g.nx, g.px)
                    ? src[rb + gx] : Store<T>::pack(0.f);
    }
  };
  auto land = [&](int i) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int q = j + m * lanes, f = q / SW;
      if (q < 3 * SW) slot(i)[f * IW + kInOff + (q - f * SW)] = pend[m];
    }
  };
  for (int i = 0; i < D; ++i) {
    if (i < N) {
      if (vec) {
        issue(i);
      } else {
        fetch(i);
        land(i);
      }
    }
    cp_async_commit();
  }

  // register rings, indexed by iteration mod R: the densities of
  // levels 0 .. K-1 (this thread's column) and the face coefficients
  // of each row; the rows' upwind signs in one word shifted 3 bits an
  // iteration (row ya - K + i - t at bit 3t: its -x / +x / -y face's
  // velocity >= 0), which spills less at K >= 5 than a ring of words
  float dn[K][R], mL[R], mR[R], mY[R];
  unsigned sg = 0;
  float fy[K];  // each level's flux through the face below its next row
#pragma unroll
  for (int u = 0; u < R; ++u) {
    mL[u] = mR[u] = mY[u] = 0.f;
#pragma unroll
    for (int t = 0; t < K; ++t) dn[t][u] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < K; ++t) fy[t] = 0.f;
  float wprev = 0.f;
  const int col = kInOff + j - (kPadX - kStageX);  // this column in a row
  long long op = zoff + (long long)(ya - 2 * K) * g.nx + ugx;  // level K

  for (int i0 = 0; i0 < N; i0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + u;
      if (i < N) {
        cp_async_wait<D - 1>();  // row i has landed (this thread's copies)
        __syncthreads();
        if (vec) {
          if (i + D < N) issue(i + D);
        } else {
          if (i >= 1 && i - 1 + D < N) land(i - 1 + D);
          if (i + D < N) fetch(i + D);
        }
        cp_async_commit();

        // level 0: row i's density, and its face coefficients
        const T* in = slot(i) + col;
        dn[0][u] = Store<T>::load(in[0]);
        {
          const float uc = Store<T>::load(in[IW]);
          const float wc = Store<T>::load(in[2 * IW]);
          float v = 0.5f * (uc + Store<T>::load(in[IW - 1]));
          mL[u] = v * c0;
          unsigned bt = v >= 0.f;
          v = 0.5f * (uc + Store<T>::load(in[IW + 1]));
          mR[u] = v * c0;
          bt |= (unsigned)(v >= 0.f) << 1;
          v = 0.5f * (wprev + wc);
          mY[u] = v * c1;
          bt |= (unsigned)(v >= 0.f) << 2;
          sg = (sg << 3) | bt;
          wprev = wc;
        }
        const T* inp = slot(i - 1) + col;  // level 0, the last row
        float* lw = slv + (i & 1) * LW + j + 1;
        const float* lr = slv + ((i & 1) ^ 1) * LW + j + 1;
#pragma unroll
        for (int t = 1; t <= K; ++t) {
          // level t, row ya - K + i - t: the cell (rc) and the one above
          // (rn) at level t - 1, its x neighbours from the ring
          const int ry = (u - t + R) % R, ra = (u - t + 1 + R) % R;
          const float rc = dn[t - 1][(u + R - 1) % R];
          const float rn = dn[t - 1][u];
          float rl, rr;
          if (t == 1) {
            rl = Store<T>::load(inp[-1]);
            rr = Store<T>::load(inp[1]);
          } else {
            rl = lr[(t - 2) * 2 * LW - 1];
            rr = lr[(t - 2) * 2 * LW + 1];
          }
          // the y faces below and above the row inside the grid
          const int gy = ya - K + i - t;  // unwrapped
          const bool vb = !MASK || g.py || (gy >= 1 && gy < g.ny);
          const bool va = !MASK || g.py || (gy >= 0 && gy + 1 < g.ny);
          const float fa = ((sg >> (3 * t - 1)) & 1u ? rc : rn) * mY[ra];
          const float fl = ((sg >> (3 * t)) & 1u ? rl : rc) * mL[ry];
          const float fr = ((sg >> (3 * t + 1)) & 1u ? rc : rr) * mR[ry];
          float acc = 0.f;
          acc = acc + (vb ? fy[t - 1] : 0.f);  // slot -y
          acc = acc + (pL ? fl : 0.f);         // slot -x
          acc = acc - (pR ? fr : 0.f);         // slot +x
          acc = acc - (va ? fa : 0.f);         // slot +y
          const float res = rc + acc;
          fy[t - 1] = fa;
          if (t < K) {
            const float r = round_to<T>(res);
            dn[t][u] = r;
            lw[(t - 1) * 2 * LW] = r;
          } else if (i >= 2 * K && mine) {
            out[op] = Store<T>::pack(res);
          }
        }
        op += g.nx;
      }
    }
  }
}

// Bricks of any other slot set: time-skewed levels streamed along z.
//
// A block owns a g.bx x g.by (x, y) tile with a halo of K reaches each
// side (window W x H) and a segment of g.bz z-planes, and walks it one
// input plane an iteration: plane q (counted from the segment's first
// halo plane) of the flux's fields lands as floats in a ring of QI
// planes, and level t computes plane q - t sk, sk = max(rz, 1) planes
// behind the level before, over the window less t reaches each side.
// A plane of a level is computed once, so the recomputation is the
// (x, y) halo alone; in z the segment adds 2 K rz planes. Levels 1 ..
// K-1 keep rings of QL = sk + rz + 1 planes; the input ring spans what
// the deepest level's velocities need, QI = K sk + rz + 2 planes. A
// barrier follows every level but the last (level t reads what level
// t - 1 wrote in the same iteration when sk = rz) and ends the
// iteration. Per level and iteration a table gives each slot its
// neighbour's offsets in shared memory and the bits of its mask
// (built an iteration ahead, two buffers); the masks of a cell are bit
// sets per column, row and plane over the offsets -r .. r, taken from
// unwrapped coordinates. The slot loop runs in the direct kernel's
// order with the flux's terms (csrc/bulk_pass.cu, bulk_direct; the
// upwind flux's each in one sum, `face`, a slot without an x (y) face
// adding a selected +0.0 there), so the loop has no branch. The next plane's
// elements load into registers at the start of an iteration and land
// at its end. 512 threads a block, two blocks an SM: of the variants
// timed on the card (256 threads, a branch on each face) the fastest.
template <typename T, typename F>
__global__ void __launch_bounds__(kBrickThreads, 2)
bulk_bricks_k(const Fields<T> in, T* __restrict__ out, const Geom g,
              const int4* __restrict__ slots, const int n, const Coef coef) {
  constexpr int NF = F::kFields;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = g.k;
  const int sk = g.rz > 1 ? g.rz : 1;
  const int W = g.wx, H = g.wy, WH = W * H;
  const int QI = K * sk + g.rz + 2, QL = sk + g.rz + 1;
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int lv0 = QI * NF * WH;  // first float of the levels' rings
  int4* tab = reinterpret_cast<int4*>(smem_raw +
                                      brick_tab_offset(W, H, K, g.rz, NF));
  int* xmask = reinterpret_cast<int*>(tab + 2 * K * (n + 1));
  int* ymask = xmask + W;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int x0 = (b % g.nbx) * g.bx - g.hx;  // unwrapped, window column 0
  const int y0 = ((b / g.nbx) % g.nby) * g.by - g.hy;
  const int za = (b / (g.nbx * g.nby)) * g.bz;
  const int S = min(g.bz, g.nz - za);
  const int z0 = za - g.hz;                  // plane q = 0, unwrapped
  const int NI = S + 2 * g.hz;               // input planes
  const int N = S + K * (g.rz + sk);         // iterations
  const long long nxy = (long long)g.nx * g.ny;

  // the masks' bits: offset o of an axis of reach r at bit o + r
  auto axis_bits = [](int c, int r, int n_, int periodic) {
    int m = 0;
    for (int o = -r; o <= r; ++o)
      m |= (int)(periodic || (c + o >= 0 && c + o < n_)) << (o + r);
    return m;
  };
  for (int x = tid; x < W; x += kBrickThreads)
    xmask[x] = axis_bits(x0 + x, g.rx, g.nx, g.px);
  for (int y = tid; y < H; y += kBrickThreads)
    ymask[y] = axis_bits(y0 + y, g.ry, g.ny, g.py) << 5;

  // the staged elements of this thread: element e = tid + m * threads
  // of a plane's [NF][WH] block, its offset in a z-plane of the grid
  // (wrapped; -1 beyond a non-periodic edge)
  int gofs[kBrickElems];
#pragma unroll
  for (int m = 0; m < kBrickElems; ++m) {
    const int e = tid + m * kBrickThreads;
    const int r = e % WH, y = r / W;
    int gx = x0 + r - y * W, gy = y0 + y;
    gofs[m] = e < NF * WH && wrap(gx, g.nx, g.px) && wrap(gy, g.ny, g.py)
                  ? gx + g.nx * gy : -1;
  }
  T pend[kBrickElems];
  auto fetch = [&](int q) {
    int gz = z0 + q;
    const bool ok = wrap(gz, g.nz, g.pz);
    const long long zoff = nxy * gz;
#pragma unroll
    for (int m = 0; m < kBrickElems; ++m) {
      const int e = tid + m * kBrickThreads;
      const T* src = in.f[NF == 1 || e < WH ? 0 : (e < 2 * WH ? 1 : 2)];
      pend[m] = ok && gofs[m] >= 0 ? src[zoff + gofs[m]]
                                   : Store<T>::pack(0.f);
    }
  };
  auto land = [&](int q) {
    float* dst = sm + (q % QI) * NF * WH;
#pragma unroll
    for (int m = 0; m < kBrickElems; ++m) {
      const int e = tid + m * kBrickThreads;
      if (e < NF * WH) dst[e] = Store<T>::load(pend[m]);
    }
  };
  // the slot tables of iteration i: entry (t, j) holds, for level t,
  // slot j's neighbour offsets (level t - 1's carried field; the input
  // plane, whose fields 1 .. NF-1 are static) and mask bits, and its
  // code; entry (t, n) the cell itself
  auto tables = [&](int i) {
    int4* tb = tab + (i & 1) * K * (n + 1);
    for (int e = tid; e < K * (n + 1); e += kBrickThreads) {
      const int t = e / (n + 1) + 1, j = e % (n + 1);
      const bool c = j == n;
      const int4 sl = c ? make_int4(0, 0, 0, 0) : slots[j];
      const int q = i - t * sk + sl.z;
      if (q < 0) continue;  // level t is not active yet
      const int d = sl.x + W * sl.y;
      const int ip = (q % QI) * NF * WH;
      const int r = t == 1 ? ip : lv0 + ((t - 2) * QL + q % QL) * WH;
      const int need = (1 << (sl.x + g.rx)) | (1 << (5 + sl.y + g.ry)) |
                       (1 << (10 + sl.z + g.rz));
      tb[e] = make_int4(r + d, ip + d, need, sl.w);
    }
  };

  fetch(0);
  land(0);
  tables(0);
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    if (i + 1 < NI) fetch(i + 1);
    tables(i + 1);
    const int4* tb = tab + (i & 1) * K * (n + 1);
    for (int t = 1; t <= K; ++t) {
      const int q = i - t * sk;  // this level's plane
      if (q >= t * g.rz && q < NI - t * g.rz) {
        int gz = z0 + q;  // unwrapped
        int zm = 0;
        for (int o = -g.rz; o <= g.rz; ++o)
          zm |= (int)(g.pz || (gz + o >= 0 && gz + o < g.nz))
                << (10 + o + g.rz);
        const int4* tt = tb + (t - 1) * (n + 1);
        const int4 ce = tt[n];
        const int lx = t * g.rx, ly = t * g.ry;
        const int cw = W - 2 * lx, ch = H - 2 * ly;
        float* dst = sm + lv0 + ((t - 1) * QL + q % QL) * WH;
        for (int c = tid; c < cw * ch; c += kBrickThreads) {
          const int y = ly + c / cw, x = lx + c % cw;
          const int li = x + W * y;
          const int m = xmask[x] | ymask[y] | zm;
          float cv[NF];
          cv[0] = sm[ce.x + li];
#pragma unroll
          for (int f = 1; f < NF; ++f) cv[f] = sm[ce.y + f * WH + li];
          float acc = 0.f;
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const int4 e = tt[j];
            const bool valid = (m & e.z) == e.z;
            float nv[NF];
            nv[0] = sm[e.x + li];
#pragma unroll
            for (int f = 1; f < NF; ++f) nv[f] = sm[e.y + f * WH + li];
            acc = F::template add<T>(acc, cv, nv, valid, e.w, coef);
          }
          const float res = F::template finish<T>(cv, acc, coef);
          if (t < K) {
            dst[li] = round_to<T>(res);
          } else {
            int gx = x0 + x, gy = y0 + y;
            if (gx < g.nx && gy < g.ny)
              out[gx + (long long)g.nx * gy + nxy * gz] = Store<T>::pack(res);
          }
        }
      }
      if (t < K) __syncthreads();
    }
    if (i + 1 < NI) land(i + 1);
    __syncthreads();
  }
}

bool is_face4(const int* si, int n_slots) {
  if (n_slots != 4) return false;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 5; ++i)
      if (si[5 * j + i] != kFace4[j][i]) return false;
  return true;
}

// Check the launch against the card's limits and opt the kernel into
// its dynamic shared memory.
template <typename K>
int prepare(K kernel, size_t smem, long long blocks) {
  if (smem > kMaxSmem || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int K, bool MASK>
int launch_planes(const void* rho, const void* vx, const void* vy, void* out,
                  const Geom& g, float c0, float c1, bool vec,
                  long long blocks, void* stream) {
  const size_t smem = plane_smem(K, sizeof(T));
  int rc = prepare(bulk_planes_k<T, K, MASK>, smem, blocks);
  if (rc != 0) return rc;
  bulk_planes_k<T, K, MASK><<<(unsigned)blocks, g.bx + 2 * kPadX, smem,
                              (cudaStream_t)stream>>>(
      (const T*)rho, (const T*)vx, (const T*)vy, (T*)out, g, c0, c1, vec);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_planes(const void* rho, const void* vx, const void* vy, void* out,
                  const Geom& g, float c0, float c1, long long blocks,
                  void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = g.nx % V == 0 &&
                   ((uintptr_t)rho | (uintptr_t)vx | (uintptr_t)vy) % 16 == 0;
  if (g.px && g.py)
    return launch_planes<T, K, false>(rho, vx, vy, out, g, c0, c1, vec,
                                      blocks, stream);
  return launch_planes<T, K, true>(rho, vx, vy, out, g, c0, c1, vec, blocks,
                                   stream);
}

// The geometry of a launch from its host array, the windows and block
// counts derived; false for a geometry no route takes.
bool parse_geom(const int* gi, Geom& g) {
  g.nx = gi[0]; g.ny = gi[1]; g.nz = gi[2];
  g.px = gi[3]; g.py = gi[4]; g.pz = gi[5];
  g.k = gi[6];
  g.bx = gi[7]; g.by = gi[8]; g.bz = gi[9];
  g.rx = gi[10]; g.ry = gi[11]; g.rz = gi[12];
  if (g.k < 2 || g.k > kMaxK || g.nx < 1 || g.ny < 1 || g.nz < 1 ||
      g.bx < 1 || g.by < 1 || g.bz < 1 || g.rx < 0 || g.ry < 0 || g.rz < 0)
    return false;
  g.hx = g.k * g.rx; g.hy = g.k * g.ry; g.hz = g.k * g.rz;
  g.wx = g.bx + 2 * g.hx; g.wy = g.by + 2 * g.hy; g.wz = g.bz + 2 * g.hz;
  g.nbx = (g.nx + g.bx - 1) / g.bx;
  g.nby = (g.ny + g.by - 1) / g.by;
  g.nbz = (g.nz + g.bz - 1) / g.bz;
  return true;
}

// the plane route of the face set: reach 1 in x and y, none in z, a
// band of whole warps and one z-plane a block
template <typename T>
int launch_face(const void* rho, const void* vx, const void* vy, void* out,
                const int* gi, const int* si, int n_slots, float c0,
                float c1, int device, void* stream) {
  Geom g;
  if (!parse_geom(gi, g) || !is_face4(si, n_slots) || g.bx % 32 != 0 ||
      g.bx > kBandMax || g.bz != 1 || g.rx != 1 || g.ry != 1 || g.rz != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)g.nbx * g.nby * g.nbz;
  // dynamic shared memory: the input ring and the levels' rows,
  // 45,424 B at a 256 band, k = 8, float32
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

// the bricks: the rule of PassSpec.deep (reach at most kMaxReach an
// axis and covering every slot, the staged plane within the threads'
// elements, the rings within kBrickSmem, two blocks an SM)
template <typename T, typename F>
int launch_bricks(const void* const* in, void* out, const int* gi,
                  const int* si, const void* slots, int n_slots, Coef k,
                  int device, void* stream) {
  constexpr int NF = F::kFields;
  Geom g;
  if (!parse_geom(gi, g) || n_slots < 0 || n_slots > kMaxSlots ||
      (n_slots > 0 && slots == nullptr) || g.rx > kMaxReach ||
      g.ry > kMaxReach || g.rz > kMaxReach ||
      NF * g.wx * g.wy > kBrickElems * kBrickThreads)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_slots; ++j) {
    const int* r = si + 4 * j;
    if (r[0] > g.rx || -r[0] > g.rx || r[1] > g.ry || -r[1] > g.ry ||
        r[2] > g.rz || -r[2] > g.rz)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = brick_smem(g.wx, g.wy, g.k, g.rz, n_slots, NF);
  if (smem > kBrickSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)g.nbx * g.nby * g.nbz;
  int rc = prepare(bulk_bricks_k<T, F>, smem, blocks);
  if (rc != 0) return rc;
  Fields<T> f;
  for (int q = 0; q < 3; ++q) f.f[q] = (const T*)in[q < NF ? q : 0];
  bulk_bricks_k<T, F><<<(unsigned)blocks, kBrickThreads, smem,
                        (cudaStream_t)stream>>>(
      f, (T*)out, g, (const int4*)slots, n_slots, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bricks(int flux, const void* const* in, void* out, const int* gi,
                  const int* si, const void* slots, int n_slots, Coef k,
                  int device, void* stream) {
  switch (flux) {
    case Diffuse::kCode:
      return launch_bricks<T, Diffuse>(in, out, gi, si, slots, n_slots, k,
                                       device, stream);
    case AdvectX::kCode:
      return launch_bricks<T, AdvectX>(in, out, gi, si, slots, n_slots, k,
                                       device, stream);
    case UpwindXY::kCode:
      return launch_bricks<T, UpwindXY>(in, out, gi, si, slots, n_slots, k,
                                        device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all four arrays the same type).
// geom: nx, ny, nz, px, py, pz, k, bx, by, bz, rx, ry, rz: the interior
// of a block's window and the reach of one sub-step per axis (the plane
// route: bx a band of whole warps up to 256 columns, by the rows of a
// y segment, bz 1, reach 1, 1, 0). slots: the face set's four rows of
// (ox, oy, oz, fx, fy) in kFace4's order. `out` must not alias an input.
extern "C" int dccrg_bulk_upwind_k(int dtype, const void* rho,
                                   const void* vx, const void* vy, void* out,
                                   const int* geom, const int* slots,
                                   int n_slots, float c0, float c1,
                                   int device, void* stream) {
  if (dtype == 0)
    return launch_face<float>(rho, vx, vy, out, geom, slots, n_slots, c0,
                              c1, device, stream);
  if (dtype == 1)
    return launch_face<__nv_bfloat16>(rho, vx, vy, out, geom, slots,
                                      n_slots, c0, c1, device, stream);
  return (int)cudaErrorInvalidValue;
}

// The bricks of any flux: dtype and geom as above; flux a functor's
// kCode (fluxes.cuh); in the flux's kFields field pointers, field 0 the
// carried one; host_slots and slots the same n_slots int4 rows (ox, oy,
// oz, code) in the neighbourhood's order, on the host (checked against
// the reach) and in device memory (read by the kernel), at most 124;
// a, b: Coef. `out` must not alias an input.
extern "C" int dccrg_bulk_bricks(int dtype, int flux, const void* const* in,
                                 void* out, const int* geom,
                                 const int* host_slots, const void* slots,
                                 int n_slots, float a, float b, int device,
                                 void* stream) {
  const Coef k = {a, b};
  if (dtype == 0)
    return launch_bricks<float>(flux, in, out, geom, host_slots, slots,
                                n_slots, k, device, stream);
  if (dtype == 1)
    return launch_bricks<__nv_bfloat16>(flux, in, out, geom, host_slots,
                                        slots, n_slots, k, device, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dccrg_bulk_k_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
