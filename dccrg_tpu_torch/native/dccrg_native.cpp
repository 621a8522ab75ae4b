// Native host runtime for dccrg_tpu_torch: the port's own copy of the
// reference package's host engine (dccrg_tpu/native/dccrg_native.cpp),
// with the same extern "C" ABI (dn_abi_version() == 2).
//
// C++ equivalents of the host-side structure code that the reference
// implements in C++ (dccrg is a header-only C++ library): the AMR cell
// addressing scheme (dccrg_mapping.hpp), the neighbor-table builder
// (dccrg.hpp:4236-4897 find_neighbors_of / find_neighbors_to), and the
// space-filling-curve keys used for partitioning (dccrg.hpp:8147-8220,
// sfc++ replacement).  These run at structure-change events (init,
// refine, restart load) on the host; results are identical to the NumPy
// implementations in ../neighbors.py, ../hybrid.py, ../geometry.py and
// the reference's partition.py, which remain as fallback and as the
// cross-check used by the tests.  It is host code for the CPU, built
// with g++ at first use; nothing here runs on the GPU.
//
// Exposed as a plain C ABI for ctypes.  All output buffers are
// caller-allocated; functions that emit ragged output take a capacity
// and return the required entry count so the caller can retry with a
// larger buffer (entries beyond capacity are counted, not written).
// Built with -ffp-contract=off: no FMA contraction, so the geometry
// kernels round like the NumPy paths, bit for bit.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Mapping: 1-based, level-major cell ids (parity with dccrg_mapping.hpp).

// Division by a runtime-invariant u64 via 128-bit reciprocal multiply:
// recip = floor((2^64 - 1) / d) gives q0 = mulhi(n, recip) within 2 of
// floor(n / d) for any n; a tiny correction loop finishes the job.
// (Replaces the hardware divides in the per-cell index math — the hot
// op of the geometry/position lookups, tests/geometry README.)
struct DnDiv {
  uint64_t d;
  uint64_t recip;
};

static inline DnDiv dn_div_make(uint64_t d) {
  DnDiv v;
  v.d = d;
  v.recip = d ? ~(uint64_t)0 / d : 0;
  return v;
}

static inline uint64_t dn_div(uint64_t n, const DnDiv dv, uint64_t *rem) {
  uint64_t q = (uint64_t)(((__uint128_t)n * dv.recip) >> 64);
  uint64_t r = n - q * dv.d;
  while (r >= dv.d) {
    r -= dv.d;
    ++q;
  }
  *rem = r;
  return q;
}

struct DnMapping {
  uint64_t length[3];       // level-0 extents
  int32_t max_lvl;          // maximum refinement level
  uint64_t level_first[32]; // first cell id of each level (1-based)
  uint64_t last_cell;
  uint64_t index_length[3]; // extents in smallest-cell index units
  DnDiv div_lx[32];         // per-level reciprocal divisors for
  DnDiv div_ly[32];         // length[0] << lvl and length[1] << lvl
};

static void dn_mapping_init(DnMapping *m, const uint64_t length[3],
                            int32_t max_lvl) {
  m->length[0] = length[0];
  m->length[1] = length[1];
  m->length[2] = length[2];
  m->max_lvl = max_lvl;
  const uint64_t gl = length[0] * length[1] * length[2];
  uint64_t acc = 1, per = gl;
  for (int l = 0; l <= max_lvl; ++l) {
    m->level_first[l] = acc;
    acc += per;
    per *= 8;
    m->div_lx[l] = dn_div_make(length[0] << (uint64_t)l);
    m->div_ly[l] = dn_div_make(length[1] << (uint64_t)l);
  }
  m->last_cell = acc - 1;
  for (int d = 0; d < 3; ++d)
    m->index_length[d] = length[d] << (uint64_t)max_lvl;
}

static inline int32_t dn_level(const DnMapping *m, uint64_t cell) {
  if (cell == 0 || cell > m->last_cell)
    return -1;
  // branchless: level = (number of level-firsts <= cell) - 1; random
  // per-cell levels would mispredict an early-exit scan on every call
  int32_t lvl = -1;
  for (int32_t l = 0; l <= m->max_lvl; ++l)
    lvl += (int32_t)(cell >= m->level_first[l]);
  return lvl;
}

// indices (smallest-cell units) of a cell known to be valid at level lvl
static inline void dn_indices(const DnMapping *m, uint64_t cell, int32_t lvl,
                              uint64_t out[3]) {
  const uint64_t within = cell - m->level_first[lvl];
  const uint64_t shift = (uint64_t)(m->max_lvl - lvl);
  uint64_t ox, oy;
  const uint64_t rest = dn_div(within, m->div_lx[lvl], &ox);
  const uint64_t oz = dn_div(rest, m->div_ly[lvl], &oy);
  out[0] = ox << shift;
  out[1] = oy << shift;
  out[2] = oz << shift;
}

// cell id at given smallest-cell indices and refinement level
// (indices must be inside the grid, lvl in [0, max_lvl])
static inline uint64_t dn_cell_from_indices(const DnMapping *m,
                                            const uint64_t idx[3],
                                            int32_t lvl) {
  const uint64_t shift = (uint64_t)(m->max_lvl - lvl);
  const uint64_t ox = idx[0] >> shift, oy = idx[1] >> shift,
                 oz = idx[2] >> shift;
  const uint64_t lx = m->length[0] << (uint64_t)lvl;
  const uint64_t ly = m->length[1] << (uint64_t)lvl;
  return m->level_first[lvl] + ox + oy * lx + oz * lx * ly;
}

// ---------------------------------------------------------------------------
// Neighbor-table builder (semantics of dccrg.hpp:4375-4716; algorithm of
// ../neighbors.py::find_neighbors_of: binary search in the sorted
// replicated leaf-cell set instead of walking per-cell links).

static inline bool dn_exists(const uint64_t *cells, int64_t n, uint64_t id) {
  const uint64_t *p = std::lower_bound(cells, cells + n, id);
  return p != cells + n && *p == id;
}

// Per-(cell, neighborhood-item) resolution. Writes up to 8 entries into
// nbr/off (off is the neighbor's min-corner displacement in
// smallest-cell units, logical i.e. unwrapped across periodic faces).
// Returns entry count, or a negative error code:
//   -1 window not covered at max level (grid does not tile)
//   -2 window neither same-level, coarser, nor tiled by children
static inline int dn_resolve_window(
    const DnMapping *m, const uint8_t periodic[3], const uint64_t *cells,
    int64_t n_cells, const int64_t base[3], int64_t size, int32_t lvl,
    const int64_t hood[3], uint64_t nbr[8], int64_t off[8][3]) {
  int64_t win[3];
  uint64_t wrapped[3];
  for (int d = 0; d < 3; ++d) {
    win[d] = base[d] + hood[d] * size;
    const int64_t il = (int64_t)m->index_length[d];
    if (periodic[d]) {
      int64_t w = win[d] % il;
      if (w < 0)
        w += il;
      wrapped[d] = (uint64_t)w;
    } else {
      if (win[d] < 0 || win[d] >= il)
        return 0; // outside a non-periodic boundary: no neighbor
      wrapped[d] = (uint64_t)win[d];
    }
  }

  // same-level cell occupying the window
  const uint64_t slot = dn_cell_from_indices(m, wrapped, lvl);
  if (dn_exists(cells, n_cells, slot)) {
    nbr[0] = slot;
    for (int d = 0; d < 3; ++d)
      off[0][d] = hood[d] * size;
    return 1;
  }

  // coarser (level-1) cell containing the window
  if (lvl > 0) {
    const uint64_t coarse = dn_cell_from_indices(m, wrapped, lvl - 1);
    if (dn_exists(cells, n_cells, coarse)) {
      const uint64_t csize = 2 * (uint64_t)size;
      nbr[0] = coarse;
      for (int d = 0; d < 3; ++d) {
        const int64_t cmin = (int64_t)((wrapped[d] / csize) * csize);
        off[0][d] = hood[d] * size + (cmin - (int64_t)wrapped[d]);
      }
      return 1;
    }
  }

  // finer: the window's 8 child cells in z-order (x fastest)
  if (lvl >= m->max_lvl)
    return -1;
  const int64_t half = size / 2;
  for (int k = 0; k < 8; ++k) {
    const int64_t rel[3] = {(k & 1) * half, ((k >> 1) & 1) * half,
                            ((k >> 2) & 1) * half};
    uint64_t cidx[3];
    for (int d = 0; d < 3; ++d)
      cidx[d] = wrapped[d] + (uint64_t)rel[d];
    const uint64_t child = dn_cell_from_indices(m, cidx, lvl + 1);
    if (!dn_exists(cells, n_cells, child))
      return -2;
    nbr[k] = child;
    for (int d = 0; d < 3; ++d)
      off[k][d] = hood[d] * size + rel[d];
  }
  return 8;
}

// neighbors_of for query_cells against the complete sorted leaf-cell
// set.  Output entries are ordered (query position, neighborhood item,
// z-order child rank) — identical to the NumPy engine's lexsort order.
// Returns the total entry count (may exceed capacity; entries past
// capacity are not written), or negative on error with the offending
// (cell, item) in err_cell/err_item:
//   -1 tiling gap at max refinement level
//   -2 2:1 balance violation or gap
//   -3 invalid cell id in query
int64_t dn_find_neighbors_of(
    const uint64_t grid_length[3], int32_t max_lvl, const uint8_t periodic[3],
    const uint64_t *cells_sorted, int64_t n_cells, const uint64_t *query,
    int64_t n_query, const int64_t *hood, int64_t n_hood, int64_t *out_src,
    uint64_t *out_nbr, int64_t *out_off, int64_t *out_item, int64_t capacity,
    uint64_t *err_cell, int64_t *err_item) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);

  // pass 1: per-query entry counts (parallel)
  std::vector<int64_t> counts((size_t)n_query, 0);
  int64_t err_flag = 0; // 0 ok, else -1/-2/-3
  int64_t err_q = -1, err_k = -1;

#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_query; ++q) {
    int64_t seen_err;
#pragma omp atomic read
    seen_err = err_flag;
    if (seen_err)
      continue;
    const uint64_t cell = query[q];
    const int32_t lvl = dn_level(&m, cell);
    if (lvl < 0) {
#pragma omp critical
      {
        if (!err_flag) {
          err_q = q;
          err_k = 0;
#pragma omp atomic write
          err_flag = -3;
        }
      }
      continue;
    }
    const int64_t size = (int64_t)1 << (uint64_t)(max_lvl - lvl);
    uint64_t bidx[3];
    dn_indices(&m, cell, lvl, bidx);
    const int64_t base[3] = {(int64_t)bidx[0], (int64_t)bidx[1],
                             (int64_t)bidx[2]};
    int64_t cnt = 0;
    uint64_t nbr[8];
    int64_t off[8][3];
    for (int64_t k = 0; k < n_hood; ++k) {
      const int r = dn_resolve_window(&m, periodic, cells_sorted, n_cells,
                                      base, size, lvl, &hood[3 * k], nbr, off);
      if (r < 0) {
#pragma omp critical
        {
          if (!err_flag) {
            err_q = q;
            err_k = k;
#pragma omp atomic write
            err_flag = r;
          }
        }
        break;
      }
      cnt += r;
    }
    counts[(size_t)q] = cnt;
  }
  if (err_flag) {
    if (err_cell)
      *err_cell = query[err_q];
    if (err_item)
      *err_item = err_k;
    return err_flag;
  }

  // prefix sum
  std::vector<int64_t> starts((size_t)n_query + 1);
  starts[0] = 0;
  for (int64_t q = 0; q < n_query; ++q)
    starts[(size_t)q + 1] = starts[(size_t)q] + counts[(size_t)q];
  const int64_t total = starts[(size_t)n_query];
  if (total > capacity)
    return total; // caller re-allocates and retries

  // pass 2: fill (parallel, deterministic via per-query offsets)
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_query; ++q) {
    const uint64_t cell = query[q];
    const int32_t lvl = dn_level(&m, cell);
    const int64_t size = (int64_t)1 << (uint64_t)(max_lvl - lvl);
    uint64_t bidx[3];
    dn_indices(&m, cell, lvl, bidx);
    const int64_t base[3] = {(int64_t)bidx[0], (int64_t)bidx[1],
                             (int64_t)bidx[2]};
    int64_t w = starts[(size_t)q];
    uint64_t nbr[8];
    int64_t off[8][3];
    for (int64_t k = 0; k < n_hood; ++k) {
      const int r = dn_resolve_window(&m, periodic, cells_sorted, n_cells,
                                      base, size, lvl, &hood[3 * k], nbr, off);
      for (int j = 0; j < r; ++j, ++w) {
        out_src[w] = q;
        out_nbr[w] = nbr[j];
        out_off[3 * w + 0] = off[j][0];
        out_off[3 * w + 1] = off[j][1];
        out_off[3 * w + 2] = off[j][2];
        out_item[w] = k;
      }
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Space-filling-curve keys over cell min-corner indices (sfc++ / HSFC
// replacement; parity with the reference's partition.py::morton_key / hilbert_key).

// Morton: bit-interleave (x lowest) at smallest-cell resolution.
void dn_morton_keys(const uint64_t *indices, int64_t n, int32_t bits,
                    uint64_t *out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = 0;
    for (int32_t b = 0; b < bits; ++b)
      for (int d = 0; d < 3; ++d)
        key |= ((indices[3 * i + d] >> (uint64_t)b) & 1u)
               << (uint64_t)(3 * b + d);
    out[i] = key;
  }
}

// Hilbert: Skilling's transpose algorithm (3-D).
void dn_hilbert_keys(const uint64_t *indices, int64_t n, int32_t bits,
                     uint64_t *out) {
  const uint64_t N = (uint64_t)1 << (uint64_t)bits;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t x[3] = {indices[3 * i], indices[3 * i + 1], indices[3 * i + 2]};
    // Gray-decode: inverse undo excess work
    for (uint64_t q = N >> 1; q > 1; q >>= 1) {
      const uint64_t p = q - 1;
      for (int d = 0; d < 3; ++d) {
        if (x[d] & q) {
          x[0] ^= p;
        } else {
          const uint64_t t = (x[0] ^ x[d]) & p;
          x[0] ^= t;
          x[d] ^= t;
        }
      }
    }
    // Gray encode
    for (int d = 1; d < 3; ++d)
      x[d] ^= x[d - 1];
    uint64_t t = 0;
    for (uint64_t q = N >> 1; q > 1; q >>= 1)
      if (x[2] & q)
        t ^= q - 1;
    for (int d = 0; d < 3; ++d)
      x[d] ^= t;
    // interleave transpose form, MSB first, dim 0 highest per group
    uint64_t key = 0;
    for (int32_t b = bits - 1; b >= 0; --b)
      for (int d = 0; d < 3; ++d)
        key = (key << 1) | ((x[d] >> (uint64_t)b) & 1u);
    out[i] = key;
  }
}

// ---------------------------------------------------------------------------
// Vectorized mapping queries (host-side bulk id math).

// refinement level per cell (-1 for invalid ids)
void dn_refinement_levels(const uint64_t grid_length[3], int32_t max_lvl,
                          const uint64_t *cells, int64_t n, int32_t *out) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    out[i] = dn_level(&m, cells[i]);
}

// (n,3) min-corner indices per cell; all-ones rows (~0) for invalid ids
void dn_cell_indices(const uint64_t grid_length[3], int32_t max_lvl,
                     const uint64_t *cells, int64_t n, uint64_t *out) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lvl = dn_level(&m, cells[i]);
    if (lvl < 0) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = ~(uint64_t)0;
    } else {
      dn_indices(&m, cells[i], lvl, &out[3 * i]);
    }
  }
}

// Per-cell geometry lookup: min corner and edge lengths from
// per-dimension level-0 boundary coordinate arrays (bd[d] has
// grid_length[d]+1 monotone values).  Covers all three geometries —
// the hot path of the reference's geometry micro-benchmarks
// (tests/geometry README).  NaN rows for invalid ids.
void dn_geometry_min_len(const uint64_t grid_length[3], int32_t max_lvl,
                         const double *bx, const double *by, const double *bz,
                         const uint64_t *cells, int64_t n, double *out_min,
                         double *out_len) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
  const double *bd[3] = {bx, by, bz};
  const double inv_scale = 1.0 / (double)((uint64_t)1 << max_lvl);
  const uint64_t mask = ((uint64_t)1 << max_lvl) - 1;
  const double nan = std::numeric_limits<double>::quiet_NaN();
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lvl = dn_level(&m, cells[i]);
    if (lvl < 0) {
      for (int d = 0; d < 3; ++d) {
        out_min[3 * i + d] = nan;
        out_len[3 * i + d] = nan;
      }
      continue;
    }
    uint64_t idx[3];
    dn_indices(&m, cells[i], lvl, idx);
    const double extent = 1.0 / (double)((uint64_t)1 << lvl);
    for (int d = 0; d < 3; ++d) {
      const uint64_t l0 = idx[d] >> max_lvl;
      const double lo = bd[d][l0], hi = bd[d][l0 + 1];
      const double frac = (double)(idx[d] & mask) * inv_scale;
      out_min[3 * i + d] = lo + frac * (hi - lo);
      out_len[3 * i + d] = (hi - lo) * extent;
    }
  }
}

// Per-cell center coordinates in one pass (no separate min/len
// round-trip through the caller).
void dn_geometry_centers(const uint64_t grid_length[3], int32_t max_lvl,
                         const double *bx, const double *by, const double *bz,
                         const uint64_t *cells, int64_t n, double *out) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
  const double *bd[3] = {bx, by, bz};
  const double inv_scale = 1.0 / (double)((uint64_t)1 << max_lvl);
  const uint64_t mask = ((uint64_t)1 << max_lvl) - 1;
  const double nan = std::numeric_limits<double>::quiet_NaN();
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lvl = dn_level(&m, cells[i]);
    if (lvl < 0) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = nan;
      continue;
    }
    uint64_t idx[3];
    dn_indices(&m, cells[i], lvl, idx);
    const double half_extent = 0.5 / (double)((uint64_t)1 << lvl);
    for (int d = 0; d < 3; ++d) {
      const uint64_t l0 = idx[d] >> max_lvl;
      const double lo = bd[d][l0], hi = bd[d][l0 + 1];
      const double frac = (double)(idx[d] & mask) * inv_scale;
      out[3 * i + d] = lo + (frac + half_extent) * (hi - lo);
    }
  }
}

// Per-cell edge lengths only: level lookup + a copy from the
// (max_lvl+1, 3) per-level length table — no index math (the
// reference's "cell size" micro-benchmark, tests/geometry README).
void dn_cell_lengths(const uint64_t grid_length[3], int32_t max_lvl,
                     const double *len_table, const uint64_t *cells,
                     int64_t n, double *out) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
  const double nan = std::numeric_limits<double>::quiet_NaN();
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t lvl = dn_level(&m, cells[i]);
    const double *row = lvl < 0 ? nullptr : &len_table[3 * lvl];
    out[3 * i] = row ? row[0] : nan;
    out[3 * i + 1] = row ? row[1] : nan;
    out[3 * i + 2] = row ? row[2] : nan;
  }
}

// Stencil gather-table builder (the runtime's plan construction —
// reference update_cell_pointers, dccrg.hpp:11453-11767): pad the
// ragged per-cell neighbor entry stream into [n_dev, L, S] tables.
// Entries arrive ordered per cell; a sequential fill with per-(dev,
// row) slot counters preserves that order with no sort at all.
int64_t dn_table_counts(const int32_t *entry_dev, const int32_t *src_rows,
                        int64_t n, int64_t n_dev, int64_t L,
                        int64_t *counts /* [n_dev*L], zeroed */) {
  int64_t s_max = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t c = ++counts[(int64_t)entry_dev[i] * L + src_rows[i]];
    if (c > s_max)
      s_max = c;
  }
  return s_max;
}

void dn_table_fill(const int32_t *entry_dev, const int32_t *src_rows,
                   const int32_t *nbr_rows, const int64_t *offs, int64_t n,
                   int64_t n_dev, int64_t L, int64_t S, int64_t *slots
                   /* [n_dev*L], zeroed */, int32_t *rows_out
                   /* [n_dev*L*S], pre-filled with the pad row */,
                   int32_t *offs_out /* [n_dev*L*S*3], zeroed */,
                   uint8_t *mask_out /* [n_dev*L*S], zeroed */) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t cell = (int64_t)entry_dev[i] * L + src_rows[i];
    const int64_t at = cell * S + slots[cell]++;
    rows_out[at] = nbr_rows[i];
    offs_out[3 * at] = (int32_t)offs[3 * i];
    offs_out[3 * at + 1] = (int32_t)offs[3 * i + 1];
    offs_out[3 * at + 2] = (int32_t)offs[3 * i + 2];
    mask_out[at] = 1;
  }
}

// Uniform (all-level-0) gather tables in ONE pass (the fast path of
// plan construction, uniform.py): for every cell and neighborhood item
// write the neighbor's row on the reader's device into rows_out[i*k+j]
// and its existence into mask_out. Interior cells — the overwhelming
// majority — resolve through a precomputed flat-index delta per item;
// only boundary cells take the wrap/validity math. Cross-device
// neighbors are emitted as the sentinel ``-2 - neighbor_gidx`` for the
// (small) host-side ghost-row fixup. owner == NULL means one device
// (no cross edges possible).
void dn_uniform_tables(int64_t nx, int64_t ny, int64_t nz, int32_t px,
                       int32_t py, int32_t pz,
                       const int64_t *offs /* [k, 3] cell units */, int64_t k,
                       const int32_t *row_of_pos /* [n0] */,
                       const int32_t *owner /* [n0] or NULL */,
                       int32_t pad_row,
                       int32_t *rows_out /* [n0, k] */,
                       uint8_t *mask_out /* [n0, k] */) {
  const int64_t nxy = nx * ny;
  std::vector<int64_t> dflat(k), lo(3, 0), hi(3);
  hi[0] = nx;
  hi[1] = ny;
  hi[2] = nz;
  for (int64_t j = 0; j < k; ++j) {
    dflat[j] = offs[3 * j] + offs[3 * j + 1] * nx + offs[3 * j + 2] * nxy;
    // interior box: cells whose every neighbor is in-bounds unwrapped
    lo[0] = std::max(lo[0], -offs[3 * j]);
    hi[0] = std::min(hi[0], nx - offs[3 * j]);
    lo[1] = std::max(lo[1], -offs[3 * j + 1]);
    hi[1] = std::min(hi[1], ny - offs[3 * j + 1]);
    lo[2] = std::max(lo[2], -offs[3 * j + 2]);
    hi[2] = std::min(hi[2], nz - offs[3 * j + 2]);
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t z = 0; z < nz; ++z) {
    for (int64_t y = 0; y < ny; ++y) {
      const int64_t rowbase = y * nx + z * nxy;
      const bool yz_interior =
          y >= lo[1] && y < hi[1] && z >= lo[2] && z < hi[2];
      for (int64_t x = 0; x < nx; ++x) {
        const int64_t i = rowbase + x;
        int32_t *rout = rows_out + i * k;
        uint8_t *mout = mask_out + i * k;
        if (yz_interior && x >= lo[0] && x < hi[0]) {
          if (owner == nullptr) {
            for (int64_t j = 0; j < k; ++j) {
              rout[j] = row_of_pos[i + dflat[j]];
              mout[j] = 1;
            }
          } else {
            const int32_t own = owner[i];
            for (int64_t j = 0; j < k; ++j) {
              const int64_t ng = i + dflat[j];
              rout[j] = owner[ng] == own ? row_of_pos[ng]
                                         : (int32_t)(-2 - ng);
              mout[j] = 1;
            }
          }
          continue;
        }
        for (int64_t j = 0; j < k; ++j) {
          int64_t xx = x + offs[3 * j], yy = y + offs[3 * j + 1],
                  zz = z + offs[3 * j + 2];
          bool valid = true;
          if (xx < 0 || xx >= nx) {
            if (px)
              xx = ((xx % nx) + nx) % nx;
            else
              valid = false;
          }
          if (yy < 0 || yy >= ny) {
            if (py)
              yy = ((yy % ny) + ny) % ny;
            else
              valid = false;
          }
          if (zz < 0 || zz >= nz) {
            if (pz)
              zz = ((zz % nz) + nz) % nz;
            else
              valid = false;
          }
          if (!valid) {
            rout[j] = pad_row;
            mout[j] = 0;
            continue;
          }
          const int64_t ng = xx + yy * nx + zz * nxy;
          if (owner != nullptr && owner[ng] != owner[i])
            rout[j] = (int32_t)(-2 - ng);
          else
            rout[j] = row_of_pos[ng];
          mout[j] = 1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Recommit fast-path kernels (../hybrid.py): the AMR plan re-commit's
// hot loops, moved out of numpy so a 192^3 rebuild stops paying
// multi-GB temporary materialization + page faults (ROADMAP "Hybrid
// re-commit cost at 192^3").  All functions are bitwise-equivalent to
// the numpy fallbacks at the level the plan consumes (gather tables,
// masks, merged streams) — pinned by tests/test_torch_native.py.

// positions of sorted needles in a sorted haystack — np.searchsorted
// (side='left') lowered to one linear sweep, O(n + m) instead of
// O(m log n), since both inputs are sorted cell-id arrays.
void dn_sorted_positions(const uint64_t *hay, int64_t n,
                         const uint64_t *needles, int64_t m, int64_t *out) {
  int64_t i = 0;
  for (int64_t j = 0; j < m; ++j) {
    const uint64_t v = needles[j];
    while (i < n && hay[i] < v) ++i;
    out[j] = i;
  }
}

// Batched level-block neighbor-position lookup: for the contiguous
// block of level-l cells at positions [a, b) in the sorted cell list,
// resolve every (cell, offset) pair of the whole symmetrized offset
// set in one call (hybrid._LevelBlock.lookup's per-offset
// lattice/searchsorted loop).  `plat` is caller-provided scratch of
// n_lat int32 (the level-l position lattice, arena-reused across
// epochs); pass NULL to use per-item binary search instead (huge
// lattices).  Outputs are [kb, m]: position in the cell list (0 when
// the neighbor does not exist), in-grid validity, and existence as a
// level-l leaf.
void dn_level_lookup(int64_t nxl, int64_t nyl, int64_t nzl, int32_t px,
                     int32_t py, int32_t pz, const int64_t *lin, int64_t m,
                     int64_t a, const uint64_t *cells, int64_t b,
                     uint64_t first, const int64_t *offs, int64_t kb,
                     int32_t *plat, int64_t n_lat, int32_t *pos_out,
                     uint8_t *valid_out, uint8_t *exist_out) {
  std::vector<int32_t> xs((size_t)m), ys((size_t)m), zs((size_t)m);
  const int64_t nxy = nxl * nyl;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t l = lin[i];
    xs[(size_t)i] = (int32_t)(l % nxl);
    ys[(size_t)i] = (int32_t)((l / nxl) % nyl);
    zs[(size_t)i] = (int32_t)(l / nxy);
  }
  if (plat != nullptr) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_lat; ++i)
      plat[i] = -1;
    for (int64_t i = 0; i < m; ++i)
      plat[lin[i]] = (int32_t)(a + i);
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t j = 0; j < kb; ++j) {
    const int64_t ox = offs[3 * j], oy = offs[3 * j + 1], oz = offs[3 * j + 2];
    int32_t *po = pos_out + j * m;
    uint8_t *vo = valid_out + j * m;
    uint8_t *eo = exist_out + j * m;
    for (int64_t i = 0; i < m; ++i) {
      int64_t x = xs[(size_t)i] + ox, y = ys[(size_t)i] + oy,
              z = zs[(size_t)i] + oz;
      bool valid = true;
      if (x < 0 || x >= nxl) {
        if (px)
          x = ((x % nxl) + nxl) % nxl;
        else
          valid = false;
      }
      if (y < 0 || y >= nyl) {
        if (py)
          y = ((y % nyl) + nyl) % nyl;
        else
          valid = false;
      }
      if (z < 0 || z >= nzl) {
        if (pz)
          z = ((z % nzl) + nzl) % nzl;
        else
          valid = false;
      }
      int32_t p = 0;
      bool exist = false;
      if (valid) {
        const int64_t lin_n = x + nxl * (y + nyl * z);
        if (plat != nullptr) {
          const int32_t q = plat[lin_n];
          if (q >= 0) {
            exist = true;
            p = q;
          }
        } else {
          const uint64_t nid = first + (uint64_t)lin_n;
          const uint64_t *lo = std::lower_bound(cells + a, cells + b, nid);
          if (lo != cells + b && *lo == nid) {
            exist = true;
            p = (int32_t)(lo - cells);
          }
        }
      }
      po[i] = p;
      vo[i] = (uint8_t)valid;
      eo[i] = (uint8_t)exist;
    }
  }
}

// Far-row gather tables written IN PLACE: the level-0 lattice rows of
// dn_uniform_tables restricted to the far slots and scattered straight
// into the (arena-reused) [n_rows, k] hybrid table at far_rowidx — no
// [n0, k] intermediate, no host-side gather + scatter passes.
// Cross-device entries carry the ``-2 - neighbor_slot`` sentinel and
// their (far index, item) pair is appended (packed i * k + j) to
// fix_out so the host fixes up ONLY the partition surface.  Returns
// the fixup count (may exceed fix_cap: caller re-calls with a larger
// buffer; table writes are idempotent).
int64_t dn_far_tables(int64_t nx, int64_t ny, int64_t nz, int32_t px,
                      int32_t py, int32_t pz, const int64_t *offs, int64_t k,
                      const int64_t *far_slots, int64_t nf,
                      const int64_t *far_rowidx, const int32_t *row_of_pos0,
                      const int32_t *owner0, int32_t pad_row, int32_t *rows_t,
                      uint8_t *mask_t, int64_t *fix_out, int64_t fix_cap) {
  const int64_t nxy = nx * ny;
  std::vector<int64_t> dflat((size_t)k), lo(3, 0), hi(3);
  hi[0] = nx;
  hi[1] = ny;
  hi[2] = nz;
  for (int64_t j = 0; j < k; ++j) {
    dflat[(size_t)j] = offs[3 * j] + offs[3 * j + 1] * nx + offs[3 * j + 2] * nxy;
    lo[0] = std::max(lo[0], -offs[3 * j]);
    hi[0] = std::min(hi[0], nx - offs[3 * j]);
    lo[1] = std::max(lo[1], -offs[3 * j + 1]);
    hi[1] = std::min(hi[1], ny - offs[3 * j + 1]);
    lo[2] = std::max(lo[2], -offs[3 * j + 2]);
    hi[2] = std::min(hi[2], nz - offs[3 * j + 2]);
  }
  int64_t n_fix = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < nf; ++i) {
    const int64_t g = far_slots[i];
    const int64_t x = g % nx, y = (g / nx) % ny, z = g / nxy;
    int32_t *rout = rows_t + far_rowidx[i] * k;
    uint8_t *mout = mask_t + far_rowidx[i] * k;
    const bool interior = x >= lo[0] && x < hi[0] && y >= lo[1] &&
                          y < hi[1] && z >= lo[2] && z < hi[2];
    const int32_t own = owner0 ? owner0[g] : 0;
    for (int64_t j = 0; j < k; ++j) {
      int64_t ng;
      if (interior) {
        ng = g + dflat[(size_t)j];
      } else {
        int64_t xx = x + offs[3 * j], yy = y + offs[3 * j + 1],
                zz = z + offs[3 * j + 2];
        bool valid = true;
        if (xx < 0 || xx >= nx) {
          if (px)
            xx = ((xx % nx) + nx) % nx;
          else
            valid = false;
        }
        if (yy < 0 || yy >= ny) {
          if (py)
            yy = ((yy % ny) + ny) % ny;
          else
            valid = false;
        }
        if (zz < 0 || zz >= nz) {
          if (pz)
            zz = ((zz % nz) + nz) % nz;
          else
            valid = false;
        }
        if (!valid) {
          rout[j] = pad_row;
          mout[j] = 0;
          continue;
        }
        ng = xx + yy * nx + zz * nxy;
      }
      if (owner0 != nullptr && owner0[ng] != own) {
        rout[j] = (int32_t)(-2 - ng);
        int64_t at;
#ifdef _OPENMP
#pragma omp atomic capture
#endif
        at = n_fix++;
        if (at < fix_cap)
          fix_out[at] = i * k + j;
      } else {
        rout[j] = row_of_pos0[ng];
      }
      mout[j] = 1;
    }
  }
  return n_fix;
}

// Easy-row gather tables written IN PLACE from the batched level-block
// lookup results: for every easy cell e and neighborhood item j, the
// same-level neighbor's row goes straight into the [n_rows, k] table
// at ridx[e] (hybrid.py's posm/validm staging + resolve_rows pass).
// `sel` maps each hood item to its row in the [kb, m] batch arrays.
// Cross-device entries get the ``-2 - neighbor_position`` sentinel +
// a packed (e * k + j) fixup record, as dn_far_tables.
int64_t dn_easy_tables(const int64_t *ei, int64_t E, const int64_t *ridx,
                       const int64_t *sel, int64_t k, const int32_t *pos_all,
                       const uint8_t *valid_all, int64_t m,
                       const int32_t *row_of_pos, const int32_t *owner,
                       const int32_t *edev, int32_t pad_row, int32_t *rows_t,
                       uint8_t *mask_t, int64_t *fix_out, int64_t fix_cap) {
  int64_t n_fix = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t e = 0; e < E; ++e) {
    const int64_t be = ei[e];
    int32_t *rout = rows_t + ridx[e] * k;
    uint8_t *mout = mask_t + ridx[e] * k;
    const int32_t dev = owner ? edev[e] : 0;
    for (int64_t j = 0; j < k; ++j) {
      const int64_t row = sel[j];
      const uint8_t v = valid_all[row * m + be];
      if (!v) {
        rout[j] = pad_row;
        mout[j] = 0;
        continue;
      }
      const int32_t p = pos_all[row * m + be];
      if (owner != nullptr && owner[p] != dev) {
        rout[j] = (int32_t)(-2 - p);
        int64_t at;
#ifdef _OPENMP
#pragma omp atomic capture
#endif
        at = n_fix++;
        if (at < fix_cap)
          fix_out[at] = e * k + j;
      } else {
        rout[j] = row_of_pos[p];
      }
      mout[j] = 1;
    }
  }
  return n_fix;
}

// Hard-table shape probe: one scan of the source-sorted entry stream
// yielding the per-device group (= hard cell) counts and the widest
// group — the quantities the sticky caps bucket into (Hmax, S_hard).
// out = [nG, S_needed, counts[0..n_dev)].
void dn_hard_counts(const int64_t *s_p, int64_t nE, const int32_t *owner,
                    int64_t n_dev, int64_t *out) {
  int64_t nG = 0, s_max = 0;
  for (int64_t d = 0; d < n_dev; ++d)
    out[2 + d] = 0;
  int64_t i = 0;
  while (i < nE) {
    const int64_t sp = s_p[i];
    int64_t cnt = 0;
    while (i < nE && s_p[i] == sp) {
      ++cnt;
      ++i;
    }
    ++nG;
    if (cnt > s_max)
      s_max = cnt;
    ++out[2 + (owner ? owner[sp] : 0)];
  }
  out[0] = nG;
  out[1] = s_max;
}

// Fused hard-table writer: grouping, dense per-device row assignment,
// entry scatter AND pad fill in ONE sequential pass — every byte of
// the four tables is written exactly once (the numpy path pays a full
// pad fill plus a fancy-indexed scatter; at 128^3+ the pad fill alone
// is GBs of cold writes).  Entries arrive source-sorted, so a
// device's rows fill consecutively (identical to the numpy stable
// argsort by device).  Cross-device neighbors get the
// ``-2 - position`` sentinel + a packed flat-table-index fixup, as
// the far/easy writers.  Returns the fixup count.
int64_t dn_hard_fill(const int64_t *s_p, const int64_t *s_n,
                     const int64_t *s_off, int64_t nE, const int32_t *owner,
                     const int32_t *row_of_pos, int64_t n_dev, int64_t Hmax,
                     int64_t S, int32_t row_pad, int32_t nbr_pad,
                     int32_t *rows_dev, int32_t *nbr_dev, int32_t *offs_dev,
                     uint8_t *mask_dev, int64_t *fix_out, int64_t fix_cap) {
  std::vector<int64_t> cursor((size_t)n_dev, 0);
  int64_t n_fix = 0, i = 0;
  while (i < nE) {
    const int64_t sp = s_p[i];
    const int32_t d = owner ? owner[sp] : 0;
    const int64_t r = cursor[(size_t)d]++;
    const int64_t cell = (int64_t)d * Hmax + r;
    rows_dev[cell] = row_of_pos[sp];
    int64_t slot = 0;
    for (; i < nE && s_p[i] == sp; ++i, ++slot) {
      const int64_t at = cell * S + slot;
      const int64_t np_ = s_n[i];
      if (owner != nullptr && owner[np_] != d) {
        nbr_dev[at] = (int32_t)(-2 - np_);
        if (n_fix < fix_cap)
          fix_out[n_fix] = at;
        ++n_fix;
      } else {
        nbr_dev[at] = row_of_pos[np_];
      }
      offs_dev[3 * at] = (int32_t)s_off[3 * i];
      offs_dev[3 * at + 1] = (int32_t)s_off[3 * i + 1];
      offs_dev[3 * at + 2] = (int32_t)s_off[3 * i + 2];
      mask_dev[at] = 1;
    }
    // slot tail of this row
    for (; slot < S; ++slot) {
      const int64_t at = cell * S + slot;
      nbr_dev[at] = nbr_pad;
      offs_dev[3 * at] = offs_dev[3 * at + 1] = offs_dev[3 * at + 2] = 0;
      mask_dev[at] = 0;
    }
  }
  // row tails of every device
  for (int64_t d = 0; d < n_dev; ++d) {
    for (int64_t r = cursor[(size_t)d]; r < Hmax; ++r) {
      const int64_t cell = d * Hmax + r;
      rows_dev[cell] = row_pad;
      for (int64_t slot = 0; slot < S; ++slot) {
        const int64_t at = cell * S + slot;
        nbr_dev[at] = nbr_pad;
        offs_dev[3 * at] = offs_dev[3 * at + 1] = offs_dev[3 * at + 2] = 0;
        mask_dev[at] = 0;
      }
    }
  }
  return n_fix;
}

// Epoch-to-epoch hard-stream reuse: remap the kept previous-epoch
// entries' positions through old2new and merge them with the freshly
// computed entries, both source-position-sorted, in one linear pass
// (hybrid.py's reuse-branch gather + double-searchsorted merge).  The
// two runs share no source cell (a cell is wholly fresh or wholly
// reused), so the merge is unambiguous; within-source entry order is
// preserved piecewise.  Returns the merged length (may exceed
// capacity: caller re-allocates and retries).
int64_t dn_stream_remap_merge(
    const int64_t *old2new, const uint8_t *reus_old, const int64_t *ps,
    const int64_t *pn, const int64_t *po, const int64_t *pi, int64_t n_prev,
    const int64_t *fs, const int64_t *fn, const int64_t *fo,
    const int64_t *fi, int64_t n_fresh, int64_t *ms, int64_t *mn, int64_t *mo,
    int64_t *mi, int64_t capacity) {
  int64_t nb = 0;
  for (int64_t i = 0; i < n_prev; ++i)
    nb += (int64_t)(reus_old[ps[i]] != 0);
  const int64_t total = n_fresh + nb;
  if (total > capacity)
    return total;
  int64_t ia = 0, ib = 0, w = 0;
  while (ib < n_prev && !reus_old[ps[ib]])
    ++ib;
  while (ia < n_fresh || ib < n_prev) {
    bool take_fresh;
    if (ib >= n_prev)
      take_fresh = true;
    else if (ia >= n_fresh)
      take_fresh = false;
    else
      take_fresh = fs[ia] <= old2new[ps[ib]];
    if (take_fresh) {
      ms[w] = fs[ia];
      mn[w] = fn[ia];
      mo[3 * w] = fo[3 * ia];
      mo[3 * w + 1] = fo[3 * ia + 1];
      mo[3 * w + 2] = fo[3 * ia + 2];
      mi[w] = fi[ia];
      ++ia;
    } else {
      ms[w] = old2new[ps[ib]];
      mn[w] = old2new[pn[ib]];
      mo[3 * w] = po[3 * ib];
      mo[3 * w + 1] = po[3 * ib + 1];
      mo[3 * w + 2] = po[3 * ib + 2];
      mi[w] = pi[ib];
      ++ib;
      while (ib < n_prev && !reus_old[ps[ib]])
        ++ib;
    }
    ++w;
  }
  return total;
}

int32_t dn_abi_version(void) { return 2; }


// ---------------------------------------------------------------------------
// Subset neighbors_to: for each query cell v, the cells c with v in
// their neighbors_of (semantics of ../neighbors.py::
// find_neighbors_to_subset's enumeration path, itself mirroring
// dccrg.hpp:4744-4897): candidate window bases are the <=3-per-
// dimension size_c-aligned positions overlapping v's box, enumerated
// per (item, source level); a candidate source counts iff it exists as
// a leaf. Raw entries (duplicates included — the caller dedups exactly
// like the NumPy path) are ordered by query index.

static inline int64_t dn_floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// Returns total entry count (entries past capacity are counted, not
// written), or -3 for an invalid query id.
int64_t dn_find_neighbors_to_subset(
    const uint64_t grid_length[3], int32_t max_lvl, const uint8_t periodic[3],
    const uint64_t *cells_sorted, int64_t n_cells, const uint64_t *query,
    int64_t n_query, const int64_t *hood, int64_t n_hood, int64_t *out_q,
    uint64_t *out_src, int64_t *out_off, int64_t *out_item,
    int64_t capacity) {
  DnMapping m;
  dn_mapping_init(&m, grid_length, max_lvl);
  int64_t total = 0;
  for (int64_t qi = 0; qi < n_query; ++qi) {
    const uint64_t v = query[qi];
    const int32_t lvl = dn_level(&m, v);
    if (lvl < 0)
      return -3;
    const int64_t sv = (int64_t)1 << (uint64_t)(m.max_lvl - lvl);
    uint64_t vb_u[3];
    dn_indices(&m, v, lvl, vb_u);
    const int64_t vb[3] = {(int64_t)vb_u[0], (int64_t)vb_u[1],
                           (int64_t)vb_u[2]};
    for (int64_t j = 0; j < n_hood; ++j) {
      const int64_t *o = hood + 3 * j;
      for (int32_t dlvl = -1; dlvl <= 1; ++dlvl) {
        const int32_t c_lvl = lvl + dlvl;
        if (c_lvl < 0 || c_lvl > m.max_lvl)
          continue;
        const int64_t sc = (int64_t)1 << (uint64_t)(m.max_lvl - c_lvl);
        // per-dim aligned window bases overlapping [vb, vb + sv)
        int64_t w_lo[3];
        int64_t cnt[3];
        for (int d = 0; d < 3; ++d) {
          w_lo[d] = -dn_floordiv(-(vb[d] - sc + 1), sc) * sc;  // ceil*sc
          cnt[d] = (vb[d] + sv - 1 - w_lo[d]) / sc + 1;
          if (cnt[d] < 0)
            cnt[d] = 0;
        }
        for (int64_t ix = 0; ix < cnt[0]; ++ix)
          for (int64_t iy = 0; iy < cnt[1]; ++iy)
            for (int64_t iz = 0; iz < cnt[2]; ++iz) {
              const int64_t w[3] = {w_lo[0] + ix * sc, w_lo[1] + iy * sc,
                                    w_lo[2] + iz * sc};
              bool ok = true;
              uint64_t cw[3];
              for (int d = 0; d < 3; ++d) {
                const int64_t il = (int64_t)m.index_length[d];
                const int64_t cb = w[d] - o[d] * sc;
                if (periodic[d]) {
                  int64_t r = cb % il;
                  if (r < 0)
                    r += il;
                  cw[d] = (uint64_t)r;
                } else {
                  // source cell fully inside, window min inside
                  if (cb < 0 || cb + sc > il || w[d] < 0 || w[d] >= il) {
                    ok = false;
                    break;
                  }
                  cw[d] = (uint64_t)cb;
                }
              }
              if (!ok)
                continue;
              const uint64_t cid = dn_cell_from_indices(&m, cw, c_lvl);
              if (!dn_exists(cells_sorted, n_cells, cid))
                continue;
              if (total < capacity) {
                out_q[total] = qi;
                out_src[total] = cid;
                // recorded to-offset = -(v.min - c.min in c's frame)
                //                    = w - vb - o*sc per dimension
                for (int d = 0; d < 3; ++d)
                  out_off[3 * total + d] = w[d] - vb[d] - o[d] * sc;
                out_item[total] = j;
              }
              ++total;
            }
      }
    }
  }
  return total;
}

} // extern "C"
