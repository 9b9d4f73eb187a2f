// Tile raster kernels for sm_90a: the fused forward (K1), its silhouette
// backward (K2), the depth-only hard raster of the prior views (K3) and the
// mass-only forward of the separate soft silhouette (K4a).
//
// K1 replaces dynhor_tpu/ops/raster_pallas.py:_fused_fwd_kernel, K2 replaces
// dynhor_tpu/ops/raster_pallas.py:_sil_bwd_kernel, K3 replaces
// dynhor_tpu/ops/raster_pallas.py:_depth_fwd_kernel (:205), K4a replaces
// dynhor_tpu/ops/silhouette_pallas.py:_fwd_kernel.  K4b
// (dynhor_tpu/ops/silhouette_pallas.py:_bwd_kernel) computes K2's function:
// both run _tile_mass_grad_analytic over a tile's slots, K4b over every
// 128-slot chunk of the padded cap, K2 up to the tile's count, and the
// padding slots past the count have vis = 0 and add nothing.  So K4b is
// sil_bwd_kernel launched on K4a's rows; there is no second copy of it.
// Plain PyTorch versions live in dynhor_tpu_torch/ops/raster_fused.py
// (tile_mass_depth_plain, tile_mass_grad_plain, tile_depth_plain) and
// dynhor_tpu_torch/ops/silhouette_kernel.py (tile_mass_plain); the wrappers
// in dynhor_tpu_torch/kernels.py launch these kernels for CUDA tensors.
//
// Layout.  rows: (n_rows = frames x tile rows, m slots, 16) f32 records
//   [x0 y0 x1 y1 x2 y2 vis pad | z0 z1 z2 pad x5]; counts: (n_rows,) i32 —
//   slots [0, count) hold the tile's candidate faces in ascending face id,
//   padding slots have vis = 0.  A tile row t's pixel origin is
//   ((t % tiles_w) * tile, (t / tiles_w) * tile) (the packing shifts the xy
//   values of compacted tiles into that frame).  K3 takes rows_all: (B, F,
//   16) per-face records of the same layout, and indices: (n_rows, m) i32,
//   slot j of row r holding face indices[r, j] of frame r / t_rows.
//
// What bounds them.  Each does about a hundred floating-point operations per
// (pixel, slot) pair and reads a slot's 64-byte record once, so operations
// bound them, not bytes: the least time is sum(counts) x 256 pixels x the
// per-pair count over the card's f32 peak.  The counts are what makes that
// hard: a tile's count runs from 0 to the counted cap (1408 at the refine's
// scene), and one block per tile left the card nearly idle while the most
// loaded tiles finished.
//
// K1, K2, K3, K4a and K4b therefore run on a work list cut by the counts, built
// on the device in the same entry point (no host sync):
// - a work item is (row, chunk c of S slots) for c < ceil(count / S); a
//   one-block pre-pass writes each row's first item, start[r] = sum over
//   r' < r of ceil(count[r'] / S), and the total at start[n_rows].  Rows of
//   count 0 cost no item.
// - the grid is persistent: as many blocks as the SMs hold at once.  K1, K3
//   and K4a (S = the wrapper's chunk, at most 128, one thread per pixel, the
//   chunk's records staged in shared memory) give each block one contiguous
//   range of ceil(total / blocks) items, so a block walks consecutive chunks
//   of consecutive rows and sums a row's chunks in registers in slot order.
//   A row inside one block's range is written out by that block; a row that
//   straddles blocks leaves one partial per block (at most two a block: its
//   first and its last row), and a merge pass combines them in block order,
//   which is chunk order: mass summed in that order, (zmin, slot) replaced
//   only on a strict <, so the first slot still wins a tie and the hard
//   outputs equal the plain version's.  The merge pass also writes the rows
//   of count 0 (mass 0, zmin 3e38, slot 0).  Partials take 2 x blocks x 256
//   x 12 bytes whatever the batch.
// - K2 and K4b (S = 32): an item is one lane per slot and the block's eight
//   warps take stripes of the tile's pixels; each thread sums its six xy
//   gradients over its stripe in pixel order, then the warps' sums per slot
//   are added in warp order through shared memory (no atomics), and the
//   tile's cotangents are staged in shared memory per item.  Blocks stride
//   over the items; the output is zeroed first, so slots >= count read 0.
// So the most loaded tile is spread over as many SMs as it has chunks, and
// the card stays full until the total work is done.
//
// The face-only terms (area, its reciprocal and guards, the edge vectors,
// the three segment denominators, visibility) are computed once per slot
// when its record is staged, not once per pixel, with the same expressions,
// so every value rounds as it did.
//
// K3 runs on the same work list with the same body (one template,
// tile_fwd<kMass, kDepth, kIndexed>): the depth and its slot without the
// mass, about twenty operations per pair (the barycentrics and the inside
// test; the depth and its test only where the pixel is inside the face),
// so per pair it is the cheapest of the four and the imbalance of the counts
// (a prescreen chunk's heaviest tile holds 28x the mean) set its time when
// it ran one block per (view, tile).  It reads no packed rows: a slot's
// record is rows_all[b, indices[b, t, j]] (the per-face records and the
// bins' face ids), read when the slot is staged, so no (B, T, M, 16) copy of
// the records exists on its path.  bin_faces keeps each tile's faces as a
// prefix of its row, so the count alone masks the padding.  Its partials
// (depth, slot) merge as K1's do, in chunk order with a strict <.  The TPU
// version's 8 tiles per program and 512-slot chunks with a clamped
// overlapping last chunk were VMEM blocking.  The view axis is part of the
// rows, so one launch renders a whole chunk of prior views.
//
// K4a is K1 without the depth: the same code (one template,
// mass_fwd_kernel<kDepth>), 81 of K1's 90 operations per pair and 4 of its
// 12 output bytes per pixel.  The TPU version's 8 tiles per program and
// 128-face chunks over the padded cap were VMEM blocking and do not come
// across.  It reads K1's 16-float records, whose depth words it skips.
//
// Numerics.  All work in f32 and are built with -fmad=false: every product
// is rounded before the following add, as in the plain PyTorch version, so
// the hard decisions (the inside test, the depth argmin, the winning
// segment) agree with it; ties keep the first slot (strict <).  The four
// a * b + c forms of seg() are explicit fmaf calls, on both sides: XLA fuses
// them when it compiles the reference, and near a corner the winning
// segment, which decides which vertices get a pixel's gradient, follows
// that rounding.  Sums (the mass, the xy gradients) run in another order
// than the plain version's; on one device two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 16;     // floats per slot record
constexpr float kBigZ = 3.0e38f;
constexpr int kStage = 128;  // K1/K3/K4a: the most slots of a work item
constexpr int kLanes = 32;   // K2/K4b: slots of a work item, one a lane
constexpr int kWarps = 8;    // K2/K4b: warps of a block, a stripe of pixels each
constexpr int kScan = 1024;  // threads of the work list's pre-pass

struct Seg {
  float t, dx, dy, d2;
};

// The face-only terms of a slot, computed once when its record is staged,
// in the order of operations of ops/raster_fused.py:_barycentric and _seg.
// Edge e_ab = b - a of the segments 01, 12, 20; the same vectors are the
// barycentrics' edges.  visible: vis > 0.5 and |area| > 1e-12, the only
// faces K1 and K2 evaluate (so their inside test needs no area guard).
struct __align__(16) Face {
  float x0, y0, x1, y1, x2, y2;
  float e01x, e01y, e12x, e12y, e20x, e20y;
  float inv_area;
  float den01, den12, den20;  // fmaxf(|e|^2, 1e-12)
  float z0, z1, z2;
  float visible;  // 1 or 0
};

__device__ __forceinline__ Face make_face(const float* __restrict__ rec) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
  const float4 a = r4[0], b = r4[1], c = r4[2];
  Face f;
  f.x0 = a.x;
  f.y0 = a.y;
  f.x1 = a.z;
  f.y1 = a.w;
  f.x2 = b.x;
  f.y2 = b.y;
  const float area = (f.x1 - f.x0) * (f.y2 - f.y0) - (f.y1 - f.y0) * (f.x2 - f.x0);
  const bool degen = fabsf(area) < 1e-12f;
  f.inv_area = degen ? 0.0f : 1.0f / area;
  f.visible = (b.z > 0.5f) && (fabsf(area) > 1e-12f) ? 1.0f : 0.0f;
  f.e01x = f.x1 - f.x0;
  f.e01y = f.y1 - f.y0;
  f.e12x = f.x2 - f.x1;
  f.e12y = f.y2 - f.y1;
  f.e20x = f.x0 - f.x2;
  f.e20y = f.y0 - f.y2;
  f.den01 = fmaxf(fmaf(f.e01x, f.e01x, f.e01y * f.e01y), 1e-12f);
  f.den12 = fmaxf(fmaf(f.e12x, f.e12x, f.e12y * f.e12y), 1e-12f);
  f.den20 = fmaxf(fmaf(f.e20x, f.e20x, f.e20y * f.e20y), 1e-12f);
  f.z0 = c.x;
  f.z1 = c.y;
  f.z2 = c.z;
  return f;
}

// Clipped projection t, offset and squared distance from the pixel (offset
// ap from the segment's start a) to segment (a, a + ab); den is the
// segment's fmaxf(|ab|^2, 1e-12).  The four a * b + c forms are fused, as
// ops/raster_fused._seg fuses them.
__device__ __forceinline__ Seg seg(float abx, float aby, float den, float apx, float apy) {
  float t = fmaf(apx, abx, apy * aby) / den;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float dx = fmaf(-t, abx, apx), dy = fmaf(-t, aby, apy);
  return {t, dx, dy, fmaf(dx, dx, dy * dy)};
}

// Per (pixel, visible slot) barycentrics and inside test of K1, K2 and K3,
// in the plain version's order of operations (ops/raster_fused.py:
// _barycentric); a visible face's area is no degenerate one, so inv_area is
// 1 / area there and the inside test needs no area guard.
struct Bary {
  float w0, w1, w2;
  bool inside;
};

__device__ __forceinline__ Bary barycentric(const Face& f, float a0x, float a0y, float a1x,
                                            float a1y, float a2x, float a2y) {
  Bary b;
  b.w0 = (f.e12x * a1y - f.e12y * a1x) * f.inv_area;
  b.w1 = (f.e20x * a2y - f.e20y * a2x) * f.inv_area;
  b.w2 = (f.e01x * a0y - f.e01y * a0x) * f.inv_area;
  b.inside = (b.w0 >= 0.0f) && (b.w1 >= 0.0f) && (b.w2 >= 0.0f);
  return b;
}

// Per (pixel, visible slot) geometry of K1 and K2, in the plain version's
// order of operations (ops/raster_fused.py:_pair_geometry).
struct Pair {
  float w0, w1, w2;
  bool inside;
  float sign;
  Seg s01, s12, s20;
  float d2;
};

__device__ __forceinline__ Pair pair_geometry(const Face& f, float px, float py) {
  const float a0x = px - f.x0, a0y = py - f.y0;
  const float a1x = px - f.x1, a1y = py - f.y1;
  const float a2x = px - f.x2, a2y = py - f.y2;
  const Bary w = barycentric(f, a0x, a0y, a1x, a1y, a2x, a2y);
  Pair q;
  q.w0 = w.w0;
  q.w1 = w.w1;
  q.w2 = w.w2;
  q.inside = w.inside;
  q.sign = q.inside ? 1.0f : -1.0f;
  q.s01 = seg(f.e01x, f.e01y, f.den01, a0x, a0y);
  q.s12 = seg(f.e12x, f.e12y, f.den12, a1x, a1y);
  q.s20 = seg(f.e20x, f.e20y, f.den20, a2x, a2y);
  q.d2 = fminf(q.s01.d2, fminf(q.s12.d2, q.s20.d2));
  return q;
}

__device__ __forceinline__ int chunks_of(int count, int m, int chunk) {
  return (max(0, min(count, m)) + chunk - 1) / chunk;
}

// The work list's pre-pass, one block: start[r] = the first item of row r,
// start[n_rows] = the number of items.  Each thread sums a run of rows, a
// block scan gives the runs' offsets, and each thread writes its run.
__global__ void __launch_bounds__(kScan) chunk_prefix_kernel(const int* __restrict__ counts,
                                                             int* __restrict__ start, int n_rows,
                                                             int m, int chunk) {
  __shared__ int s_warp[kScan / 32];
  const int per = (n_rows + kScan - 1) / kScan;
  const int r0 = min(n_rows, static_cast<int>(threadIdx.x) * per);
  const int r1 = min(n_rows, r0 + per);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += chunks_of(counts[r], m, chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int r = r0; r < r1; ++r) {
    start[r] = run;
    run += chunks_of(counts[r], m, chunk);
  }
  if (threadIdx.x == kScan - 1) start[n_rows] = run;
}

// The row that holds work item `item` (< start[n_rows]): the last r with
// start[r] <= item, which is never a row of count 0.
__device__ __forceinline__ int row_of_item(const int* __restrict__ start, int n_rows, int item) {
  int lo = 0, hi = n_rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= item) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int items_per_block(int total, int blocks) {
  return max(1, (total + blocks - 1) / blocks);
}

// K1 (kMass, kDepth), K4a (kMass) and K3 (kDepth, kIndexed): one thread per
// pixel of the tile; block g takes items [g * per, (g + 1) * per).  A row
// done whole goes to the outputs; the share of a row that straddles blocks
// goes to partial slot 2 g (the block's first row) or 2 g + 1 (its last).
// kIndexed: slot j of row r reads rows[(r / t_rows) * n_faces + indices[r *
// m + j]] (K3's per-face records); otherwise rows[r * m + j].
template <bool kMass, bool kDepth, bool kIndexed>
__device__ __forceinline__ void tile_fwd(const float* __restrict__ rows,
                                         const int* __restrict__ indices,
                                         const int* __restrict__ counts,
                                         const int* __restrict__ start, float* __restrict__ mass_out,
                                         float* __restrict__ zmin_out, int* __restrict__ jbest_out,
                                         float* __restrict__ part_mass, float* __restrict__ part_zmin,
                                         int* __restrict__ part_jbest, int n_rows, int t_rows, int m,
                                         int n_faces, int chunk, int tile, int tiles_w, float sigma,
                                         float znear) {
  __shared__ Face s_face[kStage];
  const int total = start[n_rows];
  const int per = items_per_block(total, gridDim.x);
  const int i0 = blockIdx.x * per, i1 = min(total, i0 + per);
  const int p = threadIdx.x, n_pix = blockDim.x;
  int i = i0;
  int r = i < i1 ? row_of_item(start, n_rows, i) : 0;
  for (; i < i1; ++r) {
    while (start[r + 1] <= i) ++r;  // rows of count 0 hold no item
    const int first = start[r], end = start[r + 1];
    const int count = min(counts[r], m);
    const int t = r % t_rows;
    const float px = (static_cast<float>(p % tile) + 0.5f) +
                     static_cast<float>((t % tiles_w) * tile);
    const float py = (static_cast<float>(p / tile) + 0.5f) +
                     static_cast<float>((t / tiles_w) * tile);
    float mass = 0.0f, zmin = kBigZ;
    int jbest = 0;
    for (const int stop = min(end, i1); i < stop; ++i) {
      const int base = (i - first) * chunk;
      const int n = min(chunk, count - base);
      __syncthreads();  // the previous chunk is fully consumed
      for (int s = threadIdx.x; s < n; s += blockDim.x) {
        const size_t slot = static_cast<size_t>(r) * m + base + s;
        const size_t rec = kIndexed ? static_cast<size_t>(r / t_rows) * n_faces + indices[slot]
                                    : slot;
        s_face[s] = make_face(rows + rec * kRow);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const Face f = s_face[j];
        if (f.visible == 0.0f) continue;  // adds no mass and no hit
        if constexpr (kMass) {
          const Pair q = pair_geometry(f, px, py);
          const float logit = q.sign * sqrtf(fmaxf(q.d2, 1e-12f)) / sigma;
          mass += fmaxf(logit, 0.0f) + log1pf(expf(-fabsf(logit)));
          if constexpr (kDepth) {
            const float z = q.w0 * f.z0 + q.w1 * f.z1 + q.w2 * f.z2;
            if (q.inside && z > znear && z < zmin) {
              zmin = z;
              jbest = base + j;
            }
          }
        } else {
          const Bary w = barycentric(f, px - f.x0, py - f.y0, px - f.x1, py - f.y1, px - f.x2,
                                     py - f.y2);
          if (!w.inside) continue;
          const float z = w.w0 * f.z0 + w.w1 * f.z1 + w.w2 * f.z2;
          if (z > znear && z < zmin) {
            zmin = z;
            jbest = base + j;
          }
        }
      }
    }
    size_t o;
    float *mo, *zo;
    int* jo;
    if (first >= i0 && end <= i1) {  // the whole row is this block's
      o = static_cast<size_t>(r) * n_pix + p;
      mo = mass_out, zo = zmin_out, jo = jbest_out;
    } else {
      o = (2 * static_cast<size_t>(blockIdx.x) + (first <= i0 ? 0 : 1)) * n_pix + p;
      mo = part_mass, zo = part_zmin, jo = part_jbest;
    }
    if constexpr (kMass) mo[o] = mass;
    if constexpr (kDepth) {
      zo[o] = zmin;
      jo[o] = jbest;
    }
  }
}

template <bool kDepth>
__global__ void mass_fwd_kernel(const float* __restrict__ rows, const int* __restrict__ counts,
                                const int* __restrict__ start, float* __restrict__ mass_out,
                                float* __restrict__ zmin_out, int* __restrict__ jbest_out,
                                float* __restrict__ part_mass, float* __restrict__ part_zmin,
                                int* __restrict__ part_jbest, int n_rows, int t_rows, int m,
                                int chunk, int tile, int tiles_w, float sigma, float znear) {
  tile_fwd<true, kDepth, false>(rows, nullptr, counts, start, mass_out, zmin_out, jbest_out,
                                part_mass, part_zmin, part_jbest, n_rows, t_rows, m, 0, chunk,
                                tile, tiles_w, sigma, znear);
}

// K3: forward-only hard raster of the prior views, per pixel the min depth
// over covering visible faces with z > znear and its slot (strict <: the
// first slot wins), no silhouette math.
__global__ void depth_fwd_kernel(const float* __restrict__ rows_all,
                                 const int* __restrict__ indices, const int* __restrict__ counts,
                                 const int* __restrict__ start, float* __restrict__ zmin_out,
                                 int* __restrict__ jbest_out, float* __restrict__ part_zmin,
                                 int* __restrict__ part_jbest, int n_rows, int t_rows, int m,
                                 int n_faces, int chunk, int tile, int tiles_w, float znear) {
  tile_fwd<false, true, true>(rows_all, indices, counts, start, nullptr, zmin_out, jbest_out,
                              nullptr, part_zmin, part_jbest, n_rows, t_rows, m, n_faces, chunk,
                              tile, tiles_w, 0.0f, znear);
}

// The merge pass of K1, K3 and K4a: rows of count 0 get mass 0, zmin 3e38,
// slot 0; a row that straddled blocks g0..g1 sums their partials in that
// order and keeps the first strictly smaller depth.  `blocks` is the
// forward's grid.
template <bool kMass, bool kDepth>
__device__ __forceinline__ void tile_merge(const int* __restrict__ start,
                                           float* __restrict__ mass_out,
                                           float* __restrict__ zmin_out,
                                           int* __restrict__ jbest_out,
                                           const float* __restrict__ part_mass,
                                           const float* __restrict__ part_zmin,
                                           const int* __restrict__ part_jbest, int n_rows,
                                           int blocks) {
  const int per = items_per_block(start[n_rows], blocks);
  const int p = threadIdx.x, n_pix = blockDim.x;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int first = start[r], end = start[r + 1];
    const int g0 = first / per, g1 = (end - 1) / per;
    if (first < end && g0 == g1) continue;  // written whole by block g0
    float mass = 0.0f, zmin = kBigZ;
    int jbest = 0;
    if (first < end) {
      for (int g = g0; g <= g1; ++g) {
        const size_t s = (2 * static_cast<size_t>(g) + (g == g0 && first != g * per ? 1 : 0)) *
                             n_pix + p;
        if constexpr (kMass) mass += part_mass[s];
        if constexpr (kDepth) {
          if (part_zmin[s] < zmin) {
            zmin = part_zmin[s];
            jbest = part_jbest[s];
          }
        }
      }
    }
    const size_t o = static_cast<size_t>(r) * n_pix + p;
    if constexpr (kMass) mass_out[o] = mass;
    if constexpr (kDepth) {
      zmin_out[o] = zmin;
      jbest_out[o] = jbest;
    }
  }
}

template <bool kDepth>
__global__ void mass_merge_kernel(const int* __restrict__ start, float* __restrict__ mass_out,
                                  float* __restrict__ zmin_out, int* __restrict__ jbest_out,
                                  const float* __restrict__ part_mass,
                                  const float* __restrict__ part_zmin,
                                  const int* __restrict__ part_jbest, int n_rows, int blocks) {
  tile_merge<true, kDepth>(start, mass_out, zmin_out, jbest_out, part_mass, part_zmin, part_jbest,
                           n_rows, blocks);
}

__global__ void depth_merge_kernel(const int* __restrict__ start, float* __restrict__ zmin_out,
                                   int* __restrict__ jbest_out,
                                   const float* __restrict__ part_zmin,
                                   const int* __restrict__ part_jbest, int n_rows, int blocks) {
  tile_merge<false, true>(start, nullptr, zmin_out, jbest_out, nullptr, part_zmin, part_jbest,
                          n_rows, blocks);
}

// K2 (and K4b): blocks stride over items of 32 slots; lane l takes slot
// base + l, warp w the w-th stripe of the tile's pixels.
__global__ void __launch_bounds__(kLanes* kWarps) sil_bwd_kernel(
    const float* __restrict__ rows, const int* __restrict__ counts, const int* __restrict__ start,
    const float* __restrict__ g, float* __restrict__ dxy, int n_rows, int t_rows, int m,
    int tile, int tiles_w, float sigma) {
  __shared__ float s_g[1024];
  __shared__ Face s_face[kLanes];
  __shared__ float s_part[kWarps][6][kLanes];
  const int total = start[n_rows];
  const int n_pix = tile * tile;
  const int stripe = (n_pix + kWarps - 1) / kWarps;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int r = row_of_item(start, n_rows, item);
    const int base = (item - start[r]) * kLanes;
    const int n = min(kLanes, min(counts[r], m) - base);
    const int t = r % t_rows;
    const float ox = static_cast<float>((t % tiles_w) * tile);
    const float oy = static_cast<float>((t / tiles_w) * tile);
    __syncthreads();  // the previous item's shared values are consumed
    for (int i = threadIdx.x; i < n_pix; i += blockDim.x)
      s_g[i] = g[static_cast<size_t>(r) * n_pix + i];
    if (static_cast<int>(threadIdx.x) < n)
      s_face[threadIdx.x] = make_face(rows + (static_cast<size_t>(r) * m + base + threadIdx.x) * kRow);
    __syncthreads();
    float gx0 = 0.0f, gy0 = 0.0f, gx1 = 0.0f, gy1 = 0.0f, gx2 = 0.0f, gy2 = 0.0f;
    if (lane < n) {
      const Face f = s_face[lane];
      const int p1 = min(n_pix, (warp + 1) * stripe);
      for (int p = warp * stripe; f.visible != 0.0f && p < p1; ++p) {
        const float px = (static_cast<float>(p % tile) + 0.5f) + ox;
        const float py = (static_cast<float>(p / tile) + 0.5f) + oy;
        const Pair q = pair_geometry(f, px, py);
        const float d2s = fmaxf(q.d2, 1e-12f);
        const float logit = q.sign * sqrtf(d2s) / sigma;
        const float dfac = q.d2 > 1e-12f ? 0.5f / (sigma * sqrtf(d2s)) : 0.0f;
        const float sig = 1.0f / (1.0f + expf(-logit));
        const float c = s_g[p] * sig * q.sign * dfac;
        // Envelope theorem on the winning segment (a, b), priority
        // 01 > 12 > 20: dd2/da = 2(t-1)(dx, dy), dd2/db = -2t(dx, dy).
        if (q.s01.d2 <= q.d2) {
          const Seg& s = q.s01;
          gx0 += c * 2.0f * (s.t - 1.0f) * s.dx;
          gy0 += c * 2.0f * (s.t - 1.0f) * s.dy;
          gx1 += c * -2.0f * s.t * s.dx;
          gy1 += c * -2.0f * s.t * s.dy;
        } else if (q.s12.d2 <= q.d2) {
          const Seg& s = q.s12;
          gx1 += c * 2.0f * (s.t - 1.0f) * s.dx;
          gy1 += c * 2.0f * (s.t - 1.0f) * s.dy;
          gx2 += c * -2.0f * s.t * s.dx;
          gy2 += c * -2.0f * s.t * s.dy;
        } else {
          const Seg& s = q.s20;
          gx2 += c * 2.0f * (s.t - 1.0f) * s.dx;
          gy2 += c * 2.0f * (s.t - 1.0f) * s.dy;
          gx0 += c * -2.0f * s.t * s.dx;
          gy0 += c * -2.0f * s.t * s.dy;
        }
      }
    }
    s_part[warp][0][lane] = gx0;
    s_part[warp][1][lane] = gy0;
    s_part[warp][2][lane] = gx1;
    s_part[warp][3][lane] = gy1;
    s_part[warp][4][lane] = gx2;
    s_part[warp][5][lane] = gy2;
    __syncthreads();
    for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) {
      const int l = e / 6, k = e % 6;
      float sum = 0.0f;
      for (int w = 0; w < kWarps; ++w) sum += s_part[w][k][l];
      dxy[(static_cast<size_t>(r) * m + base + l) * 6 + k] = sum;
    }
  }
}

// Blocks of `threads` threads that the current device holds at once, over
// all its SMs (cached per kernel, block size and device).
int resident_blocks(const void* fn, int threads, int* out) {
  struct Entry {
    const void* fn;
    int threads, device, blocks;
  };
  static Entry cache[32];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].threads == threads && cache[i].device == dev) {
      *out = cache[i].blocks;
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = per_sm * sms;
  if (used < 32) cache[used++] = {fn, threads, dev, *out};
  return 0;
}

// K1 and K4a: the pre-pass, the persistent forward and the merge pass.
// parts holds (kDepth ? 3 : 1) arrays of 2 x part_blocks x tile^2 values;
// the grid is the smaller of the resident blocks and part_blocks.
template <bool kDepth>
int mass_launch(const void* rows, const void* counts, void* mass, void* zmin, void* jbest,
                void* start, void* parts, int part_blocks, int n_rows, int t_rows, int m,
                int chunk, int tile, int tiles_w, float sigma, float znear, void* stream) {
  if (chunk < 1 || chunk > kStage || part_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = tile * tile;
  chunk_prefix_kernel<<<1, kScan, 0, s>>>(static_cast<const int*>(counts), static_cast<int*>(start),
                                           n_rows, m, chunk);
  int blocks = 0;
  const int err = resident_blocks((const void*)mass_fwd_kernel<kDepth>, n_pix, &blocks);
  if (err) return err;
  blocks = min(blocks, part_blocks);
  const size_t span = 2 * static_cast<size_t>(part_blocks) * n_pix;
  float* pm = static_cast<float*>(parts);
  float* pz = kDepth ? pm + span : nullptr;
  int* pj = kDepth ? reinterpret_cast<int*>(pm + 2 * span) : nullptr;
  mass_fwd_kernel<kDepth><<<blocks, n_pix, 0, s>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<const int*>(start), static_cast<float*>(mass), static_cast<float*>(zmin),
      static_cast<int*>(jbest), pm, pz, pj, n_rows, t_rows, m, chunk, tile, tiles_w, sigma, znear);
  mass_merge_kernel<kDepth><<<min(n_rows, 4 * blocks), n_pix, 0, s>>>(
      static_cast<const int*>(start), static_cast<float*>(mass), static_cast<float*>(zmin),
      static_cast<int*>(jbest), pm, pz, pj, n_rows, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 launch: three kernels on the stream.  start: (n_rows + 1,) i32 and
// parts: 3 x 2 x part_blocks x tile^2 f32 of scratch.  Returns
// cudaGetLastError() after the launches (0 = launched).
int dynhor_fused_fwd(const void* rows, const void* counts, void* mass, void* zmin, void* jbest,
                     void* start, void* parts, int part_blocks, int n_rows, int t_rows, int m,
                     int chunk, int tile, int tiles_w, float sigma, float znear, void* stream) {
  return mass_launch<true>(rows, counts, mass, zmin, jbest, start, parts, part_blocks, n_rows,
                           t_rows, m, chunk, tile, tiles_w, sigma, znear, stream);
}

// K4a launch: K1's without the depth; parts: 2 x part_blocks x tile^2 f32.
int dynhor_sil_mass_fwd(const void* rows, const void* counts, void* mass, void* start, void* parts,
                        int part_blocks, int n_rows, int t_rows, int m, int chunk, int tile,
                        int tiles_w, float sigma, void* stream) {
  return mass_launch<false>(rows, counts, mass, nullptr, nullptr, start, parts, part_blocks,
                            n_rows, t_rows, m, chunk, tile, tiles_w, sigma, 0.0f, stream);
}

// K2 launch, and K4b's (the same function on K4a's rows): zero dxy, the
// pre-pass into start ((n_rows + 1,) i32 of scratch), then the items.
// Returns cudaGetLastError() after the launches (0 = launched).
int dynhor_sil_bwd(const void* rows, const void* counts, const void* g, void* dxy, void* start,
                   int n_rows, int t_rows, int m, int tile, int tiles_w, float sigma,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(dxy, 0, static_cast<size_t>(n_rows) * m * 6 * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_prefix_kernel<<<1, kScan, 0, s>>>(static_cast<const int*>(counts), static_cast<int*>(start),
                                           n_rows, m, kLanes);
  int blocks = 0;
  const int err = resident_blocks((const void*)sil_bwd_kernel, kLanes * kWarps,
                                  &blocks);
  if (err) return err;
  sil_bwd_kernel<<<blocks, kLanes * kWarps, 0, s>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<const int*>(start), static_cast<const float*>(g), static_cast<float*>(dxy),
      n_rows, t_rows, m, tile, tiles_w, sigma);
  return static_cast<int>(cudaGetLastError());
}

// K3 launch: the pre-pass, the persistent forward and the merge pass.
// start: (n_rows + 1,) i32 and parts: 2 x 2 x part_blocks x tile^2 f32 of
// scratch.  Returns cudaGetLastError() after the launches (0 = launched).
int dynhor_depth_fwd(const void* rows_all, const void* indices, const void* counts, void* zmin,
                     void* jbest, void* start, void* parts, int part_blocks, int n_rows,
                     int t_rows, int m, int n_faces, int chunk, int tile, int tiles_w, float znear,
                     void* stream) {
  if (chunk < 1 || chunk > kStage || part_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = tile * tile;
  chunk_prefix_kernel<<<1, kScan, 0, s>>>(static_cast<const int*>(counts), static_cast<int*>(start),
                                           n_rows, m, chunk);
  int blocks = 0;
  const int err = resident_blocks((const void*)depth_fwd_kernel, n_pix, &blocks);
  if (err) return err;
  blocks = min(blocks, part_blocks);
  const size_t span = 2 * static_cast<size_t>(part_blocks) * n_pix;
  float* pz = static_cast<float*>(parts);
  int* pj = reinterpret_cast<int*>(pz + span);
  depth_fwd_kernel<<<blocks, n_pix, 0, s>>>(
      static_cast<const float*>(rows_all), static_cast<const int*>(indices),
      static_cast<const int*>(counts), static_cast<const int*>(start), static_cast<float*>(zmin),
      static_cast<int*>(jbest), pz, pj, n_rows, t_rows, m, n_faces, chunk, tile, tiles_w, znear);
  depth_merge_kernel<<<min(n_rows, 4 * blocks), n_pix, 0, s>>>(
      static_cast<const int*>(start), static_cast<float*>(zmin), static_cast<int*>(jbest), pz, pj,
      n_rows, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
