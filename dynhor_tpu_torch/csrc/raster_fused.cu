// Tile raster kernels for sm_90a: the fused forward (K1), its silhouette
// backward (K2), the depth-only hard raster of the prior views (K3) and the
// mass-only forward of the separate soft silhouette (K4a).
//
// K1 replaces dynhor_tpu/ops/raster_pallas.py:_fused_fwd_kernel, K2 replaces
// dynhor_tpu/ops/raster_pallas.py:_sil_bwd_kernel, K3 replaces
// dynhor_tpu/ops/raster_pallas.py:_depth_fwd_kernel, K4a replaces
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
// Layout.  rows: (n_blocks = frames x tile rows, m slots, 16) f32 records
//   [x0 y0 x1 y1 x2 y2 vis pad | z0 z1 z2 pad x5]; counts: (n_blocks,) i32 —
//   slots [0, count) hold the tile's candidate faces in ascending face id,
//   padding slots have vis = 0.  A tile row t's pixel origin is
//   ((t % tiles_w) * tile, (t / tiles_w) * tile) (the packing shifts the xy
//   values of compacted tiles into that frame).
//
// What bounds them.  Both do about a hundred floating-point operations per
// (pixel, slot) pair and read each slot's 64-byte record once per block, so
// they are bound by operations, not bytes: the least time is sum(counts) x
// 256 pixels x the per-pair count over the card's peak rate.  The TPU
// version streamed a 512-slot (pixels x slots) block through VMEM; here one
// thread owns one pixel (K1) or one slot (K2) and keeps its sums in
// registers, the block stages the shared operand (K1: 128 slot records,
// 8 KB; K2: the tile's 256 cotangents) in shared memory, and every loop
// stops at the tile's true count, so work scales with the scene's load and
// not with the counted cap.  The frame axis is part of the grid: one launch
// covers every frame of a step.  K2 needs no atomics and is deterministic.
//
// K4a is K1 without the depth: the same loop, staging and stop at the count
// (one template, mass_fwd_kernel<kDepth>), 81 of K1's 90 operations per pair
// and 4 of its 12 output bytes per pixel, so operations bound it as they
// bound K1.  The TPU version's 8 tiles per program and 128-face chunks over
// the padded cap were VMEM blocking and do not come across.  It reads K1's
// 16-float records, whose depth words it skips.
//
// K3 does a quarter of K1's work per pair (about twenty operations: the
// barycentrics and the inside test; the depth and its test only where the
// pixel is inside the face) and still reads a 64-byte record per slot and
// writes 8 bytes per pixel, so operations bound it too, and it runs K1's
// layout and loop without the mass.  The TPU
// version's 8 tiles per program and 512-slot chunks with a clamped
// overlapping last chunk were VMEM blocking; here one block per (view,
// tile) loops over exactly the tile's count.  The view axis is part of the
// grid, so one launch renders a whole chunk of prior views.
//
// Numerics.  Both work in f32 and are built with -fmad=false: every product
// is rounded before the following add, as in the plain PyTorch version, so
// the hard decisions (the inside test, the depth argmin, the winning
// segment) agree with it; ties keep the first slot (strict <).  The four
// a * b + c forms of seg() are explicit fmaf calls, on both sides: XLA fuses
// them when it compiles the reference, and near a corner the winning
// segment, which decides which vertices get a pixel's gradient, follows
// that rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;  // K1: slot records staged per pass
constexpr int kRow = 16;     // floats per slot record
constexpr float kBigZ = 3.0e38f;

struct Seg {
  float t, dx, dy, d2;
};

__device__ __forceinline__ Seg seg(float ax, float ay, float bx, float by,
                                   float px, float py) {
  const float abx = bx - ax, aby = by - ay;
  const float apx = px - ax, apy = py - ay;
  const float denom = fmaf(abx, abx, aby * aby);
  float t = fmaf(apx, abx, apy * aby) / fmaxf(denom, 1e-12f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float dx = fmaf(-t, abx, apx), dy = fmaf(-t, aby, apy);
  return {t, dx, dy, fmaf(dx, dx, dy * dy)};
}

// Per (pixel, slot) barycentrics and inside test, shared by all three
// kernels, in the plain versions' order of operations
// (ops/raster_fused.py:_barycentric).
struct Bary {
  float w0, w1, w2;
  bool inside, nondegen;
};

__device__ __forceinline__ Bary barycentric(const float* r, float px, float py) {
  const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
  Bary b;
  const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
  const bool degen = fabsf(area) < 1e-12f;
  const float inv_area = degen ? 0.0f : 1.0f / area;
  b.w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area;
  b.w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area;
  b.w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area;
  b.nondegen = fabsf(area) > 1e-12f;
  b.inside = (b.w0 >= 0.0f) && (b.w1 >= 0.0f) && (b.w2 >= 0.0f) && b.nondegen;
  return b;
}

// Per (pixel, slot) geometry of K1 and K2, in the plain version's order of
// operations (ops/raster_fused.py:_pair_geometry).
struct Pair {
  float w0, w1, w2;
  bool inside, visible;
  float sign;
  Seg s01, s12, s20;
  float d2;
};

__device__ __forceinline__ Pair pair_geometry(const float* r, float px, float py) {
  const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
  const Bary b = barycentric(r, px, py);
  Pair q;
  q.w0 = b.w0;
  q.w1 = b.w1;
  q.w2 = b.w2;
  q.inside = b.inside;
  q.sign = q.inside ? 1.0f : -1.0f;
  q.s01 = seg(x0, y0, x1, y1, px, py);
  q.s12 = seg(x1, y1, x2, y2, px, py);
  q.s20 = seg(x2, y2, x0, y0, px, py);
  q.d2 = fminf(q.s01.d2, fminf(q.s12.d2, q.s20.d2));
  q.visible = (r[6] > 0.5f) && b.nondegen;
  return q;
}

// K1 (kDepth) and K4a (!kDepth): one block per (frame, tile row), one thread
// per pixel of the tile.  K4a writes neither zmin_out nor jbest_out.
template <bool kDepth>
__global__ void mass_fwd_kernel(const float* __restrict__ rows,
                                const int* __restrict__ counts,
                                float* __restrict__ mass_out,
                                float* __restrict__ zmin_out,
                                int* __restrict__ jbest_out, int t_rows, int m,
                                int tile, int tiles_w, float sigma, float znear) {
  __shared__ float4 s_rows[kChunk * kRow / 4];
  const int bt = blockIdx.x;
  const int t = bt % t_rows;
  const int p = threadIdx.x;
  const float px = (static_cast<float>(p % tile) + 0.5f) +
                   static_cast<float>((t % tiles_w) * tile);
  const float py = (static_cast<float>(p / tile) + 0.5f) +
                   static_cast<float>((t / tiles_w) * tile);
  const int count = counts[bt];
  const float4* src = reinterpret_cast<const float4*>(rows + static_cast<size_t>(bt) * m * kRow);
  float mass = 0.0f, zmin = kBigZ;
  int jbest = 0;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n * (kRow / 4); i += blockDim.x)
      s_rows[i] = src[base * (kRow / 4) + i];
    __syncthreads();
    const float* r = reinterpret_cast<const float*>(s_rows);
    for (int j = 0; j < n; ++j, r += kRow) {
      const Pair q = pair_geometry(r, px, py);
      if (!q.visible) continue;  // adds no mass and no hit
      const float logit = q.sign * sqrtf(fmaxf(q.d2, 1e-12f)) / sigma;
      mass += fmaxf(logit, 0.0f) + log1pf(expf(-fabsf(logit)));
      if constexpr (kDepth) {
        const float z = q.w0 * r[8] + q.w1 * r[9] + q.w2 * r[10];
        if (q.inside && z > znear && z < zmin) {
          zmin = z;
          jbest = base + j;
        }
      }
    }
  }
  const size_t o = static_cast<size_t>(bt) * blockDim.x + p;
  mass_out[o] = mass;
  if constexpr (kDepth) {
    zmin_out[o] = zmin;
    jbest_out[o] = jbest;
  }
}

// K2: one block per (frame, tile row); thread i owns slots i, i + blockDim,
// ... and sums its six xy gradients over the tile's pixels in pixel order.
__global__ void sil_bwd_kernel(const float* __restrict__ rows,
                               const int* __restrict__ counts,
                               const float* __restrict__ g,
                               float* __restrict__ dxy, int t_rows, int m,
                               int tile, int tiles_w, float sigma) {
  extern __shared__ float s_g[];
  const int bt = blockIdx.x;
  const int t = bt % t_rows;
  const int n_pix = tile * tile;
  for (int i = threadIdx.x; i < n_pix; i += blockDim.x)
    s_g[i] = g[static_cast<size_t>(bt) * n_pix + i];
  __syncthreads();
  const int count = counts[bt];
  const float ox = static_cast<float>((t % tiles_w) * tile);
  const float oy = static_cast<float>((t / tiles_w) * tile);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float gx0 = 0.0f, gy0 = 0.0f, gx1 = 0.0f, gy1 = 0.0f, gx2 = 0.0f, gy2 = 0.0f;
    if (j < count) {
      const float4* rec = reinterpret_cast<const float4*>(
          rows + (static_cast<size_t>(bt) * m + j) * kRow);
      const float4 a = rec[0], b = rec[1];
      const float r[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      for (int p = 0; p < n_pix; ++p) {
        const float px = (static_cast<float>(p % tile) + 0.5f) + ox;
        const float py = (static_cast<float>(p / tile) + 0.5f) + oy;
        const Pair q = pair_geometry(r, px, py);
        if (!q.visible) continue;  // coef is 0
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
    float* out = dxy + (static_cast<size_t>(bt) * m + j) * 6;
    out[0] = gx0;
    out[1] = gy0;
    out[2] = gx1;
    out[3] = gy1;
    out[4] = gx2;
    out[5] = gy2;
  }
}

// K3: forward-only hard raster of the prior views.  One block per (view,
// tile), one thread per pixel, slot records staged 128 at a time as in K1;
// per pixel the min depth over covering visible faces with z > znear and
// its slot (strict <: the first slot wins), no silhouette math.
__global__ void depth_fwd_kernel(const float* __restrict__ rows,
                                 const int* __restrict__ counts,
                                 float* __restrict__ zmin_out,
                                 int* __restrict__ jbest_out, int t_rows, int m,
                                 int tile, int tiles_w, float znear) {
  __shared__ float4 s_rows[kChunk * kRow / 4];
  const int bt = blockIdx.x;
  const int t = bt % t_rows;
  const int p = threadIdx.x;
  const float px = (static_cast<float>(p % tile) + 0.5f) +
                   static_cast<float>((t % tiles_w) * tile);
  const float py = (static_cast<float>(p / tile) + 0.5f) +
                   static_cast<float>((t / tiles_w) * tile);
  const int count = counts[bt];
  const float4* src = reinterpret_cast<const float4*>(rows + static_cast<size_t>(bt) * m * kRow);
  float zmin = kBigZ;
  int jbest = 0;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < n * (kRow / 4); i += blockDim.x)
      s_rows[i] = src[base * (kRow / 4) + i];
    __syncthreads();
    const float* r = reinterpret_cast<const float*>(s_rows);
    for (int j = 0; j < n; ++j, r += kRow) {
      if (!(r[6] > 0.5f)) continue;  // padding slot, or face behind znear
      const Bary q = barycentric(r, px, py);
      if (!q.inside) continue;
      const float z = q.w0 * r[8] + q.w1 * r[9] + q.w2 * r[10];
      if (z > znear && z < zmin) {
        zmin = z;
        jbest = base + j;
      }
    }
  }
  const size_t o = static_cast<size_t>(bt) * blockDim.x + p;
  zmin_out[o] = zmin;
  jbest_out[o] = jbest;
}

}  // namespace

extern "C" {

// K1 launch.  Returns cudaGetLastError() after the launch (0 = launched).
int dynhor_fused_fwd(const void* rows, const void* counts, void* mass,
                     void* zmin, void* jbest, int n_blocks, int t_rows, int m,
                     int tile, int tiles_w, float sigma, float znear,
                     void* stream) {
  mass_fwd_kernel<true><<<n_blocks, tile * tile, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<float*>(mass), static_cast<float*>(zmin),
      static_cast<int*>(jbest), t_rows, m, tile, tiles_w, sigma, znear);
  return static_cast<int>(cudaGetLastError());
}

// K4a launch.  Returns cudaGetLastError() after the launch (0 = launched).
int dynhor_sil_mass_fwd(const void* rows, const void* counts, void* mass,
                        int n_blocks, int t_rows, int m, int tile, int tiles_w,
                        float sigma, void* stream) {
  mass_fwd_kernel<false><<<n_blocks, tile * tile, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<float*>(mass), nullptr, nullptr, t_rows, m, tile, tiles_w,
      sigma, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// K2 launch, and K4b's (the same function on K4a's rows).  Returns
// cudaGetLastError() after the launch (0 = launched).
int dynhor_sil_bwd(const void* rows, const void* counts, const void* g,
                   void* dxy, int n_blocks, int t_rows, int m, int tile,
                   int tiles_w, float sigma, void* stream) {
  const int threads = tile * tile;
  sil_bwd_kernel<<<n_blocks, threads, threads * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<const float*>(g), static_cast<float*>(dxy), t_rows, m, tile,
      tiles_w, sigma);
  return static_cast<int>(cudaGetLastError());
}

// K3 launch.  Returns cudaGetLastError() after the launch (0 = launched).
int dynhor_depth_fwd(const void* rows, const void* counts, void* zmin,
                     void* jbest, int n_blocks, int t_rows, int m, int tile,
                     int tiles_w, float znear, void* stream) {
  depth_fwd_kernel<<<n_blocks, tile * tile, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(counts),
      static_cast<float*>(zmin), static_cast<int*>(jbest), t_rows, m, tile,
      tiles_w, znear);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
