// Gather and scatter-add kernels for sm_90a: the forms that
// tools/probe_pallas_gather.py probes on the TPU (K6), as the port's probe
// (dynhor_tpu_torch/tools/probe_gather.py) runs them on the card.
//
// gather_kernel replaces the gathers of the probe's forms A-G
// (tools/probe_pallas_gather.py kern_a, kern_b, kern_c, kern_d, kern_e,
// kern_f, kern_g and the timed kern_t): out[i, l] = src[idx[i, l], l]
// (axis 0) or src[i, idx[i, l]] (axis 1), the index read through its two
// strides.  The scatter-add kernels replace form H (kern_h): dst[idx[i, l],
// l] += g[i, l].  Plain versions: dynhor_tpu_torch/ops/gather.py
// (torch.gather and scatter_add_ on the expanded index); the wrappers are
// in dynhor_tpu_torch/kernels.py.
//
// What bounds them.  Each output element costs one index load and one
// element load (or one add), with no arithmetic: bytes bound them, and at
// the probe's shapes (0.2-4 MB) the launch itself, about 2 us, exceeds the
// byte bound (0.16-0.94 us at 3.35 TB/s).  So the design spends few
// instructions per element and one launch per call:
//
// * The gather is one kernel per form, chosen by template parameters, not
//   branches: the axis; the index form (per lane, or one index per row
//   through a zero lane stride: forms A, D and the hash row gather, where
//   one thread of the row loads it and shuffles it to the others); the
//   vector width V (4, 2 or 1 floats: 16- or 8-byte stores of the output,
//   and 16- or 8-byte loads of the index, or of a row-gathered source row,
//   where its strides and alignment allow).  A 2-D grid of lane blocks x
//   row blocks replaces the old per-element 64-bit division; the row loop
//   strides by the grid, which is sized from the SM count (read once).  The
//   table is read through the read-only path (__ldg); the probe's 4 MB
//   table stays in the 50 MB L2.
// * The scatter-add has no global atomic where the shape allows:
//   - "columns" (n <= 2048 rows of g, a table of <= 4096 rows): one warp
//     owns one column, keeps it in shared memory and walks the rows in
//     order, 32 at a time, from rows its block staged in shared memory
//     (all of a stage's loads in flight at once); lanes whose rows hit the
//     same entry add one after the other in lane order.  Every entry is the
//     sum of its terms in row order, as the CPU's scatter_add_ sums them:
//     the result equals the CPU plain version bit for bit, and two runs
//     agree.  Form H runs here.
//   - "atomic" (anything else): one f32 atomicAdd per element into a
//     zeroed table, a native reduction in L2 (REDG.ADD.F32); the order of
//     the sums changes from run to run.  The hash backward's shape
//     (262,144 rows into 8192 x 2) runs here: a block-private copy of the
//     table in shared memory, summed by a second kernel, was slower on an
//     H100 (10.9 against 7.8 us a call), because an f32 atomicAdd to
//     shared memory is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN).
//
// Indices must lie in range: the kernels do not check them (jnp.take would
// fill and take_along_axis clamp).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

int sm_count() {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return 132;
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev];
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const int* p, int (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
}

// One thread per V lanes of a row; tpr threads per row (a power of two up
// to 32, so a row never straddles a warp), kThreads / tpr rows per block.
// AXIS: which axis the index selects along.  ROW: one index per row (lane
// stride 0).  V: lanes per thread.  VIN: the index (per-lane form) or the
// source row (ROW on axis 0) is read as V-wide vectors.
template <int AXIS, bool ROW, int V, bool VIN>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ src, const int* __restrict__ idx, float* __restrict__ out,
    int n, int l, long long src_s0, long long src_s1, long long idx_s0, long long idx_s1,
    int tpr) {
  const int tx = threadIdx.x & (tpr - 1);
  const int ty = threadIdx.x / tpr;
  const int rpb = kThreads / tpr;
  const int c = (blockIdx.x * tpr + tx) * V;
  const bool lane_ok = c < l;
  for (int base = blockIdx.y * rpb; base < n; base += gridDim.y * rpb) {
    const int i = base + ty;  // the same trip count for the whole block
    float v[V];
    if constexpr (ROW) {
      const int ic = i < n ? i : n - 1;
      int j = 0;
      if (tx == 0) j = __ldg(idx + ic * idx_s0);
      if (tpr > 1) j = __shfl_sync(0xffffffffu, j, 0, tpr);
      if (i >= n || !lane_ok) continue;
      if constexpr (AXIS == 0) {
        const float* row = src + j * src_s0;
        if constexpr (VIN) {
          load_vec<V>(row + c, v);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = __ldg(row + (c + k) * src_s1);
        }
      } else {
        const float x = __ldg(src + i * src_s0 + j * src_s1);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = x;
      }
    } else {
      if (i >= n || !lane_ok) continue;
      int j[V];
      const int* ip = idx + i * idx_s0;
      if constexpr (VIN) {
        load_vec<V>(ip + c, j);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) j[k] = __ldg(ip + (c + k) * idx_s1);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = AXIS == 0 ? __ldg(src + j[k] * src_s0 + (c + k) * src_s1)
                         : __ldg(src + i * src_s0 + j[k] * src_s1);
      }
    }
    store<V>(out + static_cast<long long>(i) * l + c, v);
  }
}

// "columns": a block of wpb warps takes wpb adjacent columns of dst; warp w
// owns column col0 + w and keeps it in shared memory.  The block stages
// kStage rows of g and idx for its columns at a time (every load of a stage
// in flight at once, 4 * wpb contiguous bytes a row), then each warp walks
// the staged rows of its column in order, 32 at a time.  Lanes whose rows
// hit the same entry add in lane (row) order: in each pass the lowest
// pending lane of every entry wins (a shared-memory atomicMin on the
// entry's owner word), adds, and frees the word; a round without repeats
// takes one pass.  At the end the block writes its columns row by row.
// Writes every entry of dst (no zeroing before).  Rows of the stage and of
// the tables are padded by one word against bank conflicts.
constexpr int kStage = 256;
constexpr int kFree = 0x7fffffff;

__global__ void __launch_bounds__(kThreads) scatter_columns_kernel(
    const float* __restrict__ g, const int* __restrict__ idx, float* __restrict__ dst, int n,
    int l, int rows, long long idx_s0, long long idx_s1) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tstride = rows + 1;  // one table a warp, padded
  const int sstride = wpb + 1;   // one staged row, padded
  float* tables = smem;
  int* owners = reinterpret_cast<int*>(tables + wpb * tstride);
  int* s_idx = owners + wpb * tstride;
  float* s_g = reinterpret_cast<float*>(s_idx + kStage * sstride);
  float* table = tables + warp * tstride;
  int* owner = owners + warp * tstride;
  const int ly = threadIdx.x / wpb;  // staging: 32 rows x wpb columns a pass
  const int lx = threadIdx.x - ly * wpb;
  for (int col0 = blockIdx.x * wpb; col0 < l; col0 += gridDim.x * wpb) {
    const int col = col0 + warp;
    for (int r = lane; r < rows; r += 32) {
      table[r] = 0.f;
      owner[r] = kFree;
    }
    for (int r0 = 0; r0 < n; r0 += kStage) {
      __syncthreads();  // the previous stage is consumed
      int xi[kStage / 32];
      float xg[kStage / 32];
      const int c = col0 + lx;
#pragma unroll
      for (int k = 0; k < kStage / 32; ++k) {
        const int i = r0 + ly + 32 * k;
        const bool ok = i < n && c < l;
        xi[k] = ok ? __ldg(idx + i * idx_s0 + c * idx_s1) : 0;
        xg[k] = ok ? __ldg(g + static_cast<long long>(i) * l + c) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kStage / 32; ++k) {
        s_idx[(ly + 32 * k) * sstride + lx] = xi[k];
        s_g[(ly + 32 * k) * sstride + lx] = xg[k];
      }
      __syncthreads();
      if (col >= l) continue;  // a whole warp: every lane shares col
      const int m = n - r0 < kStage ? n - r0 : kStage;
      for (int base = 0; base < m; base += 32) {
        const int s = base + lane;
        bool pending = s < m;
        const int j = pending ? s_idx[s * sstride + warp] : 0;
        const float v = pending ? s_g[s * sstride + warp] : 0.f;
        while (__any_sync(0xffffffffu, pending)) {
          if (pending) atomicMin(owner + j, lane);
          __syncwarp();
          if (pending && owner[j] == lane) {
            table[j] += v;
            owner[j] = kFree;
            pending = false;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    const int shift = __ffs(wpb) - 1;  // wpb is a power of two
    for (int e = threadIdx.x; e < rows * wpb; e += blockDim.x) {
      const int r = e >> shift;
      const int cc = e & (wpb - 1);
      if (col0 + cc < l) dst[static_cast<long long>(r) * l + col0 + cc] = tables[cc * tstride + r];
    }
    __syncthreads();
  }
}

// "atomic": one f32 atomicAdd per element into a zeroed dst; n * l < 2^31.
__global__ void __launch_bounds__(kThreads) scatter_atomic_kernel(
    const float* __restrict__ g, const int* __restrict__ idx, float* __restrict__ dst, int n,
    int l, long long idx_s0, long long idx_s1) {
  const int total = n * l;  // < 2^31 (the wrapper checks)
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const int i = e / l;
    const int c = e - i * l;
    atomicAdd(dst + static_cast<long long>(__ldg(idx + i * idx_s0 + c * idx_s1)) * l + c,
              __ldg(g + e));
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <int AXIS, bool ROW, int V, bool VIN>
void launch_gather(const float* src, const int* idx, float* out, int n, int l, long long src_s0,
                   long long src_s1, long long idx_s0, long long idx_s1, cudaStream_t stream) {
  const int chunks = l / V;
  int tpr = 1;
  while (tpr < chunks && tpr < 32) tpr <<= 1;
  const int rpb = kThreads / tpr;
  const int gx = (chunks + tpr - 1) / tpr;
  const long long row_blocks = (static_cast<long long>(n) + rpb - 1) / rpb;
  long long gy = (sm_count() * 8LL + gx - 1) / gx;  // about 8 blocks an SM in all
  if (gy > row_blocks) gy = row_blocks;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  gather_kernel<AXIS, ROW, V, VIN><<<dim3(gx, static_cast<unsigned>(gy)), kThreads, 0, stream>>>(
      src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, tpr);
}

template <int AXIS, bool ROW, int V>
void dispatch_vin(bool vin, const float* src, const int* idx, float* out, int n, int l,
                  long long src_s0, long long src_s1, long long idx_s0, long long idx_s1,
                  cudaStream_t stream) {
  if (vin) {
    launch_gather<AXIS, ROW, V, true>(src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, stream);
  } else {
    launch_gather<AXIS, ROW, V, false>(src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, stream);
  }
}

template <int AXIS, bool ROW>
void dispatch_width(const float* src, const int* idx, float* out, int n, int l, long long src_s0,
                    long long src_s1, long long idx_s0, long long idx_s1, cudaStream_t stream) {
  // The vector inputs of this form: the source row (a row gather on axis
  // 0) or the index (the per-lane forms); a row gather on axis 1 reads one
  // value a row and has none.
  auto vin_ok = [&](int v) {
    if (ROW) {
      return AXIS == 0 && src_s1 == 1 && src_s0 % v == 0 && aligned(src, 4 * v);
    }
    return idx_s1 == 1 && idx_s0 % v == 0 && aligned(idx, 4 * v);
  };
  if (l % 4 == 0) {
    dispatch_vin<AXIS, ROW, 4>(vin_ok(4), src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, stream);
  } else if (l % 2 == 0) {
    dispatch_vin<AXIS, ROW, 2>(vin_ok(2), src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, stream);
  } else {
    launch_gather<AXIS, ROW, 1, false>(src, idx, out, n, l, src_s0, src_s1, idx_s0, idx_s1, stream);
  }
}

}  // namespace

extern "C" {

// Switches to ``device`` for the launch if it is not the current one, and
// back after.
struct OnDevice {
  int prev = 0;
  int dev;
  explicit OnDevice(int device) : dev(device) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~OnDevice() {
    if (prev != dev) cudaSetDevice(prev);
  }
};

// Gather launch on ``device``.  src is read through its strides (elements);
// out is a freshly allocated contiguous (n, l) f32 array (16-byte aligned);
// n, l >= 1.  Returns cudaGetLastError() after the launch.
int dynhor_take_along_axis(const void* src, const void* idx, void* out, int n, int l,
                           long long src_s0, long long src_s1, long long idx_s0,
                           long long idx_s1, int axis, int device, void* stream) {
  OnDevice on(device);
  const auto* s = static_cast<const float*>(src);
  const auto* x = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool row = idx_s1 == 0;
  if (axis == 0) {
    if (row) {
      dispatch_width<0, true>(s, x, o, n, l, src_s0, src_s1, idx_s0, idx_s1, st);
    } else {
      dispatch_width<0, false>(s, x, o, n, l, src_s0, src_s1, idx_s0, idx_s1, st);
    }
  } else {
    if (row) {
      dispatch_width<1, true>(s, x, o, n, l, src_s0, src_s1, idx_s0, idx_s1, st);
    } else {
      dispatch_width<1, false>(s, x, o, n, l, src_s0, src_s1, idx_s0, idx_s1, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Scatter-add launch on ``device``.  g is a contiguous (n, l) f32 array
// (n * l < 2^31), dst a (rows, l) f32 array; path 0 "columns" writes every
// entry of dst, 1 "atomic" adds into a dst the caller zeroed.  The wrapper
// (kernels.scatter_plan) picks the path.  Returns cudaGetLastError() after
// the launch.
int dynhor_scatter_add_axis0(const void* g, const void* idx, void* dst, int n, int l, int rows,
                             long long idx_s0, long long idx_s1, int path, int device,
                             void* stream) {
  OnDevice on(device);
  const auto* gg = static_cast<const float*>(g);
  const auto* x = static_cast<const int*>(idx);
  auto* d = static_cast<float*>(dst);
  auto st = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    int wpb = kThreads / 32;
    auto bytes = [&](int w) {
      return (static_cast<size_t>(w) * (rows + 1) * 2 + static_cast<size_t>(kStage) * (w + 1) * 2) *
             sizeof(float);
    };
    while (wpb > 1 && bytes(wpb) > 48 * 1024) wpb >>= 1;
    const int grid = (l + wpb - 1) / wpb;
    scatter_columns_kernel<<<grid, wpb * 32, bytes(wpb), st>>>(gg, x, d, n, l, rows, idx_s0,
                                                              idx_s1);
  } else {
    const long long total = static_cast<long long>(n) * l;
    long long grid = (total + kThreads - 1) / kThreads;
    if (grid > sm_count() * 8LL) grid = sm_count() * 8LL;
    scatter_atomic_kernel<<<static_cast<int>(grid), kThreads, 0, st>>>(gg, x, d, n, l, idx_s0,
                                                                      idx_s1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
