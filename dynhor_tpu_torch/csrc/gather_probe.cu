// Gather and scatter-add kernels for sm_90a: the forms that
// tools/probe_pallas_gather.py probes on the TPU (K6), as the port's probe
// (dynhor_tpu_torch/tools/probe_gather.py) runs them on the card.
//
// take_along_axis_kernel replaces the gathers of the probe's forms A-G
// (tools/probe_pallas_gather.py kern_a, kern_b, kern_c, kern_d, kern_e,
// kern_f, kern_g and the timed kern_t): out[i, l] = src[idx[i, l], l]
// (axis 0) or src[i, idx[i, l]] (axis 1).  The index is read through its
// two strides, either of which may be 0, so a row gather by one index per
// row (A, D: stride 0 along l) and a lane gather of one row (B) are launches
// of the same kernel as the per-lane gathers (C, E, F, G).
// scatter_add_axis0_kernel replaces form H (kern_h): dst[idx[i, l], l] +=
// g[i, l], with f32 atomicAdd, so the order of the sums changes from run
// to run.  Plain versions: dynhor_tpu_torch/ops/gather.py (torch.gather and
// scatter_add_ on the expanded index); the wrappers are in
// dynhor_tpu_torch/kernels.py.
//
// What bounds them.  Each output element costs one index load and one
// element load (or one atomic add), with no arithmetic: bytes bound them.
// One thread per output element, neighbouring threads on neighbouring l,
// so the index and output accesses coalesce; the gathered loads are as
// scattered as the indices make them.  The TPU probe asked which of these
// forms Mosaic would lower at all; on the card every form is a plain
// load, so one kernel serves all seven gathers.  Indices must lie in
// range: the kernels do not check them (jnp.take would fill and
// take_along_axis clamp).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void take_along_axis_kernel(const float* __restrict__ src,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out, long long n,
                                       int l, long long src_s0,
                                       long long src_s1, long long idx_s0,
                                       long long idx_s1, int axis) {
  const long long total = n * l;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = e / l;
    const long long c = e - i * l;
    const long long j = idx[i * idx_s0 + c * idx_s1];
    out[e] = axis == 0 ? src[j * src_s0 + c * src_s1] : src[i * src_s0 + j * src_s1];
  }
}

__global__ void scatter_add_axis0_kernel(const float* __restrict__ g,
                                         const int* __restrict__ idx,
                                         float* __restrict__ dst, long long n,
                                         int l, long long idx_s0,
                                         long long idx_s1) {
  const long long total = n * l;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = e / l;
    const long long c = e - i * l;
    const long long j = idx[i * idx_s0 + c * idx_s1];
    atomicAdd(dst + j * l + c, g[e]);
  }
}

int blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < 8192 ? b : 8192);
}

}  // namespace

extern "C" {

// Gather launch.  src is read through its strides (elements); out is a
// contiguous (n, l) f32 array.  Returns cudaGetLastError() after the launch.
int dynhor_take_along_axis(const void* src, const void* idx, void* out,
                           long long n, int l, long long src_s0,
                           long long src_s1, long long idx_s0,
                           long long idx_s1, int axis, void* stream) {
  take_along_axis_kernel<<<blocks_for(n * l), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), n, l, src_s0, src_s1, idx_s0, idx_s1, axis);
  return static_cast<int>(cudaGetLastError());
}

// Scatter-add launch.  g is a contiguous (n, l) f32 array, dst a contiguous
// (rows, l) f32 array that the caller zeroed.  Returns cudaGetLastError()
// after the launch.
int dynhor_scatter_add_axis0(const void* g, const void* idx, void* dst,
                             long long n, int l, long long idx_s0,
                             long long idx_s1, void* stream) {
  scatter_add_axis0_kernel<<<blocks_for(n * l), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(idx),
      static_cast<float*>(dst), n, l, idx_s0, idx_s1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
