// Flash attention in f32 for sm_90a: forward, delta, dK/dV and dQ, head dim 64.
//
// The f32 counterpart of csrc/flash_attention.cu.  It replaces the same two
// TPU attention kernels of dynhor_tpu/models/dino.py, _flash_attention (:202)
// and _splash_attention (:243), where the ViT computes in f32
// (RefineConfig.dino_dtype or PriorConfig.dino_dtype "float32"): both run at
// the ViT's compute dtype there.  The bf16 kernels stay in their own source.
//
// What bounds it on this card: operations, on the CUDA cores.  The tensor
// cores take f32 only as TF32, whose 10-bit mantissa cannot hold the f32
// result within 1e-5; so every product here is an f32 FMA, at most
// 67 TFLOP/s.  At the main path's shape (B 8, H 12, N 1370) the forward's two
// products are 4.6e10 operations (0.69 ms) against 2.7e8 bytes of q, k, v, o
// and lse (0.08 ms at 3.35 TB/s).
//
// Design: simple SIMT tiles, two lanes per row.  A block of 128 threads owns
// 64 rows (queries in the forward and dQ, keys in dK/dV); the two lanes of a
// row hold interleaved halves of its 64 values in registers (16-byte pieces
// 2i and 2i + 1), so a dot product is 32 FMAs per lane and one shuffle.  The
// block stages 64 rows of the other side (keys and values, or queries and
// dO) in shared memory, where every row of the block reads the same staged
// row: the two halves of one row lie in neighbouring banks, so a warp's read
// is one broadcast.
//   Forward: online softmax over 16-key tiles of scores kept in registers.
//   dQ: per key, p = exp(s - lse), dS = p (dP - delta), dQ += dS K.
//   dK/dV: per query, dV += p dO, dK += dS Q.
// The backward is two passes without atomics, as in the bf16 kernels, so it
// is the same from run to run; delta = rowsum(dO * O) is its own small pass.
//
// Arithmetic, as ops/flash_attention's plain versions in f32: s = (q . k) *
// scale, p = exp(s - m) with the accurate expf, the output divided by the row
// sum at the end, lse = m + log(l); the backward recomputes p from lse, and
// dQ and dK are scaled once at the end.  The sums run in another order than
// the plain version's matrix products.
//
// The true token count N masks the ragged edge: staged rows >= N are zero and
// their scores -inf in the forward; the backward loops stop at N; rows >= N
// are neither loaded nor stored.
//
// Layout: q, k, v, dO, o, dq, dk, dv are (B, H, N, 64) views given by their
// batch, head and token strides in elements; the innermost 64 values are
// contiguous, the base 16-byte aligned and every stride a multiple of 4
// elements (kernels.tma_layout checks it), so every access is a 16-byte load
// or store.  lse and delta are contiguous (B, H, N) f32.  Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef long long i64;

constexpr int HD = 64;             // head dim
constexpr int PIECES = HD / 4;     // 16-byte pieces of a row
constexpr int MINE = PIECES / 2;   // pieces a lane holds: 2 i + lane's half
constexpr int THREADS = 128;
constexpr int ROWS = THREADS / 2;  // rows of a block
constexpr int KB = 64;             // rows of the other side staged per step
constexpr int ST = 16;             // score tile of the forward

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float s, float4 x, float4 y) {
    return make_float4(fmaf(s, x.x, y.x), fmaf(s, x.y, y.y), fmaf(s, x.z, y.z), fmaf(s, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float s, float4 x) {
    return make_float4(s * x.x, s * x.y, s * x.z, s * x.w);
}

// The dot product of a row whose halves two neighbouring lanes hold in mine[]
// with a staged row (PIECES float4s): both lanes return the same sum.
__device__ __forceinline__ float row_dot(const float4 (&mine)[MINE], const float4* staged, int half) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < MINE; ++i) acc = dot4(mine[i], staged[2 * i + half], acc);
    return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// Loads a lane's half of row n of a (B, H, N, 64) view (zeros for n >= N).
__device__ __forceinline__ void load_half(float4 (&out)[MINE], const float* base, i64 row_off,
                                          bool valid, int half) {
#pragma unroll
    for (int i = 0; i < MINE; ++i)
        out[i] = valid ? load4(base + row_off + 4 * (2 * i + half)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store_half(float* base, i64 row_off, const float4 (&x)[MINE], int half) {
#pragma unroll
    for (int i = 0; i < MINE; ++i) store4(base + row_off + 4 * (2 * i + half), x[i]);
}

// Stages rows [row0, row0 + KB) of one or two (B, H, N, 64) views into
// shared memory, zeros past N.
__device__ __forceinline__ void stage(float4* dst, const float* src, i64 head_off, i64 sn, int row0,
                                      int N) {
    for (int e = threadIdx.x; e < KB * PIECES; e += THREADS) {
        const int r = e / PIECES, c = e % PIECES;
        dst[e] = row0 + r < N ? load4(src + head_off + (i64)(row0 + r) * sn + 4 * c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Forward: a block per (64 query rows, head, batch); a loop over 64-key
// steps, each as four 16-key score tiles.
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, float scale, i64 qsb, i64 qsh,
    i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn, i64 osb, i64 osh, i64 osn) {
    __shared__ float4 s_k[KB * PIECES], s_v[KB * PIECES];
    const int half = threadIdx.x & 1;
    const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
    const int h = blockIdx.y, b = blockIdx.z;
    const bool valid = row < N;
    float4 qr[MINE], acc[MINE];
    load_half(qr, q, b * qsb + h * qsh + (i64)row * qsn, valid, half);
#pragma unroll
    for (int i = 0; i < MINE; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = -INFINITY, l = 0.0f;
    for (int base = 0; base < N; base += KB) {
        __syncthreads();  // the previous step's tiles are consumed
        stage(s_k, k, b * ksb + h * ksh, ksn, base, N);
        stage(s_v, v, b * vsb + h * vsh, vsn, base, N);
        __syncthreads();
        const int nk = min(KB, N - base);
        for (int j0 = 0; j0 < nk; j0 += ST) {
            float s[ST];
            float tile_max = -INFINITY;
#pragma unroll
            for (int j = 0; j < ST; ++j) {
                const float dot = row_dot(qr, s_k + (j0 + j) * PIECES, half);
                s[j] = j0 + j < nk ? dot * scale : -INFINITY;
                tile_max = fmaxf(tile_max, s[j]);
            }
            const float m_new = fmaxf(m, tile_max);
            const float alpha = expf(m - m_new);  // 0 at the first tile
            float psum = 0.0f;
#pragma unroll
            for (int i = 0; i < MINE; ++i) acc[i] = scale4(alpha, acc[i]);
#pragma unroll
            for (int j = 0; j < ST; ++j) {
                const float p = expf(s[j] - m_new);
                psum += p;
                const float4* vr = s_v + (j0 + j) * PIECES;
#pragma unroll
                for (int i = 0; i < MINE; ++i) acc[i] = axpy4(p, vr[2 * i + half], acc[i]);
            }
            l = l * alpha + psum;
            m = m_new;
        }
    }
    if (!valid) return;
#pragma unroll
    for (int i = 0; i < MINE; ++i)
        acc[i] = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l, acc[i].w / l);
    store_half(o, b * osb + h * osh + (i64)row * osn, acc, half);
    if (half == 0) lse[((i64)b * H + h) * N + row] = m + logf(l);
}

// delta = rowsum(dO * O): sixteen threads per row, 16 bytes each.
__global__ void __launch_bounds__(256) flash_delta_f32_kernel(
    const float* __restrict__ o, const float* __restrict__ d_o, float* __restrict__ delta, int H,
    int N, i64 rows, i64 osb, i64 osh, i64 osn, i64 dsb, i64 dsh, i64 dsn) {
    const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const i64 row = t / PIECES;
    const int part = (int)(t % PIECES);
    float sum = 0.0f;
    if (row < rows) {
        const int n = (int)(row % N);
        const i64 bh = row / N;
        const i64 h = bh % H, b = bh / H;
        const float4 a = load4(o + b * osb + h * osh + n * osn + 4 * part);
        const float4 g = load4(d_o + b * dsb + h * dsh + n * dsn + 4 * part);
        sum = dot4(a, g, 0.0f);
    }
#pragma unroll
    for (int w = 1; w < PIECES; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (row < rows && part == 0) delta[row] = sum;
}

// dK and dV: a block per (64 keys, head, batch); a loop over 64-row query
// steps (q, dO, and the rows' lse and delta).
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int N, float scale, i64 qsb, i64 qsh,
    i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn, i64 gsb, i64 gsh, i64 gsn,
    i64 dksb, i64 dksh, i64 dksn, i64 dvsb, i64 dvsh, i64 dvsn) {
    __shared__ float4 s_q[KB * PIECES], s_g[KB * PIECES];
    __shared__ float s_lse[KB], s_delta[KB];
    const int half = threadIdx.x & 1;
    const int key = blockIdx.x * ROWS + (threadIdx.x >> 1);
    const int h = blockIdx.y, b = blockIdx.z;
    const bool valid = key < N;
    const i64 bh = (i64)b * H + h;
    float4 kr[MINE], vr[MINE], dkr[MINE], dvr[MINE];
    load_half(kr, k, b * ksb + h * ksh + (i64)key * ksn, valid, half);
    load_half(vr, v, b * vsb + h * vsh + (i64)key * vsn, valid, half);
#pragma unroll
    for (int i = 0; i < MINE; ++i) {
        dkr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        dvr[i] = dkr[i];
    }
    for (int base = 0; base < N; base += KB) {
        __syncthreads();
        stage(s_q, q, b * qsb + h * qsh, qsn, base, N);
        stage(s_g, d_o, b * gsb + h * gsh, gsn, base, N);
        for (int r = threadIdx.x; r < KB; r += THREADS) {
            s_lse[r] = base + r < N ? lse[bh * N + base + r] : 0.0f;
            s_delta[r] = base + r < N ? delta[bh * N + base + r] : 0.0f;
        }
        __syncthreads();
        const int nq = min(KB, N - base);
#pragma unroll 2
        for (int i = 0; i < nq; ++i) {
            const float4* qi = s_q + i * PIECES;
            const float4* gi = s_g + i * PIECES;
            const float p = expf(row_dot(kr, qi, half) * scale - s_lse[i]);
            const float ds = p * (row_dot(vr, gi, half) - s_delta[i]);
#pragma unroll
            for (int c = 0; c < MINE; ++c) {
                dvr[c] = axpy4(p, gi[2 * c + half], dvr[c]);
                dkr[c] = axpy4(ds, qi[2 * c + half], dkr[c]);
            }
        }
    }
    if (!valid) return;
#pragma unroll
    for (int i = 0; i < MINE; ++i) dkr[i] = scale4(scale, dkr[i]);
    store_half(dk, b * dksb + h * dksh + (i64)key * dksn, dkr, half);
    store_half(dv, b * dvsb + h * dvsh + (i64)key * dvsn, dvr, half);
}

// dQ: a block per (64 query rows, head, batch); a loop over 64-key steps.
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int N, float scale, i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh,
    i64 ksn, i64 vsb, i64 vsh, i64 vsn, i64 gsb, i64 gsh, i64 gsn, i64 dqsb, i64 dqsh, i64 dqsn) {
    __shared__ float4 s_k[KB * PIECES], s_v[KB * PIECES];
    const int half = threadIdx.x & 1;
    const int row = blockIdx.x * ROWS + (threadIdx.x >> 1);
    const int h = blockIdx.y, b = blockIdx.z;
    const bool valid = row < N;
    const i64 bh = (i64)b * H + h;
    float4 qr[MINE], gr[MINE], dqr[MINE];
    load_half(qr, q, b * qsb + h * qsh + (i64)row * qsn, valid, half);
    load_half(gr, d_o, b * gsb + h * gsh + (i64)row * gsn, valid, half);
#pragma unroll
    for (int i = 0; i < MINE; ++i) dqr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float row_lse = valid ? lse[bh * N + row] : 0.0f;
    const float row_delta = valid ? delta[bh * N + row] : 0.0f;
    for (int base = 0; base < N; base += KB) {
        __syncthreads();
        stage(s_k, k, b * ksb + h * ksh, ksn, base, N);
        stage(s_v, v, b * vsb + h * vsh, vsn, base, N);
        __syncthreads();
        const int nk = min(KB, N - base);
#pragma unroll 2
        for (int j = 0; j < nk; ++j) {
            const float4* kj = s_k + j * PIECES;
            const float p = expf(row_dot(qr, kj, half) * scale - row_lse);
            const float ds = p * (row_dot(gr, s_v + j * PIECES, half) - row_delta);
#pragma unroll
            for (int c = 0; c < MINE; ++c) dqr[c] = axpy4(ds, kj[2 * c + half], dqr[c]);
        }
    }
    if (!valid) return;
#pragma unroll
    for (int i = 0; i < MINE; ++i) dqr[i] = scale4(scale, dqr[i]);
    store_half(dq, b * dqsb + h * dqsh + (i64)row * dqsn, dqr, half);
}

dim3 row_grid(int B, int H, int N) { return dim3((N + ROWS - 1) / ROWS, H, B); }

}  // namespace

// Strides arrive as one array of 64-bit element counts, (batch, head, token)
// per tensor in the order of the tensor arguments.

extern "C" int dynhor_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int N, float sm_scale,
                                    const long long* st, void* stream) {
    flash_fwd_f32_kernel<<<row_grid(B, H, N), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, N, sm_scale,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_delta_f32(const void* o, const void* d_o, void* delta, int B, int H,
                                      int N, const long long* st, void* stream) {
    const long long rows = (long long)B * H * N;
    const long long blocks = (rows * PIECES + 255) / 256;
    flash_delta_f32_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)o, (const float*)d_o, (float*)delta, H, N, rows, st[0], st[1], st[2], st[3],
        st[4], st[5]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                        const void* d_o, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int H, int N, float sm_scale,
                                        const long long* st, void* stream) {
    flash_bwd_dkv_f32_kernel<<<row_grid(B, H, N), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, H, N, sm_scale, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
        st[16], st[17]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                       const void* d_o, const void* lse, const void* delta,
                                       void* dq, int B, int H, int N, float sm_scale,
                                       const long long* st, void* stream) {
    flash_bwd_dq_f32_kernel<<<row_grid(B, H, N), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
        (const float*)delta, (float*)dq, H, N, sm_scale, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}
