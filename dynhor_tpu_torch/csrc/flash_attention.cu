// Flash attention for Hopper (sm_90a): forward and backward, bf16, head dim 64.
//
// Replaces both TPU attention kernels of dynhor_tpu/models/dino.py:
//   _flash_attention  (:202) -> jax.experimental.pallas.ops.tpu.flash_attention
//                               (forward, dq and dkv kernels under its custom VJP)
//   _splash_attention (:243) -> splash_attention_kernel.make_splash_mha
//                               (forward; dq + dkv or the fused backward)
// Both compute softmax(Q K^T * scale) V over the valid tokens and differ only
// in TPU tiling and in how padded tokens are kept harmless, so one set of
// kernels is the counterpart of both.  Nothing is padded here: the kernels
// take the true token count N and mask the ragged edge themselves (keys >= N
// get probability 0, rows >= N are neither loaded nor stored, out-of-range
// loads are zero-filled).
//
// What bounds it on this card: operations.  At the main path's shape
// (B 8, H 12, N 1370, d 64, bf16) the function needs 4 B H N^2 d operations
// forward and 10 B H N^2 d backward (1.6e11 together, 0.16 ms at the tensor
// cores' 989 TFLOP/s) against 2e8 bytes (0.06 ms at 3.35 TB/s).  So the
// design keeps the N x N scores and probabilities out of device memory (they
// live in shared memory, one 64 x 64 tile at a time) and runs every product
// on the tensor cores through nvcuda::wmma (bf16 16x16x16, f32 accumulators).
// wmma's accumulator layout is opaque, so each score tile is stored to
// shared memory for the row-wise softmax and reloaded as an operand.  This
// first version is simple rather than fast: no wgmma, no TMA; the only
// overlap is the next tile's loads held in registers while the current tile
// is computed.  The round trips through shared memory, not the tensor cores,
// limit it.
//
// Arithmetic, as models/dino._attention rounds it: scores and exp in f32,
// the probabilities rounded to bf16 BEFORE the P V product, accumulation in
// f32, division by the f32 row sum at the end.  The backward recomputes P
// from q, k and the saved row log-sum-exp:
//   delta = rowsum(dO * O);  dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale,
// with P and dS rounded to bf16 for their products.  dK/dV and dQ are two
// passes (one block per key tile, one per query tile) without atomics, so
// the result is the same from run to run.
//
// Layout: q, k, v, dO are (B, H, N, 64) views given by their batch, head and
// token strides in elements; the innermost 64 values are contiguous and every
// row is 16-byte aligned.  o, dq, dk, dv are written through strides too.
// lse and delta are contiguous (B, H, N) f32.
//
// Plain C interface; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int HD = 64;        // head dim
constexpr int BT = 64;        // tile edge: rows per block, columns per loop step
constexpr int WARPS = 4;      // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int LDB = 72;       // bf16 row stride in shared memory (144 bytes)
constexpr int LDF = 68;       // f32 row stride in shared memory (272 bytes)
// Three blocks fit an SM's shared memory; holding the compiler to their
// register budget (168 a thread) keeps all three resident.
constexpr int MIN_BLOCKS = 3;
constexpr int TILE_B = BT * LDB;          // bf16 elements of one 64 x 64 tile
constexpr int WARP_F = 16 * LDF;          // f32 elements of one warp's 16 x 64 scratch
constexpr int WARP_B = 16 * LDB;          // bf16 elements of one warp's 16 x 64 operand
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int SMEM_FWD = 3 * TILE_B * 2 + 2 * WARPS * WARP_F * 4 + WARPS * WARP_B * 2;
constexpr int SMEM_DKV = 2 * TILE_B * 2 + 2 * WARPS * WARP_F * 4 + 2 * WARPS * WARP_B * 2
                         + 2 * BT * 4;
constexpr int SMEM_DQ = 2 * TILE_B * 2 + 2 * WARPS * WARP_F * 4 + WARPS * WARP_B * 2;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Rows [row0, row0 + 64) of one (batch, head) slice -> registers
// (fetch_tile) -> a 64 x LDB tile in shared memory (put_tile); rows >= n are
// zero-filled, never read.
// A 64 x 64 bf16 tile in flight from device memory: four 16-byte loads a
// thread.  The loops fetch the next tile into registers before they compute
// on the current one, so the loads' latency hides behind the products.
struct TileRegs {
    uint4 v[BT * (HD / 8) / THREADS];
};

__device__ __forceinline__ void fetch_tile(TileRegs& t, const bf16* src, i64 stride_n,
                                           int row0, int n) {
#pragma unroll
    for (int s = 0; s < BT * (HD / 8) / THREADS; ++s) {
        const int i = threadIdx.x + s * THREADS;
        const int r = i >> 3, c = (i & 7) * 8;
        t.v[s] = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n)
            t.v[s] = *reinterpret_cast<const uint4*>(src + (i64)(row0 + r) * stride_n + c);
    }
}

__device__ __forceinline__ void put_tile(bf16* dst, const TileRegs& t) {
#pragma unroll
    for (int s = 0; s < BT * (HD / 8) / THREADS; ++s) {
        const int i = threadIdx.x + s * THREADS;
        *reinterpret_cast<uint4*>(dst + (i >> 3) * LDB + (i & 7) * 8) = t.v[s];
    }
}

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, i64 stride_n,
                                          int row0, int n) {
    TileRegs t;
    fetch_tile(t, src, stride_n, row0, n);
    put_tile(dst, t);
}

// The warp's four A operands (16 rows x 64) from a tile in shared memory.
__device__ __forceinline__ void load_a4(FragA (&a)[4], const bf16* tile_rows) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wmma::load_matrix_sync(a[kk], tile_rows + kk * 16, LDB);
}

// out (16 x 64, f32, shared) = A (16 x 64 of the warp) * T^T, T a 64 x 64
// tile in shared memory read as the column-major B operand.
__device__ __forceinline__ void mma_a_tt(float* out, const FragA (&a)[4], const bf16* tile) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        FragC acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            FragBCol bt;
            wmma::load_matrix_sync(bt, tile + j * 16 * LDB + kk * 16, LDB);
            wmma::mma_sync(acc, a[kk], bt, acc);
        }
        wmma::store_matrix_sync(out + j * 16, acc, LDF, wmma::mem_row_major);
    }
}

// acc[j] += A (16 x 64, bf16, the warp's operand in shared memory) * T, T a
// 64 x 64 tile in shared memory read as the row-major B operand.
__device__ __forceinline__ void mma_acc_at(FragC (&acc)[4], const bf16* a_rows, const bf16* tile) {
    FragA a[4];
    load_a4(a, a_rows);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            FragBRow bt;
            wmma::load_matrix_sync(bt, tile + kk * 16 * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], a[kk], bt, acc[j]);
        }
    }
}

// In the elementwise passes over a warp's 16 x 64 scratch, lane (r, half)
// owns 32 columns of row r = lane / 2.  The i-th column it visits is rotated
// per lane so that the 32 lanes hit 32 different banks at every step (the
// f32 row stride is 68 words, so bank = 4 r + column).
__device__ __forceinline__ int lane_col(int lane, int i) {
    const int r = lane >> 1, half = lane & 1;
    return half * 32 + ((i + half - 2 * r) & 31);
}

// The warp's 16 x 64 f32 scratch -> bf16 rows of a strided output, rows
// >= n skipped, each value times mul; 16 bytes per store.
__device__ __forceinline__ void store_rows(bf16* dst, i64 stride_n, int row0, int n,
                                           const float* src, float mul, int lane) {
    const int r = lane >> 1, half = lane & 1;
    if (row0 + r >= n) return;
    bf16* out = dst + (i64)(row0 + r) * stride_n + half * 32;
    const float* in = src + r * LDF + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
        __align__(16) __nv_bfloat162 pack[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            pack[e] = __floats2bfloat162_rn(in[c + 2 * e] * mul, in[c + 2 * e + 1] * mul);
        *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(pack);
    }
}

// Forward: one block per (query tile, head, batch); a loop over key tiles.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int N, float scale_log2,
    i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn,
    i64 osb, i64 osh, i64 osn) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = sQ + TILE_B;
    bf16* sV = sK + TILE_B;
    float* sS = reinterpret_cast<float*>(sV + TILE_B);
    float* sO = sS + WARPS * WARP_F;
    bf16* sP = reinterpret_cast<bf16*>(sO + WARPS * WARP_F);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    q += b * qsb + h * qsh;
    k += b * ksb + h * ksh;
    v += b * vsb + h * vsh;
    o += b * osb + h * osh;
    float* S = sS + warp * WARP_F;
    float* O = sO + warp * WARP_F;
    bf16* P = sP + warp * WARP_B;

    load_tile(sQ, q, qsn, q0, N);
    for (int i = lane; i < WARP_F; i += 32) O[i] = 0.0f;
    __syncthreads();
    FragA qa[4];
    load_a4(qa, sQ + warp * WARP_B);

    const int r = lane >> 1;
    float m = -INFINITY, l = 0.0f;  // running row maximum (log2 units) and sum
    TileRegs kr, vr;
    fetch_tile(kr, k, ksn, 0, N);
    fetch_tile(vr, v, vsn, 0, N);
    for (int k0 = 0; k0 < N; k0 += BT) {
        __syncthreads();  // every warp is done with the previous key tile
        put_tile(sK, kr);
        put_tile(sV, vr);
        __syncthreads();
        if (k0 + BT < N) {
            fetch_tile(kr, k, ksn, k0 + BT, N);
            fetch_tile(vr, v, vsn, k0 + BT, N);
        }
        mma_a_tt(S, qa, sK);  // S = Q K^T
        __syncwarp();
        float x[32];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int c = lane_col(lane, i);
            // Keys >= N are masked before the maximum.  The tile holds at
            // least one valid key, so the maximum is finite.
            x[i] = (k0 + c < N) ? S[r * LDF + c] * scale_log2 : -INFINITY;
            mx = fmaxf(mx, x[i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m, mx);
        const float alpha = exp2f(m - m_new);  // 0 at the first tile
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int c = lane_col(lane, i);
            const float p = exp2f(x[i] - m_new);
            sum += p;
            P[r * LDB + c] = __float2bfloat16(p);
            O[r * LDF + c] *= alpha;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l = l * alpha + sum;
        m = m_new;
        __syncwarp();
        // O += P V, the accumulator kept in shared memory between tiles.
        FragC acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(acc[j], O + j * 16, LDF, wmma::mem_row_major);
        mma_acc_at(acc, P, sV);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(O + j * 16, acc[j], LDF, wmma::mem_row_major);
        __syncwarp();
    }
    const int row = q0 + warp * 16 + r;
    store_rows(o, osn, q0 + warp * 16, N, O, 1.0f / l, lane);
    if (row < N && (lane & 1) == 0)
        lse[((i64)b * H + h) * N + row] = (m + log2f(l)) * LN2;
}

// delta = rowsum(dO * O): eight threads per row, 16 bytes each.
__global__ void __launch_bounds__(256) flash_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ d_o, float* __restrict__ delta,
    int H, int N, i64 rows, i64 osb, i64 osh, i64 osn, i64 dsb, i64 dsh, i64 dsn) {
    const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const i64 row = t >> 3;
    const int part = (int)(t & 7);
    float sum = 0.0f;
    if (row < rows) {
        const int n = (int)(row % N);
        const i64 bh = row / N;
        const i64 h = bh % H, b = bh / H;
        const uint4 a = *reinterpret_cast<const uint4*>(o + b * osb + h * osh + n * osn + part * 8);
        const uint4 g = *reinterpret_cast<const uint4*>(d_o + b * dsb + h * dsh + n * dsn + part * 8);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(pa[e]), fg = __bfloat1622float2(pg[e]);
            sum += fa.x * fg.x + fa.y * fg.y;
        }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if (row < rows && part == 0) delta[row] = sum;
}

// dK and dV: one block per (key tile, head, batch); a loop over query tiles.
// Each warp owns 16 keys and works on the transposed tiles S^T, P^T, dS^T.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, float scale, float scale_log2,
    i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn,
    i64 gsb, i64 gsh, i64 gsn, i64 dksb, i64 dksh, i64 dksn, i64 dvsb, i64 dvsh, i64 dvsn) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sG = sQ + TILE_B;  // dO
    float* sA = reinterpret_cast<float*>(sG + TILE_B);
    float* sB = sA + WARPS * WARP_F;
    bf16* sP = reinterpret_cast<bf16*>(sB + WARPS * WARP_F);
    bf16* sD = sP + WARPS * WARP_B;
    float* sL = reinterpret_cast<float*>(sD + WARPS * WARP_B);  // lse in log2 units
    float* sDelta = sL + BT;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    q += b * qsb + h * qsh;
    k += b * ksb + h * ksh;
    v += b * vsb + h * vsh;
    d_o += b * gsb + h * gsh;
    dk += b * dksb + h * dksh;
    dv += b * dvsb + h * dvsh;
    lse += ((i64)b * H + h) * N;
    delta += ((i64)b * H + h) * N;
    float* A = sA + warp * WARP_F;
    float* Bf = sB + warp * WARP_F;
    bf16* P = sP + warp * WARP_B;
    bf16* D = sD + warp * WARP_B;

    // The block's keys and values, staged through the loop's tiles.
    load_tile(sQ, k, ksn, k0, N);
    load_tile(sG, v, vsn, k0, N);
    __syncthreads();
    FragA ka[4], va[4];
    load_a4(ka, sQ + warp * WARP_B);
    load_a4(va, sG + warp * WARP_B);
    FragC dk_acc[4], dv_acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        wmma::fill_fragment(dk_acc[j], 0.0f);
        wmma::fill_fragment(dv_acc[j], 0.0f);
    }
    const int r = lane >> 1;
    const bool key_valid = k0 + warp * 16 + r < N;
    TileRegs qr, gr;
    fetch_tile(qr, q, qsn, 0, N);
    fetch_tile(gr, d_o, gsn, 0, N);
    for (int q0 = 0; q0 < N; q0 += BT) {
        __syncthreads();
        put_tile(sQ, qr);
        put_tile(sG, gr);
        if (threadIdx.x < BT) {
            const bool ok = q0 + threadIdx.x < N;
            sL[threadIdx.x] = ok ? lse[q0 + threadIdx.x] * LOG2E : 0.0f;
            sDelta[threadIdx.x] = ok ? delta[q0 + threadIdx.x] : 0.0f;
        }
        __syncthreads();
        if (q0 + BT < N) {
            fetch_tile(qr, q, qsn, q0 + BT, N);
            fetch_tile(gr, d_o, gsn, q0 + BT, N);
        }
        mma_a_tt(A, ka, sQ);   // S^T = K Q^T
        mma_a_tt(Bf, va, sG);  // dP^T = V dO^T
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int c = lane_col(lane, i);  // a query of the tile
            float p = exp2f(A[r * LDF + c] * scale_log2 - sL[c]);
            if (!key_valid || q0 + c >= N) p = 0.0f;
            P[r * LDB + c] = __float2bfloat16(p);
            D[r * LDB + c] = __float2bfloat16(p * (Bf[r * LDF + c] - sDelta[c]));
        }
        __syncwarp();
        mma_acc_at(dv_acc, P, sG);  // dV += P^T dO
        mma_acc_at(dk_acc, D, sQ);  // dK += dS^T Q
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(A + j * 16, dk_acc[j], LDF, wmma::mem_row_major);
        wmma::store_matrix_sync(Bf + j * 16, dv_acc[j], LDF, wmma::mem_row_major);
    }
    __syncwarp();
    store_rows(dk, dksn, k0 + warp * 16, N, A, scale, lane);
    store_rows(dv, dvsn, k0 + warp * 16, N, Bf, 1.0f, lane);
}

// dQ: one block per (query tile, head, batch); a loop over key tiles.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int N, float scale, float scale_log2,
    i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn,
    i64 gsb, i64 gsh, i64 gsn, i64 dqsb, i64 dqsh, i64 dqsn) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = sK + TILE_B;
    float* sA = reinterpret_cast<float*>(sV + TILE_B);
    float* sB = sA + WARPS * WARP_F;
    bf16* sD = reinterpret_cast<bf16*>(sB + WARPS * WARP_F);

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
    q += b * qsb + h * qsh;
    k += b * ksb + h * ksh;
    v += b * vsb + h * vsh;
    d_o += b * gsb + h * gsh;
    dq += b * dqsb + h * dqsh;
    lse += ((i64)b * H + h) * N;
    delta += ((i64)b * H + h) * N;
    float* A = sA + warp * WARP_F;
    float* Bf = sB + warp * WARP_F;
    bf16* D = sD + warp * WARP_B;

    // The block's queries and their cotangents, staged through the loop's tiles.
    load_tile(sK, q, qsn, q0, N);
    load_tile(sV, d_o, gsn, q0, N);
    __syncthreads();
    FragA qa[4], ga[4];
    load_a4(qa, sK + warp * WARP_B);
    load_a4(ga, sV + warp * WARP_B);
    FragC dq_acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);
    const int r = lane >> 1;
    const int row = q0 + warp * 16 + r;
    const float row_lse = row < N ? lse[row] * LOG2E : 0.0f;
    const float row_delta = row < N ? delta[row] : 0.0f;
    TileRegs kr, vr;
    fetch_tile(kr, k, ksn, 0, N);
    fetch_tile(vr, v, vsn, 0, N);
    for (int k0 = 0; k0 < N; k0 += BT) {
        __syncthreads();
        put_tile(sK, kr);
        put_tile(sV, vr);
        __syncthreads();
        if (k0 + BT < N) {
            fetch_tile(kr, k, ksn, k0 + BT, N);
            fetch_tile(vr, v, vsn, k0 + BT, N);
        }
        mma_a_tt(A, qa, sK);   // S = Q K^T
        mma_a_tt(Bf, ga, sV);  // dP = dO V^T
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int c = lane_col(lane, i);  // a key of the tile
            float p = exp2f(A[r * LDF + c] * scale_log2 - row_lse);
            if (row >= N || k0 + c >= N) p = 0.0f;
            D[r * LDB + c] = __float2bfloat16(p * (Bf[r * LDF + c] - row_delta));
        }
        __syncwarp();
        mma_acc_at(dq_acc, D, sK);  // dQ += dS K
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(A + j * 16, dq_acc[j], LDF, wmma::mem_row_major);
    __syncwarp();
    store_rows(dq, dqsn, q0 + warp * 16, N, A, scale, lane);
}

}  // namespace

// Strides arrive as one array of 64-bit element counts, (batch, head, token)
// per tensor in the order of the tensor arguments.

extern "C" int dynhor_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int N, float sm_scale, const long long* st,
                                void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BT - 1) / BT, H, B);
    flash_fwd_kernel<<<grid, THREADS, SMEM_FWD, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, N,
        sm_scale * LOG2E, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        st[9], st[10], st[11]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_delta(const void* o, const void* d_o, void* delta, int B, int H,
                                  int N, const long long* st, void* stream) {
    const long long rows = (long long)B * H * N;
    const long long blocks = (rows * 8 + 255) / 256;
    flash_delta_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)o, (const bf16*)d_o, (float*)delta, H, N, rows, st[0], st[1], st[2],
        st[3], st[4], st[5]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    int B, int H, int N, float sm_scale, const long long* st,
                                    void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BT - 1) / BT, H, B);
    flash_bwd_dkv_kernel<<<grid, THREADS, SMEM_DKV, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, H, N, sm_scale, sm_scale * LOG2E,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        st[12], st[13], st[14], st[15], st[16], st[17]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                   const void* lse, const void* delta, void* dq, int B, int H,
                                   int N, float sm_scale, const long long* st, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + BT - 1) / BT, H, B);
    flash_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, (const float*)lse,
        (const float*)delta, (bf16*)dq, H, N, sm_scale, sm_scale * LOG2E,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}
