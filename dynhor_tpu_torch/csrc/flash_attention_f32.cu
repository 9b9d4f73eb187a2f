// Flash attention in f32 for sm_90a: forward, delta, dK/dV and dQ, head dim 64.
//
// The f32 counterpart of csrc/flash_attention.cu.  It replaces the same two
// TPU attention kernels of dynhor_tpu/models/dino.py, _flash_attention (:202)
// and _splash_attention (:243), where the ViT computes in f32
// (RefineConfig.dino_dtype or PriorConfig.dino_dtype "float32"): both run at
// the ViT's compute dtype there.  The bf16 kernels stay in their own source.
//
// What bounds it on this card: operations.  At the main path's shape (B 8,
// H 12, N 1370) the forward's two products are 4.6e10 operations against
// 2.7e8 bytes of q, k, v, o and lse (0.08 ms at 3.35 TB/s).  On the CUDA
// cores (67 TFLOP/s) those products alone take 0.69 ms; the tensor cores take
// f32 only as TF32, whose 10-bit mantissa cannot hold the f32 result within
// 1e-5.  So every product here runs on the tensor cores as 3xTF32: each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, ties away from zero: cvt.rna.tf32.f32, written as two integer
// operations), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi, each a
// wgmma with f32 accumulators in registers, the small terms first; lo lo is
// dropped (below 2^-21 of the product).  Three TF32 products run at 495 / 3
// = 165 TFLOP/s, so the forward's bound is 0.28 ms and the backward's
// (5 products) 0.70 ms at the main path's shape.
//
// Layout is what makes it hard: wgmma takes 32-bit (TF32) operands from
// shared memory only K-major (the contraction axis contiguous; there is no
// transpose bit), and the register A operand of m64nNk8 holds, per thread,
// columns t and t + 4 (t = lane % 4) of an 8-column step where the
// accumulator holds columns 2t and 2t + 1.  So:
// - every staged tile is written by the threads that split it (global loads
//   of 16-byte pieces, split in registers, stored as hi and lo parts) in the
//   layout its product wants, without swizzle: 8 x 16-byte core matrices,
//   each 128 contiguous bytes, 8-row groups 128 bytes apart (SBO) and the
//   4-value columns of the contraction a whole group-column apart (LBO).
//   "Row tiles" keep a token's 64 values along the contraction (q, k, v, dO
//   in S = Q K^T, dP = dO V^T and their transposes); "column tiles" hold
//   the transpose, the 64 values as rows and the tokens along the
//   contraction (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q).
// - P and dS leave the accumulators as register A operands unmoved: a
//   step's register t holds token 2t and register t + 4 token 2t + 1, and
//   the column tiles store the tokens of each group of 8 in that order
//   (2t at position t, 2t + 1 at t + 4), so both sides of the contraction
//   agree.
// Shared memory: forward 128 KB (Q of 128 rows, a 64-key step of K and V),
// dQ 176 KB (Q and dO of 128 rows; a 32-key step of K, K^T and V), dK/dV
// 192 KB (K and V of 128 keys; a 32-query step of Q, Q^T, dO and dO^T).
//
// Design, for each of the three tiled kernels: a block of two warpgroups,
// 64 rows each (queries in the forward and dQ, keys in dK/dV).  Each step all
// 256 threads split the step's tiles into shared memory, then load the next
// step's 16-byte pieces into registers, behind the products of this one.
//   Forward: per 64-key step S = Q K^T (m64n64k8), the online softmax on
//     the accumulators, O += P V (m64n64k8).
//   dQ: per 32-key step S = Q K^T and dP = dO V^T (m64n32k8), P = exp(S -
//     lse), dS = P (dP - delta), dQ += dS K (m64n64k8).
//   dK/dV: per 32-query step S^T = K Q^T and dP^T = V dO^T (m64n32k8),
//     dV += P^T dO and dK += dS^T Q (m64n64k8).
// The backward is two passes without atomics, as in the bf16 kernels, so it
// is the same from run to run; delta = rowsum(dO * O) is its own small pass.
//   Fused backward (K5c, DinoConfig.splash_fused_bwd; the TPU kernel is
//   splash's _splash_attention_bwd_dkv with use_fused_bwd_kernel): the
//   dK/dV kernel that also writes, for its 128 keys, the partial
//   dQ_kb = dS_kb K_kb * scale of every query into a buffer of ceil(N / 128)
//   partials (summed outside).  32-bit operands come from shared memory
//   K-major only, and a column tile of the block's K (64 KB of hi and lo
//   parts) does not fit beside the 192 KB above, so each warpgroup computes
//   dQ_w^T = K_w^T dS_w^T (m64n32k8, the head dim as M): K_w^T as register A
//   operands read from K's row tile, dS^T (hi and lo) stored as a row tile
//   of the step's 32 queries with the block's 128 keys along the
//   contraction (32 KB more: 224 KB in all).  Warpgroup 1 hands its
//   product to warpgroup 0 through its own half of that tile, and warpgroup
//   0 adds, scales and stores.  Bound at (8, 12, 1370, 64): five products as
//   3xTF32, 0.70 ms, against 5.7e8 bytes read and written (3.7e8 of them the
//   11 partials), 0.17 ms at 3.35 TB/s.  What holds it back: the products
//   and the block barriers around the hand-off; it is one block an SM (224
//   KB).  Summing dQ across a thread-block cluster of key blocks on chip (3
//   partials instead of 11) was measured slower on an H100, 2.36-3.36 ms
//   for clusters of 1-6 against this kernel's 2.0: an H100 holds 30
//   clusters of 4 of it (120 of 132 SMs), 17 of 6.
//
// Arithmetic, as ops/flash_attention's plain versions in f32: s = (q . k) *
// scale, p = exp(s - m) with the accurate expf, the output divided by the row
// sum at the end, lse = m + log(l); the backward recomputes p from lse, and
// dQ and dK are scaled once at the end.  The sums run in another order than
// the plain version's matrix products.
//
// The true token count N masks the ragged edge: tiles are loaded with zeros
// at rows >= N, their scores are -inf in the forward and their
// probabilities 0 in the backward; rows >= N are not stored.
//
// Layout: q, k, v, dO, o, dq, dk, dv are (B, H, N, 64) views given by their
// batch, head and token strides in elements; the innermost 64 values are
// contiguous, the base 16-byte aligned and every stride a multiple of 4
// elements (kernels.tma_layout checks it), so every global access is a
// 16-byte load or an 8-byte store.  lse and delta are contiguous (B, H, N)
// f32.  Each entry point returns a cudaError_t: that of opening the kernel's
// shared memory, or cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int HD = 64;            // head dim
constexpr int PIECES = HD / 4;    // 16-byte pieces of a row
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 2 * WG;
constexpr int BM = 128;           // rows of a block: queries (fwd, dq), keys (dkv)
constexpr int HALF = BM / 2;      // rows of a warpgroup
constexpr int BN = 64;            // keys of a forward step
constexpr int BK = 32;            // keys of a dQ step, queries of a dK/dV step

// Bytes of one part (hi or lo) of a tile of `rows` rows of 64 values.
__host__ __device__ constexpr int part_bytes(int rows) { return rows * HD * 4; }

constexpr int SMEM_FWD = 2 * part_bytes(BM) + 4 * part_bytes(BN);
constexpr int SMEM_DQ = 4 * part_bytes(BM) + 6 * part_bytes(BK);
constexpr int SMEM_DKV = 4 * part_bytes(BM) + 8 * part_bytes(BK) + 2 * BK * 4;
// The fused backward: the dK/dV kernel's and dS^T, a row tile of BK queries
// with the block's BM keys along the contraction, hi and lo.
constexpr int DS_BYTES = BK * BM * 4;
constexpr int SMEM_FUSED = SMEM_DKV + 2 * DS_BYTES;

// ---------------------------------------------------------------------------
// Splitting, staging and wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest, ties away
// from zero (the carry of half a unit of the 13 dropped bits, then the
// mask), in the f32 bit pattern with the low 13 bits clear.
__device__ __forceinline__ float tf32(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x = hi + lo + (below 2^-21 of x): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
    hi = tf32(x);
    lo = tf32(x - hi);
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
    float4 hi;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    return hi;
}

// The 16-byte piece i of a thread in a tile of R rows: lanes 0-7 of a warp
// take 8 consecutive rows, the four groups of 8 lanes four consecutive
// pieces, so a warp reads 64 contiguous bytes of each of 8 rows and a
// quarter warp writes one 128-byte core matrix.
template <int R>
__device__ __forceinline__ void piece(int i, int& r, int& c) {
    const int w = (threadIdx.x >> 5) + (THREADS / 32) * i, lane = threadIdx.x & 31;
    r = (w % (R / 8)) * 8 + (lane & 7);
    c = (w / (R / 8)) * 4 + (lane >> 3);
}

template <int R>
using Pieces = float4[R * PIECES / THREADS];

// Loads rows [row0, row0 + R) of one head of a (B, H, N, 64) view (zeros at
// rows >= N) into the thread's pieces.
template <int R>
__device__ __forceinline__ void load_rows(Pieces<R>& v, const float* src, i64 sn, int row0, int N) {
#pragma unroll
    for (int i = 0; i < R * PIECES / THREADS; ++i) {
        int r, c;
        piece<R>(i, r, c);
        v[i] = row0 + r < N ? *reinterpret_cast<const float4*>(src + (i64)(row0 + r) * sn + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// A row tile: row r's 64 values along the contraction.  Element (r, d) of a
// tile of T <= 64 rows lies at (d / 4) T 16 + (r / 8) 128 + (r % 8) 16 +
// (d % 4) 4 bytes (LBO T 16, SBO 128); a tile of 128 rows is two tiles of
// 64, one per warpgroup.
template <int R>
__device__ __forceinline__ void store_rows(unsigned char* hi, unsigned char* lo,
                                           const Pieces<R>& v) {
    constexpr int T = R > HALF ? HALF : R;
#pragma unroll
    for (int i = 0; i < R * PIECES / THREADS; ++i) {
        int r, c;
        piece<R>(i, r, c);
        const int off = (r / T) * part_bytes(T) + c * T * 16 + ((r % T) >> 3) * 128 + (r & 7) * 16;
        float4 l;
        const float4 h = split4(v[i], l);
        *reinterpret_cast<float4*>(hi + off) = h;
        *reinterpret_cast<float4*>(lo + off) = l;
    }
}

// A column tile of R tokens: the 64 values as rows, the tokens along the
// contraction, token 8 g + 2 t at position 8 g + t and 8 g + 2 t + 1 at
// 8 g + t + 4 (the register A operand's order, see above).  Element
// (d, position p) lies at (p / 4) 1024 + (d / 8) 128 + (d % 8) 16 + (p % 4) 4
// bytes (LBO 1024, SBO 128).
template <int R>
__device__ __forceinline__ void store_cols(unsigned char* hi, unsigned char* lo,
                                           const Pieces<R>& v) {
#pragma unroll
    for (int i = 0; i < R * PIECES / THREADS; ++i) {
        int r, c;
        piece<R>(i, r, c);
        const int p = (r & ~7) | ((r & 1) ? 4 + ((r & 7) >> 1) : ((r & 7) >> 1));
        const int base = (p >> 2) * 1024 + (c >> 1) * 128 + (c & 1) * 64 + (p & 3) * 4;
        float4 l;
        const float4 h = split4(v[i], l);
        const float hv[4] = {h.x, h.y, h.z, h.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            *reinterpret_cast<float*>(hi + base + e * 16) = hv[e];
            *reinterpret_cast<float*>(lo + base + e * 16) = lv[e];
        }
    }
}

// Makes this thread's shared-memory stores visible to wgmma (the async
// proxy); a barrier after it makes everyone's visible.
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's operand descriptor of a tile without swizzle: start address,
// leading byte offset (between the core matrices of the contraction) and
// stride byte offset 128 (between 8-row groups), both in 16-byte units.
__device__ __forceinline__ uint64_t desc(const void* tile, int lbo) {
    return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(128 >> 4) << 32);
}

// Descriptor step to the next 8 values of the contraction (two core-matrix
// columns): of a row tile of T rows, and of a column tile.
__host__ __device__ constexpr uint64_t k8_rows(int T) { return (uint64_t)(2 * T * 16) >> 4; }
constexpr uint64_t K8_COLS = 2048 >> 4;

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait that
// makes it valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator of an m64nN wgmma, per thread of the warpgroup: for each
// 8-column group j, d[4j], d[4j+1] at row r0 = 16 warp + lane / 4 and columns
// 8j + c0, 8j + c0 + 1 (c0 = 2 (lane % 4)); d[4j+2], d[4j+3] at row r0 + 8.
// The register A operand of m64nNk8 (TF32): a0 (r0, t), a1 (r0 + 8, t),
// a2 (r0, t + 4), a3 (r0 + 8, t + 4), t = lane % 4.

// D (64 x 64) += A (64 x 8, shared) B (64 x 8, shared), TF32.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 32) += A (64 x 8, shared) B (32 x 8, shared), TF32.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64) += A (64 x 8, TF32 in registers) B (64 x 8, shared).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], float a0, float a1, float a2, float a3,
                                           uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
          "r"(__float_as_uint(a3)), "l"(b), "r"(acc));
}

// D (64 x 32) += A (64 x 8, TF32 in registers) B (32 x 8, shared).
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], float a0, float a1, float a2, float a3,
                                           uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
          "r"(__float_as_uint(a3)), "l"(b), "r"(acc));
}

// One 8-deep step of an f32 product with both operands in shared memory, as
// three TF32 products, small terms first; `first` overwrites d.
__device__ __forceinline__ void mma3_ss_n64(float (&d)[32], uint64_t ah, uint64_t al, uint64_t bh,
                                            uint64_t bl, bool first) {
    mma_ss_n64(d, al, bh, first ? 0 : 1);
    mma_ss_n64(d, ah, bl, 1);
    mma_ss_n64(d, ah, bh, 1);
}

__device__ __forceinline__ void mma3_ss_n32(float (&d)[16], uint64_t ah, uint64_t al, uint64_t bh,
                                            uint64_t bl, bool first) {
    mma_ss_n32(d, al, bh, first ? 0 : 1);
    mma_ss_n32(d, ah, bl, 1);
    mma_ss_n32(d, ah, bh, 1);
}

// d += x y over 8-column step j of an accumulator-layout x (hi and lo parts
// in registers) and a column tile y (descriptors of its two parts at step
// 0); `first` overwrites d.
template <int N>
__device__ __forceinline__ void mma3_rs_n64(float (&d)[32], const float (&xh)[N],
                                            const float (&xl)[N], int j, uint64_t yh,
                                            uint64_t yl, bool first) {
    const uint64_t s = j * K8_COLS;
    mma_rs_n64(d, xl[4 * j], xl[4 * j + 2], xl[4 * j + 1], xl[4 * j + 3], yh + s, first ? 0 : 1);
    mma_rs_n64(d, xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3], yl + s, 1);
    mma_rs_n64(d, xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3], yh + s, 1);
}

template <int N>
__device__ __forceinline__ void split_all(float (&x)[N], float (&lo)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float h;
        split(x[i], h, lo[i]);
        x[i] = h;
    }
}

// Opens a kernel's shared memory, once per kernel and device.
constexpr int MAX_DEVICES = 64;

int prepare(const void* kernel, int smem, int (&done)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES && done[dev]) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) done[dev] = 1;
    return 0;
}

int fwd_ready[MAX_DEVICES], dkv_ready[MAX_DEVICES], dq_ready[MAX_DEVICES],
    fused_ready[MAX_DEVICES];

// ---------------------------------------------------------------------------
// Kernels.
// ---------------------------------------------------------------------------

// Forward: a block per (128 query rows, head, batch); a loop over 64-key
// steps.  Warpgroup w holds query rows [64 w, 64 w + 64) of the block.
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int N, float scale, i64 qsb, i64 qsh,
    i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn, i64 osb, i64 osh, i64 osn) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* sQh = smem;
    unsigned char* sQl = sQh + part_bytes(BM);
    unsigned char* sKh = sQl + part_bytes(BM);  // row tile of BN keys
    unsigned char* sKl = sKh + part_bytes(BN);
    unsigned char* sVh = sKl + part_bytes(BN);  // column tile of BN keys
    unsigned char* sVl = sVh + part_bytes(BN);

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const float* kb = k + b * ksb + h * ksh;
    const float* vb = v + b * vsb + h * vsh;
    const int steps = (N + BN - 1) / BN;
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG, lane = t & 31;
    const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);

    {
        Pieces<BM> qv;
        load_rows<BM>(qv, q + b * qsb + h * qsh, qsn, q0, N);
        store_rows<BM>(sQh, sQl, qv);
    }
    Pieces<BN> kv, vv;
    load_rows<BN>(kv, kb, ksn, 0, N);
    load_rows<BN>(vv, vb, vsn, 0, N);
    const uint64_t qh = desc(sQh + wg * part_bytes(HALF), HALF * 16);
    const uint64_t ql = desc(sQl + wg * part_bytes(HALF), HALF * 16);
    const uint64_t kh = desc(sKh, BN * 16), kl = desc(sKl, BN * 16);
    const uint64_t vh = desc(sVh, 1024), vl = desc(sVl, 1024);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    // Running maxima and sums of rows r0 and r0 + 8.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    for (int it = 0; it < steps; ++it) {
        __syncthreads();  // both warpgroups' products of the step before are done
        store_rows<BN>(sKh, sKl, kv);
        store_cols<BN>(sVh, sVl, vv);
        fence_async_shared();
        __syncthreads();
        if (it + 1 < steps) {
            load_rows<BN>(kv, kb, ksn, (it + 1) * BN, N);
            load_rows<BN>(vv, vb, vsn, (it + 1) * BN, N);
        }
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            mma3_ss_n64(sc, qh + kk * k8_rows(HALF), ql + kk * k8_rows(HALF),
                        kh + kk * k8_rows(BN), kl + kk * k8_rows(BN), kk == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        const int k0 = it * BN;
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool ok = k0 + 8 * j + c0 + e < N;
                sc[4 * j + e] = ok ? sc[4 * j + e] * scale : -INFINITY;
                sc[4 * j + 2 + e] = ok ? sc[4 * j + 2 + e] * scale : -INFINITY;
                x0 = fmaxf(x0, sc[4 * j + e]);
                x1 = fmaxf(x1, sc[4 * j + 2 + e]);
            }
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
            x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
            x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
        }
        // Every step holds a valid key, so the new maxima are finite.
        const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
        const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 at the first step
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[4 * j + e] = expf(sc[4 * j + e] - n0);
                sc[4 * j + 2 + e] = expf(sc[4 * j + 2 + e] - n1);
                sum0 += sc[4 * j + e];
                sum1 += sc[4 * j + 2 + e];
            }
#pragma unroll
        for (int w = 1; w <= 2; w <<= 1) {
            sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
            sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
        }
        l0 = l0 * a0 + sum0;
        l1 = l1 * a1 + sum1;
        m0 = n0;
        m1 = n1;
        float pl[32], pv[32];
        split_all(sc, pl);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 8; ++j) mma3_rs_n64(pv, sc, pl, j, vh, vl, j == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(pv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            acc[4 * j] = acc[4 * j] * a0 + pv[4 * j];
            acc[4 * j + 1] = acc[4 * j + 1] * a0 + pv[4 * j + 1];
            acc[4 * j + 2] = acc[4 * j + 2] * a1 + pv[4 * j + 2];
            acc[4 * j + 3] = acc[4 * j + 3] * a1 + pv[4 * j + 3];
        }
    }
    const int row0 = q0 + wg * HALF + r0, row1 = row0 + 8;
    o += b * osb + h * osh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (row0 < N)
            *reinterpret_cast<float2*>(o + row0 * osn + 8 * j + c0) =
                make_float2(acc[4 * j] / l0, acc[4 * j + 1] / l0);
        if (row1 < N)
            *reinterpret_cast<float2*>(o + row1 * osn + 8 * j + c0) =
                make_float2(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
    }
    if ((lane & 3) == 0) {
        float* out = lse + ((i64)b * H + h) * N;
        if (row0 < N) out[row0] = m0 + logf(l0);
        if (row1 < N) out[row1] = m1 + logf(l1);
    }
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
        const float4 a = *reinterpret_cast<const float4*>(o + b * osb + h * osh + n * osn + 4 * part);
        const float4 g =
            *reinterpret_cast<const float4*>(d_o + b * dsb + h * dsh + n * dsn + 4 * part);
        sum = fmaf(a.x, g.x, sum);
        sum = fmaf(a.y, g.y, sum);
        sum = fmaf(a.z, g.z, sum);
        sum = fmaf(a.w, g.w, sum);
    }
#pragma unroll
    for (int w = 1; w < PIECES; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (row < rows && part == 0) delta[row] = sum;
}

// dK and dV: a block per (128 keys, head, batch); a loop over 32-query
// steps (q, dO, and the rows' lse and delta).  Warpgroup w holds keys
// [64 w, 64 w + 64) of the block and works on the transposed tiles S^T,
// P^T, dS^T (keys x queries).  FUSED (the fused backward) also writes the
// block's dQ partial of each step's queries to dqp (partial blockIdx.x,
// strides psb, psh, psn; pskb between partials).
template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dqp, int H, int N,
    float scale, i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh, i64 ksn, i64 vsb, i64 vsh, i64 vsn,
    i64 gsb, i64 gsh, i64 gsn, i64 dksb, i64 dksh, i64 dksn, i64 dvsb, i64 dvsh, i64 dvsn,
    i64 psb, i64 psh, i64 psn, i64 pskb) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* sKh = smem;  // row tiles of the block's keys
    unsigned char* sKl = sKh + part_bytes(BM);
    unsigned char* sVh = sKl + part_bytes(BM);
    unsigned char* sVl = sVh + part_bytes(BM);
    unsigned char* sQh = sVl + part_bytes(BM);  // row tile of the step's queries
    unsigned char* sQl = sQh + part_bytes(BK);
    unsigned char* sQTh = sQl + part_bytes(BK);  // column tile of them
    unsigned char* sQTl = sQTh + part_bytes(BK);
    unsigned char* sGh = sQTl + part_bytes(BK);  // dO, row tile
    unsigned char* sGl = sGh + part_bytes(BK);
    unsigned char* sGTh = sGl + part_bytes(BK);  // dO, column tile
    unsigned char* sGTl = sGTh + part_bytes(BK);
    float* sL = reinterpret_cast<float*>(sGTl + part_bytes(BK));  // lse
    float* sD = sL + BK;                                           // delta
    // FUSED: dS^T as a row tile of the step's queries, the block's keys along
    // the contraction: (query r, key c) at (c / 4) BK 16 + (r / 8) 128 +
    // (r % 8) 16 + (c % 4) 4, so warpgroup w's keys start DS_BYTES / 2 w on.
    unsigned char* sSh = reinterpret_cast<unsigned char*>(sD + BK);
    unsigned char* sSl = sSh + DS_BYTES;

    const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const float* qb = q + b * qsb + h * qsh;
    const float* gb = d_o + b * gsb + h * gsh;
    const float* lse_bh = lse + ((i64)b * H + h) * N;
    const float* delta_bh = delta + ((i64)b * H + h) * N;
    const int steps = (N + BK - 1) / BK;
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG, lane = t & 31;
    const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);

    {
        Pieces<BM> kv;
        load_rows<BM>(kv, k + b * ksb + h * ksh, ksn, k0, N);
        store_rows<BM>(sKh, sKl, kv);
        load_rows<BM>(kv, v + b * vsb + h * vsh, vsn, k0, N);
        store_rows<BM>(sVh, sVl, kv);
    }
    Pieces<BK> qv, gv;
    load_rows<BK>(qv, qb, qsn, 0, N);
    load_rows<BK>(gv, gb, gsn, 0, N);
    float l_next = 0.0f, d_next = 0.0f;  // thread < BK: query threadIdx.x of the next step
    if (threadIdx.x < BK && (int)threadIdx.x < N) {
        l_next = lse_bh[threadIdx.x];
        d_next = delta_bh[threadIdx.x];
    }
    const uint64_t kah = desc(sKh + wg * part_bytes(HALF), HALF * 16);
    const uint64_t kal = desc(sKl + wg * part_bytes(HALF), HALF * 16);
    const uint64_t vah = desc(sVh + wg * part_bytes(HALF), HALF * 16);
    const uint64_t val = desc(sVl + wg * part_bytes(HALF), HALF * 16);
    const uint64_t qh = desc(sQh, BK * 16), ql = desc(sQl, BK * 16);
    const uint64_t gh = desc(sGh, BK * 16), gl = desc(sGl, BK * 16);
    const uint64_t qth = desc(sQTh, 1024), qtl = desc(sQTl, 1024);
    const uint64_t gth = desc(sGTh, 1024), gtl = desc(sGTl, 1024);

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    for (int it = 0; it < steps; ++it) {
        const int q0 = it * BK;
        __syncthreads();
        store_rows<BK>(sQh, sQl, qv);
        store_cols<BK>(sQTh, sQTl, qv);
        store_rows<BK>(sGh, sGl, gv);
        store_cols<BK>(sGTh, sGTl, gv);
        if (threadIdx.x < BK) {
            sL[threadIdx.x] = l_next;
            sD[threadIdx.x] = d_next;
        }
        fence_async_shared();
        __syncthreads();
        if (it + 1 < steps) {
            load_rows<BK>(qv, qb, qsn, q0 + BK, N);
            load_rows<BK>(gv, gb, gsn, q0 + BK, N);
            const int qn = q0 + BK + threadIdx.x;
            if (threadIdx.x < BK && qn < N) {
                l_next = lse_bh[qn];
                d_next = delta_bh[qn];
            }
        }
        float st[16], dpt[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            mma3_ss_n32(st, kah + kk * k8_rows(HALF), kal + kk * k8_rows(HALF),
                        qh + kk * k8_rows(BK), ql + kk * k8_rows(BK), kk == 0);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            mma3_ss_n32(dpt, vah + kk * k8_rows(HALF), val + kk * k8_rows(HALF),
                        gh + kk * k8_rows(BK), gl + kk * k8_rows(BK), kk == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(st);
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + c0 + e;  // a query of the step
                const bool ok = q0 + c < N;
                const float L = sL[c], D = sD[c];
                const float p0 = ok ? expf(st[4 * j + e] * scale - L) : 0.0f;
                const float p1 = ok ? expf(st[4 * j + 2 + e] * scale - L) : 0.0f;
                st[4 * j + e] = p0;
                st[4 * j + 2 + e] = p1;
                dpt[4 * j + e] = p0 * (dpt[4 * j + e] - D);
                dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - D);
            }
        float pl[16], sl[16], part[32];
        split_all(st, pl);
        split_all(dpt, sl);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) mma3_rs_n64(part, st, pl, j, gth, gtl, j == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) dv_acc[i] += part[i];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) mma3_rs_n64(part, dpt, sl, j, qth, qtl, j == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) dk_acc[i] += part[i];
        if constexpr (FUSED) {
            // dS^T (hi in dpt, lo in sl; keys >= N as 0) to the row tile.
            const int kr = wg * HALF + r0;  // the thread's keys kr and kr + 8 of the block
            const bool ok0 = k0 + kr < N, ok1 = k0 + kr + 8 < N;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int qq = 8 * j + c0 + e;
                    const int off = (kr >> 2) * BK * 16 + (qq >> 3) * 128 + (qq & 7) * 16 +
                                    (kr & 3) * 4;
                    const int off8 = off + 2 * BK * 16;  // key kr + 8
                    *reinterpret_cast<float*>(sSh + off) = ok0 ? dpt[4 * j + e] : 0.0f;
                    *reinterpret_cast<float*>(sSl + off) = ok0 ? sl[4 * j + e] : 0.0f;
                    *reinterpret_cast<float*>(sSh + off8) = ok1 ? dpt[4 * j + 2 + e] : 0.0f;
                    *reinterpret_cast<float*>(sSl + off8) = ok1 ? sl[4 * j + 2 + e] : 0.0f;
                }
            fence_async_shared();
            __syncthreads();
            // dQ_w^T (64 head-dim rows x 32 queries) = K_w^T dS_w^T: step j's
            // A operand is K_w^T's (d, key 8 j + t) for d = r0, r0 + 8 and
            // t = lane % 4, lane % 4 + 4, read from K's row tile, whose
            // (key r, d) lies at (d / 4) 1024 + (r / 8) 128 + (r % 8) 16 +
            // (d % 4) 4 in the warpgroup's half.
            const unsigned char* kth = sKh + wg * part_bytes(HALF);
            const unsigned char* ktl = sKl + wg * part_bytes(HALF);
            const int ta = lane & 3;
            float ah[8][4], al[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int key = 8 * j + ta + 4 * (u >> 1), d = r0 + 8 * (u & 1);
                    const int off = (d >> 2) * 1024 + (key >> 3) * 128 + (key & 7) * 16 + (d & 3) * 4;
                    ah[j][u] = *reinterpret_cast<const float*>(kth + off);
                    al[j][u] = *reinterpret_cast<const float*>(ktl + off);
                }
            const uint64_t sh = desc(sSh + wg * (DS_BYTES / 2), BK * 16);
            const uint64_t slo = desc(sSl + wg * (DS_BYTES / 2), BK * 16);
            float dqt[16];
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const uint64_t st8 = j * k8_rows(BK);
                mma_rs_n32(dqt, al[j][0], al[j][1], al[j][2], al[j][3], sh + st8, j == 0 ? 0 : 1);
                mma_rs_n32(dqt, ah[j][0], ah[j][1], ah[j][2], ah[j][3], slo + st8, 1);
                mma_rs_n32(dqt, ah[j][0], ah[j][1], ah[j][2], ah[j][3], sh + st8, 1);
            }
            wgmma_commit();
            wgmma_wait0();
            fence_regs(dqt);
            // Warpgroup 1's product, through its own half of sSh (which only
            // it reads), to warpgroup 0, which adds, scales and stores:
            // dqt[4 j + e] is (d r0, query 8 j + c0 + e), dqt[4 j + 2 + e]
            // (d r0 + 8, the same query).
            float* sX = reinterpret_cast<float*>(sSh + DS_BYTES / 2);
            if (wg == 1) {
#pragma unroll
                for (int i = 0; i < 16; ++i) sX[i * WG + t] = dqt[i];
            }
            __syncthreads();
            if (wg == 0) {
                float* out = dqp + blockIdx.x * pskb + b * psb + h * psh;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = q0 + 8 * j + c0 + e;
                        if (row < N) {
                            out[row * psn + r0] = (dqt[4 * j + e] + sX[(4 * j + e) * WG + t]) * scale;
                            out[row * psn + r0 + 8] =
                                (dqt[4 * j + 2 + e] + sX[(4 * j + 2 + e) * WG + t]) * scale;
                        }
                    }
            }
        }
    }
    const int row0 = k0 + wg * HALF + r0, row1 = row0 + 8;
    dk += b * dksb + h * dksh;
    dv += b * dvsb + h * dvsh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (row0 < N) {
            *reinterpret_cast<float2*>(dk + row0 * dksn + 8 * j + c0) =
                make_float2(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
            *reinterpret_cast<float2*>(dv + row0 * dvsn + 8 * j + c0) =
                make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
        }
        if (row1 < N) {
            *reinterpret_cast<float2*>(dk + row1 * dksn + 8 * j + c0) =
                make_float2(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
            *reinterpret_cast<float2*>(dv + row1 * dvsn + 8 * j + c0) =
                make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
        }
    }
}

// dQ: a block per (128 query rows, head, batch); a loop over 32-key steps.
// Warpgroup w holds query rows [64 w, 64 w + 64) of the block.
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int N, float scale, i64 qsb, i64 qsh, i64 qsn, i64 ksb, i64 ksh,
    i64 ksn, i64 vsb, i64 vsh, i64 vsn, i64 gsb, i64 gsh, i64 gsn, i64 dqsb, i64 dqsh, i64 dqsn) {
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* sQh = smem;  // row tiles of the block's queries and their dO
    unsigned char* sQl = sQh + part_bytes(BM);
    unsigned char* sGh = sQl + part_bytes(BM);
    unsigned char* sGl = sGh + part_bytes(BM);
    unsigned char* sKh = sGl + part_bytes(BM);  // row tile of the step's keys
    unsigned char* sKl = sKh + part_bytes(BK);
    unsigned char* sKTh = sKl + part_bytes(BK);  // column tile of them
    unsigned char* sKTl = sKTh + part_bytes(BK);
    unsigned char* sVh = sKTl + part_bytes(BK);  // row tile of the step's values
    unsigned char* sVl = sVh + part_bytes(BK);

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const float* kb = k + b * ksb + h * ksh;
    const float* vb = v + b * vsb + h * vsh;
    const int steps = (N + BK - 1) / BK;
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG, lane = t & 31;
    const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
    const int row0 = q0 + wg * HALF + r0, row1 = row0 + 8;
    const i64 bh = (i64)b * H + h;
    const float lse0 = row0 < N ? lse[bh * N + row0] : 0.0f;
    const float lse1 = row1 < N ? lse[bh * N + row1] : 0.0f;
    const float dl0 = row0 < N ? delta[bh * N + row0] : 0.0f;
    const float dl1 = row1 < N ? delta[bh * N + row1] : 0.0f;

    {
        Pieces<BM> x;
        load_rows<BM>(x, q + b * qsb + h * qsh, qsn, q0, N);
        store_rows<BM>(sQh, sQl, x);
        load_rows<BM>(x, d_o + b * gsb + h * gsh, gsn, q0, N);
        store_rows<BM>(sGh, sGl, x);
    }
    Pieces<BK> kv, vv;
    load_rows<BK>(kv, kb, ksn, 0, N);
    load_rows<BK>(vv, vb, vsn, 0, N);
    const uint64_t qah = desc(sQh + wg * part_bytes(HALF), HALF * 16);
    const uint64_t qal = desc(sQl + wg * part_bytes(HALF), HALF * 16);
    const uint64_t gah = desc(sGh + wg * part_bytes(HALF), HALF * 16);
    const uint64_t gal = desc(sGl + wg * part_bytes(HALF), HALF * 16);
    const uint64_t kh = desc(sKh, BK * 16), kl = desc(sKl, BK * 16);
    const uint64_t vh = desc(sVh, BK * 16), vl = desc(sVl, BK * 16);
    const uint64_t kth = desc(sKTh, 1024), ktl = desc(sKTl, 1024);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int it = 0; it < steps; ++it) {
        const int k0 = it * BK;
        __syncthreads();
        store_rows<BK>(sKh, sKl, kv);
        store_cols<BK>(sKTh, sKTl, kv);
        store_rows<BK>(sVh, sVl, vv);
        fence_async_shared();
        __syncthreads();
        if (it + 1 < steps) {
            load_rows<BK>(kv, kb, ksn, k0 + BK, N);
            load_rows<BK>(vv, vb, vsn, k0 + BK, N);
        }
        float sc[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            mma3_ss_n32(sc, qah + kk * k8_rows(HALF), qal + kk * k8_rows(HALF),
                        kh + kk * k8_rows(BK), kl + kk * k8_rows(BK), kk == 0);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
            mma3_ss_n32(dp, gah + kk * k8_rows(HALF), gal + kk * k8_rows(HALF),
                        vh + kk * k8_rows(BK), vl + kk * k8_rows(BK), kk == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool ok = k0 + 8 * j + c0 + e < N;  // a key of the step
                const float p0 = ok ? expf(sc[4 * j + e] * scale - lse0) : 0.0f;
                const float p1 = ok ? expf(sc[4 * j + 2 + e] * scale - lse1) : 0.0f;
                dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0);
                dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1);
            }
        float sl[16], part[32];
        split_all(dp, sl);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) mma3_rs_n64(part, dp, sl, j, kth, ktl, j == 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
    dq += b * dqsb + h * dqsh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (row0 < N)
            *reinterpret_cast<float2*>(dq + row0 * dqsn + 8 * j + c0) =
                make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        if (row1 < N)
            *reinterpret_cast<float2*>(dq + row1 * dqsn + 8 * j + c0) =
                make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
}

dim3 row_grid(int B, int H, int N) { return dim3((N + BM - 1) / BM, H, B); }

}  // namespace

// Strides arrive as one array of 64-bit element counts, (batch, head, token)
// per tensor in the order of the tensor arguments.

extern "C" int dynhor_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int H, int N, float sm_scale,
                                    const long long* st, void* stream) {
    const int err = prepare((const void*)flash_fwd_f32_kernel, SMEM_FWD, fwd_ready);
    if (err) return err;
    flash_fwd_f32_kernel<<<row_grid(B, H, N), THREADS, SMEM_FWD, (cudaStream_t)stream>>>(
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
    const int err = prepare((const void*)flash_bwd_dkv_f32_kernel<false>, SMEM_DKV, dkv_ready);
    if (err) return err;
    flash_bwd_dkv_f32_kernel<false><<<row_grid(B, H, N), THREADS, SMEM_DKV,
                                      (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, nullptr, H, N, sm_scale, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
        st[15], st[16], st[17], 0, 0, 0, 0);
    return (int)cudaGetLastError();
}

// The fused backward: dk, dv and dq_part, a (ceil(N / 128), B, H, N, 64)
// buffer of partials; st holds q, k, v, d_o, dk, dv, then the strides of
// one partial and, last, the stride between partials.
extern "C" int dynhor_flash_bwd_fused_f32(const void* q, const void* k, const void* v,
                                          const void* d_o, const void* lse, const void* delta,
                                          void* dq_part, void* dk, void* dv, int B, int H, int N,
                                          float sm_scale, const long long* st, void* stream) {
    const int err = prepare((const void*)flash_bwd_dkv_f32_kernel<true>, SMEM_FUSED, fused_ready);
    if (err) return err;
    flash_bwd_dkv_f32_kernel<true><<<row_grid(B, H, N), THREADS, SMEM_FUSED,
                                     (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, (float*)dq_part, H, N, sm_scale, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
        st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20], st[21]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                       const void* d_o, const void* lse, const void* delta,
                                       void* dq, int B, int H, int N, float sm_scale,
                                       const long long* st, void* stream) {
    const int err = prepare((const void*)flash_bwd_dq_f32_kernel, SMEM_DQ, dq_ready);
    if (err) return err;
    flash_bwd_dq_f32_kernel<<<row_grid(B, H, N), THREADS, SMEM_DQ, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, (const float*)lse,
        (const float*)delta, (float*)dq, H, N, sm_scale, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}
