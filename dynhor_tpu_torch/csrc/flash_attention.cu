// Flash attention for Hopper (sm_90a): forward and backward, bf16, head dim 64.
//
// Replaces both TPU attention kernels of dynhor_tpu/models/dino.py:
//   _flash_attention  (:202) -> jax.experimental.pallas.ops.tpu.flash_attention
//                               (forward, dq and dkv kernels under its custom VJP)
//   _splash_attention (:243) -> splash_attention_kernel.make_splash_mha
//                               (forward; dq + dkv, or with
//                               splash_fused_bwd (:288-293) the fused
//                               backward, _splash_attention_bwd_dkv with
//                               use_fused_bwd_kernel: flash_bwd_dkv_kernel<true>)
// Both compute softmax(Q K^T * scale) V over the valid tokens and differ only
// in TPU tiling and in how padded tokens are kept harmless, so one set of
// kernels is the counterpart of both.  Nothing is padded here: the kernels
// take the true token count N (keys >= N get probability 0, rows >= N are
// neither loaded nor stored).
//
// What bounds it on this card: operations.  One product of an (N, 64) by a
// (64, N) or an (N, N) by an (N, 64) matrix is 2 N^2 64 operations per
// (batch, head).  The forward needs 2 products (S = Q K^T, then P V), the
// backward as a function 5 (S, dP, dV, dK, dQ); the two passes below run 7,
// since each recomputes S and dP.  At the main path's shape (B 8, H 12,
// N 1370) that is 4.6e10 operations forward (0.047 ms at the tensor cores'
// 989 TFLOP/s) against 6.8e7 bytes of q, k, v, o and lse (0.020 ms at
// 3.35 TB/s), as long as the N x N tensors never reach device memory.
//
// Design, for each of the three tiled kernels:
// - one block of three warpgroups: warpgroup 0 produces (one thread issues
//   TMA loads; in dK/dV its first warp also stores the rows' lse and delta,
//   loaded a step ahead), warpgroups 1 and 2 consume, 64 rows each.
//   setmaxnreg moves registers from the producer (40) to the consumers (232).
// - TMA brings the tiles: one CUtensorMap per tensor describes its
//   (64, N, H, B) view by byte strides, so the strided q/k/v views of one
//   (B, N, 3, H, 64) projection are read in place; rows >= N are zero-filled
//   by the hardware.  A row of 64 bf16 is 128 bytes, so 128-byte swizzle is
//   the row's own layout and what wgmma reads without bank conflicts.
//   Streamed tiles go through a ring of STAGES stages with full and empty
//   mbarriers.
// - every product is a wgmma with f32 accumulators in registers.  The
//   softmax and dS = P (dP - delta) run on the accumulators where they are
//   (a row lies in one quad of threads); P and dS are rounded to bf16 in
//   registers and fed back as wgmma's register A operand.  Nothing of S, P,
//   dS or the outputs' accumulators goes through shared memory.
//   Forward: a block per 128 query rows loops over 128-key tiles:
//     S = Q K^T (m64n128, K stored keys x d is the K-major B operand),
//     online softmax, O += P V (m64n64, V is the MN-major B operand).  A
//     step issues the next tile's S behind P V of the tile before and runs
//     the softmax while P V is on the tensor cores; the two consumer
//     warpgroups take turns to issue (named barriers), so one's softmax
//     meets the other's products.
//   dK/dV: a block per 128 keys loops over 64-row query tiles (q, dO, and
//     the rows' lse and delta):  S^T = K Q^T, dP^T = V dO^T (m64n64),
//     dV += P^T dO, dK += dS^T Q (m64n64, the tiles as MN-major B).
//   dQ: a block per 128 query rows loops over 128-key tiles, each as two
//     halves of 64 keys: S = Q K^T, dP = dO V^T (m64n64), dQ += dS K
//     (m64n64, K as MN-major B), the first half's dQ behind the second
//     half's S and dP.  Whole 128-key scores would need 64 + 64 accumulator
//     registers beside dQ's 32 and spill.
// - the backward is two passes without atomics, so it is the same from run
//   to run; delta = rowsum(dO * O) is a small bytes-bound kernel before them.
// Fused backward (K5c, DinoConfig.splash_fused_bwd): the dK/dV kernel that
//   also writes, for its 128 keys, the partial dQ_kb = dS_kb K_kb * scale of
//   every query, rounded to bf16, into a buffer of ceil(N / 128) partials,
//   with no atomics; their sum in f32 (outside, as splash leaves it to XLA)
//   is dq.  Five products a step instead of the two passes' seven.  Each
//   consumer warpgroup stores its dS^T (its 64 keys x the step's 64 queries,
//   bf16) to shared memory in the 128-byte swizzle that TMA gives V, and
//   reads it back as wgmma's A operand through the descriptor's transpose
//   (16-bit A may be MN-major): dQ_w = dS_w K_w (m64n64, K MN-major).
//   Warpgroup 1 hands its f32 product to warpgroup 0 through shared memory
//   (two named barriers, one step of slack), which adds the two 64-key
//   halves, scales, rounds once and stores.  Bound at (8, 12, 1370, 64):
//   five products, 0.117 ms at 989 TFLOP/s, against 2.9e8 bytes read and
//   written (1.9e8 of them the partials), 0.086 ms at 3.35 TB/s.
//   What holds it back: the partials' bytes, 1.9e8 written here and read
//   again by their sum, which make the whole fused backward about 1.3 x
//   the two passes on an H100.  Summing dQ across a thread-block cluster
//   of key blocks in shared memory (3 partials instead of 11) was measured
//   slower, 0.46-0.68 ms for clusters of 1-6 against this kernel's 0.39:
//   one block fills an SM, so an H100 holds only 30 clusters of 4 (120 of
//   132 SMs) or 17 of 6, and the exchange itself cost 0.07 ms at clusters
//   of 1.  A block small enough for two an SM is untried.
// What still holds it back: the exponentials, and the waits between them
// and the products.  At head dim 64 a score costs 4 x 64 tensor-core
// operations forward and one 2^x on the special-function unit, whose 16
// results a clock per SM take as long as the products; the two overlap only
// across the warpgroups.  Streaming K and V costs no time: reading one tile
// again and again instead takes as long.  In the dK/dV pass a warpgroup
// waits for each of its products before it issues the next: with the next
// tile's S^T in flight beside dV and dK, ptxas runs out of registers and
// serializes the products.
//
// Arithmetic, as models/dino._attention rounds it: scores and exp in f32
// (2^x on scale * log2 e), the probabilities rounded to bf16 BEFORE the
// P V product, accumulation in f32, division by the f32 row sum at the end,
// lse in natural-log units.  The backward recomputes P from q, k and the
// saved row log-sum-exp:
//   delta = rowsum(dO * O);  dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale,
// with P and dS rounded to bf16 for their products.
//
// Layout: q, k, v, dO are (B, H, N, 64) views given by their batch, head and
// token strides in elements; the innermost 64 values are contiguous, the
// base is 16-byte aligned and every stride is a multiple of 16 bytes (what
// TMA takes; kernels.tma_layout checks it).  o, dq, dk, dv are written
// through strides too.  lse and delta are contiguous (B, H, N) f32.
//
// Plain C interface.  Each entry point returns 0, a cudaError_t after its
// launch, ERR_ENCODE + the CUresult of a tensor map that the driver refused,
// ERR_NO_ENCODER if the driver has no cuTensorMapEncodeTiled, or
// ERR_REGISTERS if the kernel was built with fewer registers than setmaxnreg
// hands out (it would wait forever).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long i64;

constexpr int HD = 64;            // head dim
constexpr int ROW = HD * 2;       // bytes of one row: one 128-byte swizzle row
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 3 * WG;   // a producer and two consumer warpgroups
constexpr int CONSUMERS = 2 * WG;
constexpr int BM = 128;           // rows of a block: queries (fwd, dq), keys (dkv)
constexpr int BN = 128;           // keys of a step (fwd, dq)
constexpr int BQ = 64;            // query rows of a step (dkv)
constexpr int STAGES = 3;         // ring depth of the streamed tiles
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// About ten seconds of clock cycles: a wait on an mbarrier that takes longer
// traps, so a fault shows as a launch error, not as a hung card.
constexpr long long WAIT_LIMIT = 1ll << 34;

constexpr int BARS = 1 + 3 * STAGES;  // mbarriers of a block (at most), 8 bytes each
constexpr int ALIGN = 1024;  // 128-byte swizzle repeats every 8 rows: tiles start on 1 KB
constexpr int SMEM_FWD = BM * ROW + 2 * STAGES * BN * ROW + BARS * 8 + ALIGN;
constexpr int SMEM_DKV = 2 * BM * ROW + 2 * STAGES * BQ * ROW + 2 * STAGES * BQ * 4 + BARS * 8
                         + ALIGN;
constexpr int SMEM_DQ = 2 * BM * ROW + 2 * STAGES * BN * ROW + BARS * 8 + ALIGN;
// The fused backward: the dK/dV kernel's, then (1 KB aligned) each consumer
// warpgroup's dS^T tile and warpgroup 1's f32 dQ product.
constexpr int SMEM_FUSED = SMEM_DKV + ALIGN + 2 * BQ * ROW + BQ * HD * 4;

constexpr int ERR_ENCODE = 10000;
constexpr int ERR_NO_ENCODER = 20000;
constexpr int ERR_REGISTERS = 20001;

// ---------------------------------------------------------------------------
// PTX building blocks: shared addresses, mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
    return p + ((ALIGN - (smem_u32(p) & (ALIGN - 1))) & (ALIGN - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// An arrival that also announces the bytes a TMA load will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    return done != 0;
}

// Waits until the phase of the given parity has completed.  A fresh barrier
// counts as having completed the phase of parity 1, so a producer's first
// wait on an empty slot (parity 1) passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(addr, parity))
        if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// One box of a (64, N, H, B) tensor map: rows [row, row + box) of head h,
// batch b, to shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int h, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b),
        "r"(smem_u32(bar))
        : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// Named barriers 1 and 2 take turns between the two consumer warpgroups.
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// A barrier of one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma (the async
// proxy); a barrier after it makes everyone's visible.
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait that
// makes it valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory operand descriptor for a tile of 128-byte rows in
// 128-byte swizzle (as TMA wrote it): start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128 B) in bits 62-63.
// K-major (the contraction runs along the row): 8-row groups 1024 bytes
// apart, the next 16 columns 32 bytes on (+2).  MN-major (the contraction
// runs down the rows, as V's keys in P V): the same 1024 bytes between
// groups of 8 rows, the next 16 rows 2048 bytes on (+128); the tile is one
// swizzle atom wide (64 values), so the offset between atoms is never used.
__device__ __forceinline__ uint64_t desc_k(const void* tile) {
    return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
           (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
    return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
           (1ull << 62);
}

constexpr uint64_t K16_K = 2;     // descriptor step to the next 16 columns (32 B)
constexpr uint64_t K16_MN = 128;  // descriptor step to the next 16 rows (2 KB)

// 2^x on the special-function unit: exp2f without its fix-up for results
// below the smallest normal f32, which flush to 0 here.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64nN wgmma, per thread of the warpgroup: for each
// 8-column group j, d[4j], d[4j+1] at row r0 = 16 warp + lane / 4 and columns
// 8j + c0, 8j + c0 + 1 (c0 = 2 (lane % 4)); d[4j+2], d[4j+3] at row r0 + 8.
// The register A operand of m64nNk16 has the same layout for its 16 columns,
// so the bf16 pairs (d[4j], d[4j+1]), (d[4j+2], d[4j+3]) of groups 2kk and
// 2kk+1 are, in that order, the A registers of the kk-th 16 columns.

// D (64 x 128, f32) += A (64 x 16, shared) * B (128 x 16, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, shared) * B (64 x 16, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, shared, MN-major: stored transposed, 16
// rows of 64 values) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// S = Q K^T for one 128-key tile (m64n128, K-major A and B), committed.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint64_t qd, uint64_t kd) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sc, qd + kk * K16_K, kd + kk * K16_K, kk);
    wgmma_commit();
}

// O += P V for one 128-key tile (P from registers, V as MN-major B), committed.
__device__ __forceinline__ void issue_pv(float (&acc)[32], const uint32_t (&pa)[32], uint64_t vd) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n64(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                     vd + kk * K16_MN);
    wgmma_commit();
}

// The online softmax of one 128-key score tile starting at key k0, in place:
// keys >= N masked, the rows' running maxima (log2 units) and sums updated,
// sc replaced by the probabilities, and a0, a1 set to the factors that carry
// the output accumulated so far to the new maxima (0 at the first tile).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int k0, int N, int c0,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
    if (k0 + BN > N) {  // keys >= N are masked before the maximum
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (k0 + 8 * j + c0 + e >= N) sc[4 * j + e] = sc[4 * j + 2 + e] = -INFINITY;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, w));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, w));
    }
    // The tile holds at least one valid key, so the maxima are finite.
    const float n0 = fmaxf(m0, x0 * scale_log2), n1 = fmaxf(m1, x1 * scale_log2);
    a0 = ex2(m0 - n0);
    a1 = ex2(m1 - n1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        sc[4 * j] = ex2(sc[4 * j] * scale_log2 - n0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] * scale_log2 - n0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] * scale_log2 - n1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] * scale_log2 - n1);
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
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
}

// Probabilities (f32 accumulator layout) -> bf16 register A operands.
__device__ __forceinline__ void to_bf16(const float (&p)[64], uint32_t (&pa)[32]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        pa[2 * j] = pack_bf16(p[4 * j], p[4 * j + 1]);
        pa[2 * j + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
    }
}

__device__ __forceinline__ void rescale(float (&acc)[32], float a0, float a1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
    }
}

// Forward: one block per (128 query rows, head, batch); a loop over 128-key
// tiles.  Consumer warpgroup w holds rows [64 w, 64 w + 64) of the block.
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int N, float scale_log2, i64 osb, i64 osh, i64 osn) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sQ = align_smem(smem_raw);
    unsigned char* sK = sQ + BM * ROW;
    unsigned char* sV = sK + STAGES * BN * ROW;
    uint64_t* bar = reinterpret_cast<uint64_t*>(sV + STAGES * BN * ROW);
    uint64_t* q_full = bar;
    uint64_t* k_full = bar + 1;
    uint64_t* v_full = bar + 1 + STAGES;
    uint64_t* empty = bar + 1 + 2 * STAGES;

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int steps = (N + BN - 1) / BN;
    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / WG;
    if (wg == 0) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, BM * ROW);
            tma_load(sQ, &tm_q, q_full, q0, h, b);
            for (int it = 0; it < steps; ++it) {
                const int s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&k_full[s], BN * ROW);
                tma_load(sK + s * BN * ROW, &tm_k, &k_full[s], it * BN, h, b);
                mbar_expect_tx(&v_full[s], BN * ROW);
                tma_load(sV + s * BN * ROW, &tm_v, &v_full[s], it * BN, h, b);
            }
        }
    } else {
        setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = wg - 1, t = threadIdx.x % WG, lane = t & 31;
        const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
        const uint64_t qd = desc_k(sQ + cw * 64 * ROW);
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
        // Running maxima (log2 units) and sums of rows r0 and r0 + 8.
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
        mbar_wait(q_full, 0);
        // Tile 0's scores, then each step issues the next tile's S = Q K^T
        // and, behind it, P V of the tile before, and runs the softmax of the
        // new scores while P V is on the tensor cores.
        float sc[64];
        uint32_t pa[32];
        float a0, a1;  // factors that carry the output to the rows' new maxima
        mbar_wait(&k_full[0], 0);
        wgmma_fence();
        issue_scores(sc, qd, desc_k(sK));
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, 0, N, c0, scale_log2, m0, m1, l0, l1, a0, a1);
        to_bf16(sc, pa);
        // The two warpgroups take turns to issue their products (warpgroup 1
        // first), so that one's softmax runs while the other's products do.
        if (cw == 1 && steps > 1) named_arrive(1);
        for (int it = 1; it < steps; ++it) {
            const int s = it % STAGES, sp = (it - 1) % STAGES;
            mbar_wait(&k_full[s], (it / STAGES) & 1);
            named_sync(1 + cw);
            wgmma_fence();
            issue_scores(sc, qd, desc_k(sK + s * BN * ROW));
            rescale(acc, a0, a1);
            mbar_wait(&v_full[sp], ((it - 1) / STAGES) & 1);
            wgmma_fence();
            issue_pv(acc, pa, desc_mn(sV + sp * BN * ROW));
            if (cw == 0 || it + 1 < steps) named_arrive(2 - cw);
            wgmma_wait<1>();
            fence_regs(sc);
            softmax_tile(sc, it * BN, N, c0, scale_log2, m0, m1, l0, l1, a0, a1);
            wgmma_wait<0>();
            fence_regs(acc);
            mbar_arrive(&empty[sp]);
            to_bf16(sc, pa);
        }
        const int sl = (steps - 1) % STAGES;
        rescale(acc, a0, a1);
        mbar_wait(&v_full[sl], ((steps - 1) / STAGES) & 1);
        wgmma_fence();
        issue_pv(acc, pa, desc_mn(sV + sl * BN * ROW));
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[sl]);
        const int row0 = q0 + cw * 64 + r0, row1 = row0 + 8;
        const float i0 = 1.0f / l0, i1 = 1.0f / l1;
        o += b * osb + h * osh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (row0 < N)
                *reinterpret_cast<__nv_bfloat162*>(o + row0 * osn + 8 * j + c0) =
                    __floats2bfloat162_rn(acc[4 * j] * i0, acc[4 * j + 1] * i0);
            if (row1 < N)
                *reinterpret_cast<__nv_bfloat162*>(o + row1 * osn + 8 * j + c0) =
                    __floats2bfloat162_rn(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
        }
        if ((lane & 3) == 0) {
            float* out = lse + ((i64)b * H + h) * N;
            if (row0 < N) out[row0] = (m0 + log2f(l0)) * LN2;
            if (row1 < N) out[row1] = (m1 + log2f(l1)) * LN2;
        }
    }
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

// dK and dV: one block per (128 keys, head, batch); a loop over 64-row query
// tiles.  Consumer warpgroup w holds keys [64 w, 64 w + 64) of the block and
// works on the transposed tiles S^T, P^T, dS^T (keys x queries).  FUSED (the
// fused backward) also writes the block's dQ partial of each query tile to
// dqp (partial blockIdx.x, strides psb, psh, psn; pskb between partials).
template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, bf16* __restrict__ dqp, int H, int N, float scale, float scale_log2,
    i64 dksb, i64 dksh, i64 dksn, i64 dvsb, i64 dvsh, i64 dvsn, i64 psb, i64 psh, i64 psn,
    i64 pskb) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sK = align_smem(smem_raw);
    unsigned char* sV = sK + BM * ROW;
    unsigned char* sQ = sV + BM * ROW;
    unsigned char* sG = sQ + STAGES * BQ * ROW;  // dO
    float* sL = reinterpret_cast<float*>(sG + STAGES * BQ * ROW);  // lse, log2 units
    float* sD = sL + STAGES * BQ;                                  // delta
    uint64_t* bar = reinterpret_cast<uint64_t*>(sD + STAGES * BQ);
    uint64_t* kv_full = bar;
    uint64_t* full = bar + 1;
    uint64_t* empty = bar + 1 + STAGES;
    // FUSED: dS^T of each consumer warpgroup (64 keys x 64 queries, bf16,
    // 128-byte swizzle), then warpgroup 1's f32 dQ product of a step.
    unsigned char* sS = align_smem(reinterpret_cast<unsigned char*>(bar + BARS));
    float* sX = reinterpret_cast<float*>(sS + 2 * BQ * ROW);

    const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int steps = (N + BQ - 1) / BQ;
    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 32);  // the producer warp's lanes, after their lse/delta stores
            mbar_init(&empty[s], CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / WG;
    if (wg == 0) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
            const float* lse_bh = lse + ((i64)b * H + h) * N;
            const float* delta_bh = delta + ((i64)b * H + h) * N;
            if (lane == 0) {
                mbar_expect_tx(kv_full, 2 * BM * ROW);
                tma_load(sK, &tm_k, kv_full, k0, h, b);
                tma_load(sV, &tm_v, kv_full, k0, h, b);
            }
            // Each lane holds its values of the next step's lse and delta,
            // loaded a step ahead so that their latency hides behind the
            // ring's wait.
            constexpr int PER_LANE = BQ / 32;
            float l_next[PER_LANE], d_next[PER_LANE];
            auto fetch = [&](int q0) {
#pragma unroll
                for (int u = 0; u < PER_LANE; ++u) {
                    const int q = q0 + lane + 32 * u;
                    l_next[u] = q < N ? lse_bh[q] * LOG2E : 0.0f;
                    d_next[u] = q < N ? delta_bh[q] : 0.0f;
                }
            };
            fetch(0);
            for (int it = 0; it < steps; ++it) {
                const int s = it % STAGES, q0 = it * BQ;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
#pragma unroll
                for (int u = 0; u < PER_LANE; ++u) {
                    sL[s * BQ + lane + 32 * u] = l_next[u];
                    sD[s * BQ + lane + 32 * u] = d_next[u];
                }
                if (lane == 0) {
                    mbar_expect_tx(&full[s], 2 * BQ * ROW);
                    tma_load(sQ + s * BQ * ROW, &tm_q, &full[s], q0, h, b);
                    tma_load(sG + s * BQ * ROW, &tm_g, &full[s], q0, h, b);
                } else {
                    mbar_arrive(&full[s]);
                }
                if (it + 1 < steps) fetch(q0 + BQ);
            }
        }
    } else {
        setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = wg - 1, t = threadIdx.x % WG, lane = t & 31;
        const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
        const uint64_t dka = desc_k(sK + cw * 64 * ROW), dva = desc_k(sV + cw * 64 * ROW);
        float dk_acc[32], dv_acc[32], dq_acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
        unsigned char* tds = sS + cw * BQ * ROW;  // FUSED: this warpgroup's dS^T
        mbar_wait(kv_full, 0);
        for (int it = 0; it < steps; ++it) {
            const int s = it % STAGES, q0 = it * BQ;
            mbar_wait(&full[s], (it / STAGES) & 1);
            const unsigned char* tq = sQ + s * BQ * ROW;
            const unsigned char* tg = sG + s * BQ * ROW;
            const uint64_t dqk = desc_k(tq), dgk = desc_k(tg);
            float st[32], dpt[32];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n64(st, dka + kk * K16_K, dqk + kk * K16_K, kk);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss_n64(dpt, dva + kk * K16_K, dgk + kk * K16_K, kk);
            wgmma_commit();
            wgmma_wait<1>();  // S^T is in; dP^T may still run
            fence_regs(st);
            const float* L = sL + s * BQ;
            const float* D = sD + s * BQ;
            float p[32];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = 8 * j + c0 + e;  // a query of the tile
                    const bool ok = q0 + c < N;
                    p[4 * j + e] = ok ? ex2(st[4 * j + e] * scale_log2 - L[c]) : 0.0f;
                    p[4 * j + 2 + e] = ok ? ex2(st[4 * j + 2 + e] * scale_log2 - L[c]) : 0.0f;
                }
            uint32_t pf[16], sf[16];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                pf[2 * j] = pack_bf16(p[4 * j], p[4 * j + 1]);
                pf[2 * j + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
            }
            wgmma_wait<0>();
            fence_regs(dpt);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float d0 = D[8 * j + c0], d1 = D[8 * j + c0 + 1];
                sf[2 * j] = pack_bf16(p[4 * j] * (dpt[4 * j] - d0),
                                      p[4 * j + 1] * (dpt[4 * j + 1] - d1));
                sf[2 * j + 1] = pack_bf16(p[4 * j + 2] * (dpt[4 * j + 2] - d0),
                                          p[4 * j + 3] * (dpt[4 * j + 3] - d1));
            }
            if constexpr (FUSED) {
                // dS^T to shared memory: row r (a key) is 128 bytes of 64
                // queries, its 16-byte piece j at piece j ^ (r % 8).  Keys
                // >= N are 0 (their K rows are too, but their P is not).
                const int key0 = k0 + cw * 64 + r0;
                const uint32_t m0 = key0 < N ? ~0u : 0u, m1 = key0 + 8 < N ? ~0u : 0u;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int piece = (j ^ (r0 & 7)) << 4;
                    *reinterpret_cast<uint32_t*>(tds + r0 * ROW + piece + 2 * c0) = sf[2 * j] & m0;
                    *reinterpret_cast<uint32_t*>(tds + (r0 + 8) * ROW + piece + 2 * c0) =
                        sf[2 * j + 1] & m1;
                }
                fence_async_shared();
                warpgroup_sync(1 + cw);
            }
            wgmma_fence();
            const uint64_t dgm = desc_mn(tg), dqm = desc_mn(tq);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_n64(dv_acc, pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                             pf[4 * kk + 3], dgm + kk * K16_MN);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_n64(dk_acc, sf[4 * kk], sf[4 * kk + 1], sf[4 * kk + 2],
                             sf[4 * kk + 3], dqm + kk * K16_MN);
            if constexpr (FUSED) {
                // dQ_w = dS_w K_w over the warpgroup's 64 keys: dS_w is dS^T
                // read transposed, K the block's keys as MN-major B.
                const uint64_t dsa = desc_mn(tds), kbm = desc_mn(sK + cw * 64 * ROW);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss_n64_mn(dq_acc, dsa + kk * K16_MN, kbm + kk * K16_MN, kk);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv_acc);
            fence_regs(dk_acc);
            mbar_arrive(&empty[s]);
            if constexpr (FUSED) {
                fence_regs(dq_acc);
                // The two halves' sum: warpgroup 1 hands its product over
                // (barrier 3: it is in; barrier 4: warpgroup 0 has read it).
                if (cw == 1) {
                    if (it > 0) named_sync(4);
#pragma unroll
                    for (int i = 0; i < 32; ++i) sX[i * WG + t] = dq_acc[i];
                    named_arrive(3);
                } else {
                    named_sync(3);
#pragma unroll
                    for (int i = 0; i < 32; ++i) dq_acc[i] += sX[i * WG + t];
                    if (it + 1 < steps) named_arrive(4);
                    bf16* out = dqp + blockIdx.x * pskb + b * psb + h * psh;
                    const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (row0 < N)
                            *reinterpret_cast<__nv_bfloat162*>(out + row0 * psn + 8 * j + c0) =
                                __floats2bfloat162_rn(dq_acc[4 * j] * scale,
                                                      dq_acc[4 * j + 1] * scale);
                        if (row1 < N)
                            *reinterpret_cast<__nv_bfloat162*>(out + row1 * psn + 8 * j + c0) =
                                __floats2bfloat162_rn(dq_acc[4 * j + 2] * scale,
                                                      dq_acc[4 * j + 3] * scale);
                    }
                }
            }
        }
        const int row0 = k0 + cw * 64 + r0, row1 = row0 + 8;
        dk += b * dksb + h * dksh;
        dv += b * dvsb + h * dvsh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (row0 < N) {
                *reinterpret_cast<__nv_bfloat162*>(dk + row0 * dksn + 8 * j + c0) =
                    __floats2bfloat162_rn(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + row0 * dvsn + 8 * j + c0) =
                    __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
            }
            if (row1 < N) {
                *reinterpret_cast<__nv_bfloat162*>(dk + row1 * dksn + 8 * j + c0) =
                    __floats2bfloat162_rn(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + row1 * dvsn + 8 * j + c0) =
                    __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
            }
        }
    }
}

// dQ: one block per (128 query rows, head, batch); a loop over 128-key
// tiles.  Consumer warpgroup w holds rows [64 w, 64 w + 64) of the block.
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int H, int N, float scale, float scale_log2, i64 dqsb, i64 dqsh, i64 dqsn) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sQ = align_smem(smem_raw);
    unsigned char* sG = sQ + BM * ROW;  // dO
    unsigned char* sK = sG + BM * ROW;
    unsigned char* sV = sK + STAGES * BN * ROW;
    uint64_t* bar = reinterpret_cast<uint64_t*>(sV + STAGES * BN * ROW);
    uint64_t* qg_full = bar;
    uint64_t* k_full = bar + 1;
    uint64_t* v_full = bar + 1 + STAGES;
    uint64_t* empty = bar + 1 + 2 * STAGES;

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int steps = (N + BN - 1) / BN;
    if (threadIdx.x == 0) {
        mbar_init(qg_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&k_full[s], 1);
            mbar_init(&v_full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / WG;
    if (wg == 0) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(qg_full, 2 * BM * ROW);
            tma_load(sQ, &tm_q, qg_full, q0, h, b);
            tma_load(sG, &tm_g, qg_full, q0, h, b);
            for (int it = 0; it < steps; ++it) {
                const int s = it % STAGES;
                mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                mbar_expect_tx(&k_full[s], BN * ROW);
                tma_load(sK + s * BN * ROW, &tm_k, &k_full[s], it * BN, h, b);
                mbar_expect_tx(&v_full[s], BN * ROW);
                tma_load(sV + s * BN * ROW, &tm_v, &v_full[s], it * BN, h, b);
            }
        }
    } else {
        setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = wg - 1, t = threadIdx.x % WG, lane = t & 31;
        const int r0 = (t >> 5) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
        const int row0 = q0 + cw * 64 + r0, row1 = row0 + 8;
        const i64 bh = (i64)b * H + h;
        const float lse0 = row0 < N ? lse[bh * N + row0] * LOG2E : 0.0f;
        const float lse1 = row1 < N ? lse[bh * N + row1] * LOG2E : 0.0f;
        const float dl0 = row0 < N ? delta[bh * N + row0] : 0.0f;
        const float dl1 = row1 < N ? delta[bh * N + row1] : 0.0f;
        const uint64_t qa = desc_k(sQ + cw * 64 * ROW), ga = desc_k(sG + cw * 64 * ROW);
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
        mbar_wait(qg_full, 0);
        for (int it = 0; it < steps; ++it) {
            const int s = it % STAGES, k0 = it * BN;
            const uint32_t ph = (it / STAGES) & 1;
            mbar_wait(&k_full[s], ph);
            mbar_wait(&v_full[s], ph);
            // The tile's 128 keys as two halves of 64, so that S and dP of a
            // half (32 registers each) stay in registers beside dQ.
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int kh = k0 + half * 64;
                if (kh >= N) break;  // the tile's second half lies past the last key
                const unsigned char* tk = sK + s * BN * ROW + half * 64 * ROW;
                const unsigned char* tv = sV + s * BN * ROW + half * 64 * ROW;
                const uint64_t kd = desc_k(tk), vd = desc_k(tv);
                float sc[32], dp[32];
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss_n64(sc, qa + kk * K16_K, kd + kk * K16_K, kk);
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss_n64(dp, ga + kk * K16_K, vd + kk * K16_K, kk);
                wgmma_commit();
                wgmma_wait<1>();  // S (and dQ of the half before) are in; dP may still run
                fence_regs(sc);
                const bool edge = kh + 64 > N;
                float p[32];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const bool ok = !edge || kh + 8 * j + c0 + e < N;  // a key of the tile
                        p[4 * j + e] = ok ? ex2(sc[4 * j + e] * scale_log2 - lse0) : 0.0f;
                        p[4 * j + 2 + e] = ok ? ex2(sc[4 * j + 2 + e] * scale_log2 - lse1) : 0.0f;
                    }
                wgmma_wait<0>();
                fence_regs(dp);
                uint32_t ds[16];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    ds[2 * j] = pack_bf16(p[4 * j] * (dp[4 * j] - dl0),
                                          p[4 * j + 1] * (dp[4 * j + 1] - dl0));
                    ds[2 * j + 1] = pack_bf16(p[4 * j + 2] * (dp[4 * j + 2] - dl1),
                                              p[4 * j + 3] * (dp[4 * j + 3] - dl1));
                }
                wgmma_fence();
                const uint64_t km = desc_mn(tk);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_rs_n64(acc, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                                 km + kk * K16_MN);
                wgmma_commit();  // dQ of this half runs on behind the next half's S and dP
            }
            wgmma_wait<0>();
            fence_regs(acc);
            mbar_arrive(&empty[s]);
        }
        dq += b * dqsb + h * dqsh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if (row0 < N)
                *reinterpret_cast<__nv_bfloat162*>(dq + row0 * dqsn + 8 * j + c0) =
                    __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
            if (row1 < N)
                *reinterpret_cast<__nv_bfloat162*>(dq + row1 * dqsn + 8 * j + c0) =
                    __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
        }
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// Host: tensor maps and launches.
// ---------------------------------------------------------------------------

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The (64, N, H, B) view of a (B, H, N, 64) bf16 tensor with element strides
// st = (batch, head, token), read in boxes of `rows` rows with 128-byte
// swizzle; rows past N read as zeros.
int make_map(CUtensorMap* map, const void* base, int B, int H, int N, const long long* st,
             int rows) {
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[4] = {HD, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                   (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {HD, (cuuint32_t)rows, 1, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Opens a kernel's shared memory and checks that the build gave every thread
// the registers that setmaxnreg redistributes; once per kernel and device.
constexpr int MAX_DEVICES = 64;

int prepare(const void* kernel, int smem, int (&done)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES && done[dev]) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    if (attr.numRegs * THREADS < PRODUCER_REGS * WG + CONSUMER_REGS * CONSUMERS)
        return ERR_REGISTERS;
    if (dev < MAX_DEVICES) done[dev] = 1;
    return 0;
}

int fwd_ready[MAX_DEVICES], dkv_ready[MAX_DEVICES], dq_ready[MAX_DEVICES],
    fused_ready[MAX_DEVICES];

}  // namespace

// Strides arrive as one array of 64-bit element counts, (batch, head, token)
// per tensor in the order of the tensor arguments.

extern "C" int dynhor_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int H, int N, float sm_scale, const long long* st,
                                void* stream) {
    CUtensorMap mq, mk, mv;
    int err = make_map(&mq, q, B, H, N, st, BM);
    if (!err) err = make_map(&mk, k, B, H, N, st + 3, BN);
    if (!err) err = make_map(&mv, v, B, H, N, st + 6, BN);
    if (!err) err = prepare((const void*)flash_fwd_kernel, SMEM_FWD, fwd_ready);
    if (err) return err;
    const dim3 grid((N + BM - 1) / BM, H, B);
    flash_fwd_kernel<<<grid, THREADS, SMEM_FWD, (cudaStream_t)stream>>>(
        mq, mk, mv, (bf16*)o, (float*)lse, H, N, sm_scale * LOG2E, st[9], st[10], st[11]);
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
    CUtensorMap mq, mk, mv, mg;
    int err = make_map(&mq, q, B, H, N, st, BQ);
    if (!err) err = make_map(&mk, k, B, H, N, st + 3, BM);
    if (!err) err = make_map(&mv, v, B, H, N, st + 6, BM);
    if (!err) err = make_map(&mg, d_o, B, H, N, st + 9, BQ);
    if (!err) err = prepare((const void*)flash_bwd_dkv_kernel<false>, SMEM_DKV, dkv_ready);
    if (err) return err;
    const dim3 grid((N + BM - 1) / BM, H, B);
    flash_bwd_dkv_kernel<false><<<grid, THREADS, SMEM_DKV, (cudaStream_t)stream>>>(
        mq, mk, mv, mg, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, nullptr,
        H, N, sm_scale, sm_scale * LOG2E, st[12], st[13], st[14], st[15], st[16], st[17], 0, 0,
        0, 0);
    return (int)cudaGetLastError();
}

// The fused backward: dk, dv and dq_part, a (ceil(N / 128), B, H, N, 64)
// buffer of partials; st holds q, k, v, d_o, dk, dv, then the strides of
// one partial and, last, the stride between partials.
extern "C" int dynhor_flash_bwd_fused(const void* q, const void* k, const void* v,
                                      const void* d_o, const void* lse, const void* delta,
                                      void* dq_part, void* dk, void* dv, int B, int H, int N,
                                      float sm_scale, const long long* st, void* stream) {
    CUtensorMap mq, mk, mv, mg;
    int err = make_map(&mq, q, B, H, N, st, BQ);
    if (!err) err = make_map(&mk, k, B, H, N, st + 3, BM);
    if (!err) err = make_map(&mv, v, B, H, N, st + 6, BM);
    if (!err) err = make_map(&mg, d_o, B, H, N, st + 9, BQ);
    if (!err) err = prepare((const void*)flash_bwd_dkv_kernel<true>, SMEM_FUSED, fused_ready);
    if (err) return err;
    const dim3 grid((N + BM - 1) / BM, H, B);
    flash_bwd_dkv_kernel<true><<<grid, THREADS, SMEM_FUSED, (cudaStream_t)stream>>>(
        mq, mk, mv, mg, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        (bf16*)dq_part, H, N, sm_scale, sm_scale * LOG2E, st[12], st[13], st[14], st[15], st[16],
        st[17], st[18], st[19], st[20], st[21]);
    return (int)cudaGetLastError();
}

extern "C" int dynhor_flash_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                   const void* lse, const void* delta, void* dq, int B, int H,
                                   int N, float sm_scale, const long long* st, void* stream) {
    CUtensorMap mq, mk, mv, mg;
    int err = make_map(&mq, q, B, H, N, st, BM);
    if (!err) err = make_map(&mk, k, B, H, N, st + 3, BN);
    if (!err) err = make_map(&mv, v, B, H, N, st + 6, BN);
    if (!err) err = make_map(&mg, d_o, B, H, N, st + 9, BM);
    if (!err) err = prepare((const void*)flash_bwd_dq_kernel, SMEM_DQ, dq_ready);
    if (err) return err;
    const dim3 grid((N + BM - 1) / BM, H, B);
    flash_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ, (cudaStream_t)stream>>>(
        mq, mk, mv, mg, (const float*)lse, (const float*)delta, (bf16*)dq, H, N, sm_scale,
        sm_scale * LOG2E, st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}
