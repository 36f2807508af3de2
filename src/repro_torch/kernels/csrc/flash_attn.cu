// Flash attention (forward) for Hopper (sm_90a): causal and/or
// sliding-window GQA over a whole sequence, for training and prefill.
//
// Replaces src/repro/kernels/flash_attn/flash_attn.py::
// flash_attention_kernel (body _flash_kernel): a (B*H, q-block, kv-block)
// TPU grid whose kv axis runs in order and carries the online-softmax state
// (m, l, acc) in VMEM scratch, with GQA in the K/V index maps.
//
// Computes out[b, h] = softmax(mask(q[b, h] k[b, h // group]^T / sqrt(D)))
// v[b, h // group], masked scores at -1e30 (q_pos >= k_pos when causal,
// q_pos - k_pos < window when window > 0), f32 softmax, the result cast to
// q's type.
//
// Bound on the card: operations. Causal attention over S positions does
// about 2 * B * H * S^2 * D flops (two products, half the square) on
// 2 * S * (H + 2 * Hkv) * D * sizeof(T) bytes; at the full-width input
// (one 8192-token Granite-3-8B sequence, bf16) that is 549.8 GFLOP, 0.556 ms
// at the dense bf16 tensor-core peak of 989 TFLOP/s (H100 SXM), far above
// the 0.03 ms its bytes need. Only wgmma reaches that rate, so the bf16
// kernel is built around it.
//
// Design (bf16). The TPU grid's sequential kv axis becomes a loop inside
// the CTA (nothing carries between CTAs on the card). A CTA takes block_q
// query rows of one (b, h) (the registry's block_q, so a tuned point keeps
// its meaning) and is three warpgroups, FlashAttention-3's shape:
// - one producer warpgroup, which gives its registers to the others
//   (setmaxnreg) and in which one thread issues every load by TMA: the
//   query rows once per tile, K and V in tiles of BK positions (the
//   registry's block_k) into a ring of shared stages guarded by full/empty
//   mbarrier pairs, so loads run ahead of the products;
// - two consumer warpgroups of 64 query rows each, sharing each K/V tile.
//   s = q k^T is one wgmma m64nBKk16 chain with both operands in shared
//   memory (K-major); o += p v takes p from registers (the s fragment
//   regrouped per k16 step is the A fragment, as in FlashAttention-3) and
//   V from shared memory read MN-major.
// Every tile is 128-byte swizzled by TMA, matching the wgmma descriptors; a
// 128-byte row holds 64 bf16, so a D = 128 row is two panels. The tensor
// maps are 3-D, (D, S, B*H) for q and (D, S, B*Hkv) for k and v, so rows
// past S read as zeros and never as the next head's rows; query head h
// reads kv head h // group straight from k and v.
//
// Within a consumer the products of two kv tiles overlap, as in
// FlashAttention-3: tile i's q k^T and tile i-1's p v are issued together,
// o is rescaled while q k^T runs, and tile i's softmax runs while p v is
// still on the tensor cores. The softmax keeps m in log2 units, so each
// probability is one FFMA and one ex2 (the scale folded into the FFMA);
// masked scores are -1e30, or -inf past S; only tiles that cross the
// diagonal, the window's edge or the sequence's end run the masked
// instantiation of the softmax (a mask test that the compiler if-converts
// into every tile makes the whole kernel markedly slower).
// p is rounded to bf16 for the p v product, as FlashAttention does (the
// registry's 5e-2 tolerance bounds that); q k^T products of bf16 values are
// exact in f32, only the order of the sums differs from the reference. The
// descriptors are computed from warp-uniform values before each chain: a
// non-wgmma instruction that defines a wgmma input inside a chain makes
// ptxas serialise every wgmma of the kernel (its C7513 note).
//
// block_q stays an exact axis: the 64-row warpgroup tiles sit at multiples
// of 64 from row 0 whatever block_q is, and each warpgroup takes its kv
// range and its mask test from its own 64 rows and skips the tiles outside
// that range, so a row's arithmetic never depends on block_q or on which
// warpgroup holds it.
//
// What is left: the two consumers issue their products without ordering
// between them (FlashAttention-3's ping-pong of the warpgroups measured no
// gain here), the grid is not persistent, the output is stored from
// registers rather than by TMA, and there is no fp8 path.
//
// float32 takes a CUDA core kernel with f32 products throughout: 4 lanes
// per query row, each holding a quarter of q and of acc, its tiles loaded
// without overlap (TF32 would not keep f32's accuracy).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared) and bound with
// ctypes: the entry point takes raw device pointers, the launch plan the
// wrapper computed and the caller's stream, launches, and returns
// cudaGetLastError(). cuTensorMapEncodeTiled comes from the driver through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // the f32 kernel: 4 warps
constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr int kSmemMax = 232448;       // shared memory a block may use

// kv positions [lo, hi) that some row of [q0, q1) may see, lo aligned down
// to the tile
__device__ __forceinline__ void kv_range(int q0, int q1, int S, int causal,
                                         int window, int tile, int* lo,
                                         int* hi) {
    int a = window > 0 ? max(0, q0 - window + 1) : 0;
    *lo = a / tile * tile;
    *hi = causal ? min(q1, S) : S;
}

__device__ __forceinline__ float mask_score(float s, int row, int col, int S,
                                            int causal, int window) {
    if (col >= S) return -INFINITY;                 // past the sequence
    bool ok = true;
    if (causal) ok = row >= col;
    if (window > 0) ok = ok && (row - col) < window;
    return ok ? s : kNegInf;
}

// ---------------------------------------------------------------- bf16
constexpr int kWgRows = 64;            // query rows per consumer warpgroup
constexpr int kConsumers = 2;          // consumer warpgroups
constexpr int kBf16Threads = 128 * (1 + kConsumers);
constexpr int kPanel = 64;             // bf16 columns per swizzled row
constexpr int kRowBytes = 128;         // the swizzle's row
constexpr int kSmemAlign = 1024;       // the 128-byte swizzle's period
constexpr int kProducerRegs = 40;      // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;     //   = 65536, the SM's registers
// log2(e) / sqrt(128), the smallest scale_log2 of the head dims taken
constexpr float kMinScaleLog2 = 0.12751743f;

// dynamic shared memory of one bf16 CTA: alignment slack, the query tiles
// of both consumers, the K/V ring, and 2 * stages + 2 mbarriers
__host__ __device__ constexpr int bf16_smem_bytes(int D, int BK,
                                                  int stages) {
    return kSmemAlign + kConsumers * kWgRows * D * 2 + stages * 2 * BK * D * 2
        + 8 * (2 * stages + 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// the producer's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// wait until the barrier's phase is no longer `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// one TMA box of a 3-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile; lbo and sbo
// in 16-byte units. K-major (q, k): sbo = 8 rows x 128 bytes, lbo unused.
// MN-major (v): sbo = 8 key rows, lbo = one 64-column panel.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16)
        | ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x N, f32) (+)= a (64 x 16, shared) b (N x 16, shared)^T; the
// accumulator is read only when acc != 0
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

// d (64 x N, f32) += a (64 x 16, registers) b (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special function unit (what __expf uses after scaling by
// log2(e)); 2^-inf and 2^(-1e30) are 0
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// A 64-row query group: rows [q0, q_last] (those below S) and the kv tiles
// [lo, hi) its rows may see. Group gi holds rows 64 gi .. 64 gi + 63.
struct Group {
    int q0, q_last, lo, hi;
};

__device__ __forceinline__ Group group_of(int gi, int S, int causal,
                                          int window, int tile) {
    Group g;
    g.q0 = gi * kWgRows;
    g.q_last = min(g.q0 + kWgRows, S) - 1;
    kv_range(g.q0, g.q_last + 1, S, causal, window, tile, &g.lo, &g.hi);
    return g;
}

// The CTA's rows [q_lo, q_hi) lie in groups g_first .. g_last, walked as
// tiles of kConsumers groups: tile t gives group g_first + 2t + c to
// consumer c. The kv tiles the producer loads for tile t are the union of
// its groups' ranges.
__device__ __forceinline__ void tile_span(int t, int g_first, int g_last,
                                          int S, int causal, int window,
                                          int tile, int* lo, int* hi) {
    *lo = S;
    *hi = 0;
#pragma unroll
    for (int c = 0; c < kConsumers; ++c) {
        const int gi = g_first + kConsumers * t + c;
        if (gi <= g_last) {
            const Group g = group_of(gi, S, causal, window, tile);
            *lo = min(*lo, g.lo);
            *hi = max(*hi, g.hi);
        }
    }
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// the wgmma descriptor of the 128-byte-swizzled tile at `addr`, made
// warp-uniform (broadcast from lane 0) so it lives in uniform registers,
// and computed before the products: an instruction that defines a wgmma
// input between the products of a chain makes ptxas serialise them all
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, uint32_t lbo) {
    uint64_t d = sw128_desc(__shfl_sync(0xffffffffu, addr, 0), lbo, 64);
    asm volatile("" : "+l"(d));
    return d;
}

// issue s = q k^T (64 rows x BK positions) from the descriptors of the q
// rows and the K tile; k16 step kk is 32 bytes into panel kk / 4, a
// constant added to the descriptor's address field (shared addresses stay
// below 2^18, so no carry). The caller commits and waits.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, off = (kk % 4) * 32;
        wgmma_ss<BK>(s, dq + ((p * kWgRows * kRowBytes + off) >> 4),
                     dk + ((p * BK * kRowBytes + off) >> 4), kk > 0);
    }
}

// issue o += p v from the descriptor of the V tile (MN-major: lbo one
// 64-column panel, sbo 8 key rows); k16 step kk is 16 key rows further.
// The caller commits and waits.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint64_t dv) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], dv + ((kk * 16 * kRowBytes) >> 4));
}

// One kv tile of the online softmax for rows r0 (s[4j + e], e = 0, 1) and
// r1 (e = 2, 3) at positions kv0 + 8j + 2 t4 + (e & 1): mask when kMask
// (the raw score becomes -1e30, or -inf past S), update m and l, leave p in
// s, and return in alpha the factor o must be rescaled by. m is kept in
// log2 units, so p = 2^(s * scale_log2 - m) is one FFMA and one ex2. The
// mask is its own instantiation, so the tiles that need none carry none of
// its instructions.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int kv0, int r0, int r1, int t4, int S, int causal, int window,
    float scale_log2) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (kMask) {
                const int row = e < 2 ? r0 : r1;
                const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
                s[4 * j + e] = mask_score(s[4 * j + e], row, col, S, causal,
                                          window);
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
    }
    float neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * scale_log2);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        // A row that has seen only masked keys so far has m near
        // -1e30 * scale_log2, where the FFMA's rounding residue alone could
        // overflow ex2; its p is 0 instead, and the first key it may see
        // wipes the row's sums anyway (alpha = 0).
        neg_m[i] = m_new < kNegInf * kMinScaleLog2 * 0.5f ? 0.f : -m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(s[4 * j + e], scale_log2,
                                           neg_m[e >> 1]));
            s[4 * j + e] = p;
            rs[e >> 1] += p;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// the softmax of one tile; only a tile that crosses the diagonal, the
// window's edge or the sequence's end for this group evaluates the mask
template <int BK>
__device__ __forceinline__ void softmax(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int kv0, int r0, int r1, int t4, const Group& grp, int S, int causal,
    int window, float scale_log2) {
    if (kv0 + BK > S || (causal && kv0 + BK - 1 > grp.q0)
            || (window > 0 && grp.q_last - kv0 >= window))
        softmax_tile<BK, true>(s, m, l, alpha, kv0, r0, r1, t4, S, causal,
                               window, scale_log2);
    else
        softmax_tile<BK, false>(s, m, l, alpha, kv0, r0, r1, t4, S, causal,
                                window, scale_log2);
}

// p rounded to bf16 as the A fragments of o += p v: s's two n8 blocks of
// each k16 step are that step's fragment. Written only once the last p v
// that read pa has completed.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
}

// o's rows r0 (o[4j], o[4j + 1]) and r1 (o[4j + 2], o[4j + 3]) times the
// softmax's rescale factors
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2],
                                          const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
    }
}

template <int D, int BK>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ out, int H, int Hkv, int S,
                  int causal, int window, int block_q, int stages,
                  float scale) {
    static_assert(D % kPanel == 0 && (BK == 32 || BK == 64 || BK == 128),
                  "tile shapes");
    constexpr int kPanels = D / kPanel;
    constexpr int kQBytes = kWgRows * D * 2;     // one consumer's q rows
    constexpr int kTile = BK * D * 2;            // one K (or V) tile
    extern __shared__ unsigned char smem_raw[];
    const uint32_t q_s = (smem_u32(smem_raw) + kSmemAlign - 1)
        & ~(uint32_t)(kSmemAlign - 1);
    const uint32_t kv_s = q_s + kConsumers * kQBytes;
    // full[i] at bars + 8 i, empty[i] at bars + 8 (stages + i)
    const uint32_t bars = kv_s + stages * 2 * kTile;
    const uint32_t q_full = bars + 16 * stages, q_empty = q_full + 8;

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int kv_plane = b * Hkv + h / (H / Hkv);
    // the heaviest causal blocks (the last rows) start first
    const int qblk = gridDim.x - 1 - blockIdx.x;
    const int cta_q0 = qblk * block_q;
    const int cta_q1 = min(cta_q0 + block_q, S);
    const int g_first = cta_q0 / kWgRows, g_last = (cta_q1 - 1) / kWgRows;
    const int n_tiles = (g_last - g_first) / kConsumers + 1;

    if (threadIdx.x == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(bars + 8 * i, 1);
            mbar_init(bars + 8 * (stages + i), kConsumers);
        }
        mbar_init(q_full, 1);
        mbar_init(q_empty, kConsumers);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup, broadcast from lane 0 so the compiler knows it is
    // uniform: the descriptors then stay in uniform registers, and nothing
    // but wgmma sits between the products of a chain
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == 0) {
        // ---- producer: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (threadIdx.x == 0) {
            int stage = 0, phase = 0;
            for (int t = 0; t < n_tiles; ++t) {
                int lo, hi;
                tile_span(t, g_first, g_last, S, causal, window, BK, &lo,
                          &hi);
                if (t > 0) mbar_wait(q_empty, (t - 1) & 1);
                const int g0 = g_first + kConsumers * t;
                const int n_q = min(kConsumers, g_last - g0 + 1);
                mbar_expect_tx(q_full, n_q * kQBytes);
                for (int c = 0; c < n_q; ++c)
                    for (int p = 0; p < kPanels; ++p)
                        tma_load(q_s + c * kQBytes + p * kWgRows * kRowBytes,
                                 &tm_q, q_full, p * kPanel,
                                 (g0 + c) * kWgRows, bh);
                for (int kv0 = lo; kv0 < hi; kv0 += BK) {
                    mbar_wait(bars + 8 * (stages + stage), phase ^ 1);
                    const uint32_t full = bars + 8 * stage;
                    const uint32_t ks = kv_s + stage * 2 * kTile;
                    mbar_expect_tx(full, 2 * kTile);
                    for (int p = 0; p < kPanels; ++p) {
                        tma_load(ks + p * BK * kRowBytes, &tm_k, full,
                                 p * kPanel, kv0, kv_plane);
                        tma_load(ks + kTile + p * BK * kRowBytes, &tm_v, full,
                                 p * kPanel, kv0, kv_plane);
                    }
                    if (++stage == stages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- consumers: 64 query rows each. Within a warpgroup the
        // products of two kv tiles overlap: tile i's q k^T and tile i-1's
        // p v are issued together, and tile i's softmax runs while the p v
        // product is still on the tensor cores.
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int c = wg - 1;
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t4 = lane & 3;
        const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
        const uint64_t dq = tile_desc(q_s + c * kQBytes, 1);
        constexpr uint32_t kVLbo = BK * kRowBytes / 16;   // one V panel
        int stage = 0, phase = 0;
        auto full = [&](int st) { return bars + 8 * st; };
        // one thread of the warpgroup releases a stage (or q) once the
        // warpgroup's products that read it have completed
        auto release = [&](uint32_t bar) {
            if (tid == 0) mbar_arrive(bar);
        };
        auto empty = [&](int st) { return bars + 8 * (stages + st); };
        auto advance = [&]() {
            if (++stage == stages) {
                stage = 0;
                phase ^= 1;
            }
        };
        // a tile only the partner reads: wait for it, release it
        auto pass_over = [&]() {
            mbar_wait(full(stage), phase);
            release(empty(stage));
            advance();
        };
        for (int t = 0; t < n_tiles; ++t) {
            int lo, hi;
            tile_span(t, g_first, g_last, S, causal, window, BK, &lo, &hi);
            const int gi = g_first + kConsumers * t + c;
            const bool active = gi <= g_last;
            const Group grp = group_of(min(gi, g_last), S, causal, window,
                                       BK);
            // this group's kv tiles, a contiguous run inside [lo, hi); the
            // tiles around it are the partner's and are only released
            const int own_lo = active ? grp.lo : hi;
            const int own_hi = active ? grp.hi : hi;
            const int r0 = grp.q0 + warp * 16 + g;
            const int r1 = r0 + 8;
            float o[D / 2];
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
            float m[2] = {kNegInf, kNegInf};
            float l[2] = {0.f, 0.f};       // this lane's share of the row sum
            float alpha[2];
            float s[BK / 2];
            uint32_t pa[BK / 16][4];       // p as the A fragments of p v
            mbar_wait(q_full, t & 1);
            int kv0 = lo;
            for (; kv0 < own_lo; kv0 += BK) pass_over();
            if (kv0 < own_hi) {
                // the first tile: s, then its softmax (o is still 0)
                int st_prev = stage;
                mbar_wait(full(stage), phase);
                {
                    const uint64_t dk = tile_desc(kv_s + stage * 2 * kTile,
                                                  1);
                    fence_regs(s);
                    wgmma_fence();
                    issue_qk<D, BK>(s, dq, dk);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_regs(s);
                }
                softmax<BK>(s, m, l, alpha, kv0, r0, r1, t4, grp, S, causal,
                            window, scale_log2);
                pack_p<BK>(s, pa);
                advance();
                for (kv0 += BK; kv0 < own_hi; kv0 += BK) {
                    // s of this tile and p v of the last one run together;
                    // o is rescaled while s runs, before p v adds to it
                    mbar_wait(full(stage), phase);
                    const uint64_t dk = tile_desc(kv_s + stage * 2 * kTile,
                                                  1);
                    const uint64_t dv = tile_desc(
                        kv_s + st_prev * 2 * kTile + kTile, kVLbo);
                    fence_regs(s);
                    wgmma_fence();
                    issue_qk<D, BK>(s, dq, dk);
                    wgmma_commit();
                    rescale_o<D>(o, alpha);
                    fence_regs(o);
                    fence_regs(pa);
                    wgmma_fence();
                    issue_pv<D, BK>(o, pa, dv);
                    wgmma_commit();
                    fence_regs(pa);
                    wgmma_wait<1>();       // s is in; p v may still run
                    fence_regs(s);
                    softmax<BK>(s, m, l, alpha, kv0, r0, r1, t4, grp, S,
                                causal, window, scale_log2);
                    wgmma_wait<0>();
                    fence_regs(o);
                    fence_regs(pa);
                    release(empty(st_prev));   // its V has been read
                    st_prev = stage;
                    advance();
                    pack_p<BK>(s, pa);
                }
                // the last tile's p v
                const uint64_t dv = tile_desc(
                    kv_s + st_prev * 2 * kTile + kTile, kVLbo);
                rescale_o<D>(o, alpha);
                fence_regs(o);
                fence_regs(pa);
                wgmma_fence();
                issue_pv<D, BK>(o, pa, dv);
                wgmma_commit();
                fence_regs(pa);
                wgmma_wait<0>();
                fence_regs(o);
                release(empty(st_prev));
            }
            for (; kv0 < hi; kv0 += BK) pass_over();
            release(q_empty);              // this tile's q is no longer read
            if (!active) continue;
            // finish: the row sum over the quad, o / max(l, 1e-30)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
                l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
                l[i] = 1.f / fmaxf(l[i], 1e-30f);
            }
            __nv_bfloat16* ob = out + (int64_t)bh * S * D;
            const bool st0 = r0 >= cta_q0 && r0 < cta_q1;
            const bool st1 = r1 >= cta_q0 && r1 < cta_q1;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                const int col = 8 * j + 2 * t4;
                if (st0)
                    *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * D + col) =
                        pack_bf16(o[4 * j] * l[0], o[4 * j + 1] * l[0]);
                if (st1)
                    *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * D + col) =
                        pack_bf16(o[4 * j + 2] * l[1], o[4 * j + 3] * l[1]);
            }
        }
    }
}

// ---------------------------------------------------------------- float32
constexpr int kF32Rows = 32;           // query rows per sub-tile, 4 lanes each

// Lane t of a row's quad holds elements 4t + 16i + c (i < D/16, c < 4) of
// q and acc, so the quad's float4 reads of one shared row are
// conflict-free; a position's score is the quad's shuffle sum, kept by lane
// (position % 4) and broadcast back for the p v product.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int Hkv, int S, int causal, int window, int block_q,
                 float scale) {
    static_assert(D % 16 == 0 && BK % 4 == 0, "tile shapes");
    constexpr int kPer = D / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* ks = reinterpret_cast<float*>(smem_raw);
    float* vs = ks + BK * D;

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / Hkv);
    const float* qb = q + (int64_t)bh * S * D;
    const float* kb = k + ((int64_t)b * Hkv + kvh) * S * D;
    const float* vb = v + ((int64_t)b * Hkv + kvh) * S * D;
    float* ob = out + (int64_t)bh * S * D;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;
    const int qblk = gridDim.x - 1 - blockIdx.x;
    const int cta_q0 = qblk * block_q;
    const int cta_q1 = min(cta_q0 + block_q, S);

    for (int q0 = cta_q0; q0 < cta_q1; q0 += kF32Rows) {
        const int row = q0 + threadIdx.x / 4;
        float4 qv[kPer], acc[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            qv[i] = row < cta_q1
                ? *reinterpret_cast<const float4*>(qb + (int64_t)row * D
                                                   + 4 * t + 16 * i)
                : make_float4(0.f, 0.f, 0.f, 0.f);
            acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float m = kNegInf, l = 0.f;
        int kv_lo, kv_hi;
        kv_range(q0, min(q0 + kF32Rows, cta_q1), S, causal, window, BK,
                 &kv_lo, &kv_hi);
        for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK) {
            __syncthreads();
            for (int idx = threadIdx.x; idx < BK * D / 4; idx += kThreads) {
                const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
                const int pos = kv0 + r;
                float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
                if (pos < S) {
                    kx = *reinterpret_cast<const float4*>(
                        kb + (int64_t)pos * D + c);
                    vx = *reinterpret_cast<const float4*>(
                        vb + (int64_t)pos * D + c);
                }
                *reinterpret_cast<float4*>(ks + r * D + c) = kx;
                *reinterpret_cast<float4*>(vs + r * D + c) = vx;
            }
            __syncthreads();
            float p[BK / 4];                 // positions j with j % 4 == t
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < BK; ++j) {
                float s = 0.f;
#pragma unroll
                for (int i = 0; i < kPer; ++i) {
                    const float4 kx = *reinterpret_cast<const float4*>(
                        ks + j * D + 4 * t + 16 * i);
                    s = fmaf(qv[i].x, kx.x, s);
                    s = fmaf(qv[i].y, kx.y, s);
                    s = fmaf(qv[i].z, kx.z, s);
                    s = fmaf(qv[i].w, kx.w, s);
                }
                s += __shfl_xor_sync(0xffffffffu, s, 1);
                s += __shfl_xor_sync(0xffffffffu, s, 2);
                s = mask_score(s * scale, row, kv0 + j, S, causal, window);
                if ((j & 3) == t) p[j >> 2] = s;
                mx = fmaxf(mx, s);
            }
            const float m_new = fmaxf(m, mx);
            const float alpha = __expf(m - m_new);
            m = m_new;
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < BK / 4; ++j) {
                p[j] = __expf(p[j] - m);
                rs += p[j];
            }
            l = l * alpha + rs;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                acc[i].x *= alpha;
                acc[i].y *= alpha;
                acc[i].z *= alpha;
                acc[i].w *= alpha;
            }
#pragma unroll
            for (int j = 0; j < BK; ++j) {
                const float pj = __shfl_sync(0xffffffffu, p[j >> 2],
                                             (lane & ~3) | (j & 3));
#pragma unroll
                for (int i = 0; i < kPer; ++i) {
                    const float4 vx = *reinterpret_cast<const float4*>(
                        vs + j * D + 4 * t + 16 * i);
                    acc[i].x = fmaf(pj, vx.x, acc[i].x);
                    acc[i].y = fmaf(pj, vx.y, acc[i].y);
                    acc[i].z = fmaf(pj, vx.z, acc[i].z);
                    acc[i].w = fmaf(pj, vx.w, acc[i].w);
                }
            }
        }
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        if (row < cta_q1) {
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                *reinterpret_cast<float4*>(ob + (int64_t)row * D + 4 * t
                                           + 16 * i) =
                    make_float4(acc[i].x * inv, acc[i].y * inv,
                                acc[i].z * inv, acc[i].w * inv);
            }
        }
    }
}


// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime
EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// a 3-D map (D, S, planes) of a contiguous (planes, S, D) bf16 tensor, read
// in boxes of 64 columns x `rows` rows of one plane, 128-byte swizzled;
// boxes past S or past D fill with zeros
bool make_map(CUtensorMap* map, const void* base, int D, int S, int planes,
              int rows) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)S * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Plan {
    int threads, stages, smem, grid_x;
};

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Hkv, int S, int causal, int window,
                int block_q, float scale, Plan plan, cudaStream_t stream) {
    if (plan.threads != kBf16Threads || plan.stages < 2
            || plan.smem < bf16_smem_bytes(D, BK, plan.stages)
            || plan.smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    CUtensorMap tm_q, tm_k, tm_v;
    if (!make_map(&tm_q, q, D, S, B * H, kWgRows)
            || !make_map(&tm_k, k, D, S, B * Hkv, BK)
            || !make_map(&tm_v, v, D, S, B * Hkv, BK))
        return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(flash_bf16_kernel<D, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         plan.smem);
    const dim3 grid(plan.grid_x, B * H);
    flash_bf16_kernel<D, BK><<<grid, plan.threads, plan.smem, stream>>>(
        tm_q, tm_k, tm_v, (__nv_bfloat16*)out, H, Hkv, S, causal, window,
        block_q, plan.stages, scale);
    return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hkv, int S, int causal, int window, int block_q,
               float scale, Plan plan, cudaStream_t stream) {
    if (plan.threads != kThreads
            || plan.smem < 2 * BK * D * (int)sizeof(float)
            || plan.smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    cudaFuncSetAttribute(flash_f32_kernel<D, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         plan.smem);
    const dim3 grid(plan.grid_x, B * H);
    flash_f32_kernel<D, BK><<<grid, plan.threads, plan.smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, H,
        Hkv, S, causal, window, block_q, scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, int block_k, const void* q, const void* k,
             const void* v, void* out, int B, int H, int Hkv, int S,
             int causal, int window, int block_q, float scale, Plan plan,
             cudaStream_t s) {
    if (dtype == 1) {
        if (block_k == 32)
            return launch_bf16<D, 32>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, plan, s);
        if (block_k == 64)
            return launch_bf16<D, 64>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, plan, s);
        if (block_k == 128)
            return launch_bf16<D, 128>(q, k, v, out, B, H, Hkv, S, causal,
                                       window, block_q, scale, plan, s);
    } else if (dtype == 0) {
        if (block_k == 32)
            return launch_f32<D, 32>(q, k, v, out, B, H, Hkv, S, causal,
                                     window, block_q, scale, plan, s);
        if (block_k == 64)
            return launch_f32<D, 64>(q, k, v, out, B, H, Hkv, S, causal,
                                     window, block_q, scale, plan, s);
        if (block_k == 128)
            return launch_f32<D, 128>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, plan, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (B, H, S, D); k, v: (B, Hkv, S, D); all contiguous on the device,
// 16-byte aligned. D in {64, 128}; block_k in {32, 64, 128}; block_q >= 1.
// dtype: 0 float32, 1 bfloat16. threads, stages, smem and grid_x are the
// wrapper's launch plan (flash_attn.py::launch_plan); a plan that does not
// fit the kernel is refused with cudaErrorInvalidValue.
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int Hkv, int S, int D, int causal,
                      int window, int block_q, int block_k, int dtype,
                      int threads, int stages, int smem, int grid_x,
                      void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
    if (block_q < 1 || grid_x != (S + block_q - 1) / block_q)
        return (int)cudaErrorInvalidValue;
    const float scale = 1.f / sqrtf((float)D);
    const Plan plan = {threads, stages, smem, grid_x};
    cudaStream_t s = (cudaStream_t)stream;
    if (D == 64)
        return launch_d<64>(dtype, block_k, q, k, v, out, B, H, Hkv, S,
                            causal, window, block_q, scale, plan, s);
    if (D == 128)
        return launch_d<128>(dtype, block_k, q, k, v, out, B, H, Hkv, S,
                             causal, window, block_q, scale, plan, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
