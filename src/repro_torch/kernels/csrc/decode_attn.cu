// Flash-decode for Hopper (sm_90a): single-token GQA attention against a
// long, ragged KV cache.
//
// Replaces src/repro/kernels/decode_attn/decode_attn.py::
// decode_attention_kernel (body _decode_kernel): a (B, kv-block) TPU grid
// whose kv axis runs in order and carries the online-softmax state
// (m, l, acc) in VMEM scratch, with the per-sequence lengths in scalar
// prefetch.
//
// Computes out[b, h] = softmax(q[b, h] . k[b, :, h // group] / sqrt(D))
// . v[b, :, h // group], positions >= lengths[b] masked to -1e30 before the
// softmax, all in f32, the result cast to q's type. A row with
// lengths[b] <= 0 has every score at -1e30, so the softmax is uniform and
// the reference returns the mean of v over all S positions; this kernel
// reproduces that by walking all S positions of such a row with every score
// at -1e30.
//
// Bound on the card: bytes. The function must read the K and V rows below
// each sequence's length once (plus q and the output), about
// 2 * sum_b(min(len_b, S)) * Hkv * D * sizeof(T) bytes / 3.35 TB/s (H100 SXM
// HBM3). Its 4 * H * len * D flops are ~2 flops per byte read: far below
// the tensor-core line, so the design is about keeping HBM busy.
//
// Design.
// * Work by live positions, planned on the card. A row is one (sequence,
//   kv head) pair, in (b, kv head) order; it holds ceil(live / block_k)
//   tiles, live = min(len, S), or S for len <= 0. The sum T of all rows'
//   tiles is cut into n contiguous ranges, CTA c taking tiles
//   [c T / n, (c + 1) T / n): every CTA is within one tile of the mean,
//   whatever the lengths, and one long row at B = 1 spreads over every CTA
//   as split-K did. n = min(grid, T), so every busy CTA holds a tile. The
//   wrapper launches one CTA per SM (one wave) and never reads lengths:
//   each CTA scans the B lengths itself (one warp, 32 sequences per step)
//   to find T and its first row. A CTA's range crosses rows; its part of
//   one row is a piece, whose online-softmax state (m, l, acc) goes to the
//   row's partials at index c - (the CTA holding the row's first tile). A
//   row has at most min(n, ceil(S / block_k)) pieces, so the wrapper sizes
//   the partials from the shape alone. (Ordering the tiles (b, tile, kv
//   head) instead, so that neighbouring CTAs read the kv heads of the same
//   positions, was measured no faster and makes every tile a piece.)
// * A ring of asynchronous loads. K and V rows move in stages of
//   kStageBytes (128 positions at D = 128 bf16) through a ring of kStages
//   shared-memory slots (fewer where a 1024-position tile's scores would
//   not fit beside them) by cp.async, 16 bytes a thread, L2 only, with a
//   256-byte L2 prefetch (one position's row of one head), in the order
//   they are used: a tile's K stages, then its V stages, then the next
//   tile's. kStages - 1 stages (160 KiB at full width) are in flight while
//   one is used, across the softmax step and across rows. One
//   __syncthreads per stage frees the slot the next load goes into.
//   On the card the time follows the bytes in flight: 16 KiB stages (112
//   KiB in flight) measured slower, and so did TMA boxes and per-row bulk
//   copies into the same ring.
// * block_k keeps its meaning: it is the unit the work is cut in and the
//   period of the online-softmax rescale. A tile's scores sit in shared
//   memory ([G][block_k] f32) until its last K stage is used; one warp per
//   head then takes their max and exp, and the V stages add p * v.
// * Scores without shuffle trees. The bf16 kernel runs both products on
//   mma.sync m16n8k16 (MmaPath below), the G heads padded to 8 columns; p
//   enters p v as two bf16 terms, hi + lo, so the product keeps ~16 bits
//   of p, and accumulates in f32. The f32 kernel (FmaPath) spreads a
//   position's D-vector over kLanes lanes, the fewest that keep a lane's
//   slice of all G heads' q in 64 registers; each K element loaded serves
//   all G heads and the partial dot products take log2(kLanes) shuffles.
//   Rows are padded in shared memory so that the 16-byte reads of one
//   phase, and ldmatrix's eight row addresses, fall in eight bank groups.
// * Combine deterministically. A second kernel, one CTA per (b, h),
//   recomputes the plan from lengths, finds the row's pieces and merges
//   them in piece order with the usual rescale, writing
//   acc / max(l, 1e-30). No atomics: two calls give the same bits.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared) and bound with
// ctypes: the entry point takes raw device pointers and the caller's
// stream, launches both kernels, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 32768;     // K or V rows of one ring stage
constexpr int kStages = 6;             // ring slots, at most
constexpr int kMaxBlockK = 1024;       // the largest registry block_k
constexpr int kQRegs = 64;             // q floats a lane may hold
constexpr int kSmemMax = 231424;       // dynamic shared memory a block may use
constexpr float kNegInf = -1e30f;      // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

template <typename T, int kVec>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVec]) {
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int c = 0; c < kVec; ++c) f[c] = to_f(e[c]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The fewest lanes per position (a power of two dividing the row's
// 16-byte chunks) that keep a lane's q slice of all g heads in kQRegs.
constexpr int lanes_for(int chunks, int vec, int g) {
    int l = 1;
    while (l < chunks && (chunks / l) * vec * g > kQRegs) l *= 2;
    return l;
}

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> {
    static constexpr bool value = true;
};

template <typename T, int D, int G>
struct Layout {
    static constexpr bool kMma = IsBf16<T>::value;   // bf16: mma.sync
    static constexpr int kVec = 16 / (int)sizeof(T);       // per chunk
    static constexpr int kChunks = D / kVec;                // per row
    static constexpr int kRows = kStageBytes / (D * (int)sizeof(T));
    // f32: lanes per position in the K stages, and chunks a lane reads
    static constexpr int kLanes = lanes_for(kChunks, kVec, G);
    static constexpr int kPerLane = kChunks / kLanes;
    static constexpr int kPass = kThreads / kLanes;         // positions a pass
    static constexpr int kGroups = kThreads / kChunks;      // V-stage groups
    // bf16: V stages split D into 16-row mma tiles, then positions
    static constexpr int kDTiles = D / 16;
    static constexpr int kPosSplit = kWarps / kDTiles;
    // rows padded so that the eight 16-byte reads of one phase (or the
    // eight row addresses of an ldmatrix) fall in eight bank groups
    static constexpr int kPad = kMma ? 16 : (kLanes < 8 ? 16 * kLanes : 0);
    static constexpr int kRowBytes = D * (int)sizeof(T) + kPad;
    static constexpr int kSlotBytes = kRows * kRowBytes;
    // a piece's cross-warp sum of acc
    static constexpr int kRedFloats = kMma ? kPosSplit * D * 8
                                           : kWarps * G * D;
    // ring slots: kStages, or fewer where the scores of a kMaxBlockK tile
    // would not fit beside them
    static constexpr int kScoreBytes =
        4 * (G * kMaxBlockK > kRedFloats ? G * kMaxBlockK : kRedFloats);
    static constexpr int kRing =
        (kSmemMax - kScoreBytes) / kSlotBytes < kStages
            ? (kSmemMax - kScoreBytes) / kSlotBytes : kStages;
    static_assert(kRing >= 3, "ring too shallow");
    static_assert(kLanes <= 32 && kChunks <= 32 && 32 % kChunks == 0, "");
    static_assert(!kMma || (kPosSplit * kDTiles == kWarps && kRows % 16 == 0
                            && G <= 8), "");
};

// ------------------------------------------------- f32: FMA from shared
// A position's D-vector is spread over kLanes lanes; each keeps its slice
// of q for all G heads in registers, so every K element loaded serves all
// G heads, and the partial dot products take log2(kLanes) shuffles. In the
// V stages a thread owns one 16-byte chunk of D for every kGroups-th
// position and sums over the groups only when its piece ends.
template <typename T, int D, int G>
struct FmaPath {
    using L = Layout<T, D, G>;
    static constexpr int kVec = L::kVec, kLanes = L::kLanes;
    float qf[G][L::kPerLane][kVec];
    float acc[G][kVec];

    __device__ __forceinline__ void start(const T* __restrict__ q_row) {
        const int kp = threadIdx.x % kLanes;
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int j = 0; j < L::kPerLane; ++j)
                unpack<T, kVec>(*reinterpret_cast<const uint4*>(
                    q_row + g * D + (j * kLanes + kp) * kVec), qf[g][j]);
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[g][c] = 0.f;
        }
    }

    // scores of the stage's n positions into sc[g * bk + i]; position i is
    // live when i < n_valid
    __device__ __forceinline__ void scores(const unsigned char* st, int n,
                                           float* sc, int bk, int n_valid,
                                           float scale) {
        const int kp = threadIdx.x % kLanes;
        for (int i0 = 0; i0 < n; i0 += L::kPass) {
            const int i = i0 + threadIdx.x / kLanes;
            float part[G];
#pragma unroll
            for (int g = 0; g < G; ++g) part[g] = 0.f;
            if (i < n) {
#pragma unroll
                for (int j = 0; j < L::kPerLane; ++j) {
                    float kf[kVec];
                    unpack<T, kVec>(*reinterpret_cast<const uint4*>(
                        st + i * L::kRowBytes + (j * kLanes + kp) * 16), kf);
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < kVec; ++c)
                            part[g] = fmaf(qf[g][j][c], kf[c], part[g]);
                }
            }
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int o = kLanes / 2; o > 0; o >>= 1)
                    part[g] += __shfl_xor_sync(kFull, part[g], o);
            if (i < n && kp == 0) {
#pragma unroll
                for (int g = 0; g < G; ++g)
                    sc[g * bk + i] = i < n_valid ? part[g] * scale : kNegInf;
            }
        }
    }

    __device__ __forceinline__ void rescale(const float* alpha) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[g][c] *= alpha[g];
    }

    // acc += p_i v_i over the stage's n positions, p at sc[g * bk + i]
    __device__ __forceinline__ void pv(const unsigned char* st, int n,
                                       const float* sc, int bk) {
        const int ch = threadIdx.x % L::kChunks;
        for (int i = threadIdx.x / L::kChunks; i < n; i += L::kGroups) {
            float vf[kVec];
            unpack<T, kVec>(*reinterpret_cast<const uint4*>(
                st + i * L::kRowBytes + ch * 16), vf);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const float p = sc[g * bk + i];
#pragma unroll
                for (int c = 0; c < kVec; ++c)
                    acc[g][c] = fmaf(p, vf[c], acc[g][c]);
            }
        }
    }

    // the thread's acc into red [kWarps][G][D], summed within the warp
    __device__ __forceinline__ void to_red(float* red) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        const int ch = threadIdx.x % L::kChunks;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int c = 0; c < kVec; ++c)
#pragma unroll
                for (int o = L::kChunks; o < 32; o <<= 1)
                    acc[g][c] += __shfl_xor_sync(kFull, acc[g][c], o);
        if (lane < L::kChunks) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int c = 0; c < kVec; ++c)
                    red[(warp * G + g) * D + ch * kVec + c] = acc[g][c];
        }
    }

    __device__ static float red_sum(const float* red, int g, int d) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red[(w * G + g) * D + d];
        return a;
    }
};

// ------------------------------------------------ bf16: mma.sync m16n8k16
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Scores: S^T = K q^T, 16 positions (A, from the K rows by ldmatrix) by the
// G heads padded to 8 (B, q in registers) per mma, 16 of D deep; products
// of bf16 are exact and accumulate in f32. Then out^T = V^T P^T: 16 of D
// (A, ldmatrix.trans of the V rows) by the 8 heads (B, p from shared
// memory split into two bf16 terms, hi + lo, one mma each), 16 positions
// deep.
// Warp w owns D-tile w % kDTiles and every kPosSplit-th 16 positions.
template <int D, int G>
struct MmaPath {
    using L = Layout<__nv_bfloat16, D, G>;
    uint32_t qb[D / 16][2];
    float acc[2][4];   // two chains: the hi and the lo terms of p

    __device__ __forceinline__ void start(
            const __nv_bfloat16* __restrict__ q_row) {
        const int lane = threadIdx.x % 32, head = lane / 4, t = lane % 4;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
            qb[ks][0] = qb[ks][1] = 0u;
            if (head < G) {
                const uint32_t* p = reinterpret_cast<const uint32_t*>(
                    q_row + head * D + ks * 16 + 2 * t);
                qb[ks][0] = p[0];
                qb[ks][1] = p[4];
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] = acc[1][e] = 0.f;
    }

    __device__ __forceinline__ void scores(const unsigned char* st, int n,
                                           float* sc, int bk, int n_valid,
                                           float scale) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        for (int mt = warp; mt * 16 < n; mt += kWarps) {
            // even and odd 16-column steps in two chains
            float c2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            const int row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const uint32_t base =
                smem_u32(st + row * L::kRowBytes + (lane >> 4) * 16);
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
                uint32_t a[4];
                ldmatrix_x4(a, base + ks * 32);
                mma_bf16(c2[ks & 1], a, qb[ks][0], qb[ks][1]);
            }
            float c[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) c[e] = c2[0][e] + c2[1][e];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = mt * 16 + lane / 4 + 8 * (e >> 1);
                const int head = 2 * (lane % 4) + (e & 1);
                if (head < G && i < n)
                    sc[head * bk + i] = i < n_valid ? c[e] * scale : kNegInf;
            }
        }
    }

    __device__ __forceinline__ void rescale(const float* alpha) {
        const int h0 = 2 * (threadIdx.x % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int head = h0 + (e & 1);
            const float a = head < G ? alpha[head] : 0.f;
            acc[0][e] *= a;
            acc[1][e] *= a;
        }
    }

    __device__ __forceinline__ void pv(const unsigned char* st, int n,
                                       const float* sc, int bk) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        const int dtile = warp % L::kDTiles, mi = lane >> 3;
        const int head = lane / 4, t = lane % 4;
        const uint32_t base = smem_u32(
            st + ((lane & 7) + (mi >> 1) * 8) * L::kRowBytes
            + (dtile * 16 + (mi & 1) * 8) * 2);
        for (int ks = warp / L::kDTiles; ks * 16 < n; ks += L::kPosSplit) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, base + ks * 16 * L::kRowBytes);
            float x[4] = {0.f, 0.f, 0.f, 0.f};
            if (head < G) {
                const int i = ks * 16 + 2 * t;
                const float* p = sc + head * bk + i;
                x[0] = i < n ? p[0] : 0.f;
                x[1] = i + 1 < n ? p[1] : 0.f;
                x[2] = i + 8 < n ? p[8] : 0.f;
                x[3] = i + 9 < n ? p[9] : 0.f;
            }
            // p = hi + lo, both bf16: p v keeps ~16 bits of p
            uint32_t hi[2], lo[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const __nv_bfloat162 h =
                    __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
                const float2 hf = __bfloat1622float2(h);
                hi[j] = *reinterpret_cast<const uint32_t*>(&h);
                lo[j] = pack_bf16(x[2 * j] - hf.x, x[2 * j + 1] - hf.y);
            }
            mma_bf16(acc[0], a, hi[0], hi[1]);
            mma_bf16(acc[1], a, lo[0], lo[1]);
        }
    }

    // the warp's acc into red [kPosSplit][D][8]
    __device__ __forceinline__ void to_red(float* red) {
        const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
        const int dtile = warp % L::kDTiles, ps = warp / L::kDTiles;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = dtile * 16 + lane / 4 + 8 * (e >> 1);
            red[(ps * D + d) * 8 + 2 * (lane % 4) + (e & 1)] =
                acc[0][e] + acc[1][e];
        }
    }

    __device__ static float red_sum(const float* red, int g, int d) {
        float a = 0.f;
#pragma unroll
        for (int ps = 0; ps < L::kPosSplit; ++ps)
            a += red[(ps * D + d) * 8 + g];
        return a;
    }
};

template <typename T, int D, int G> struct PathOf {
    using type = FmaPath<T, D, G>;
};
template <int D, int G> struct PathOf<__nv_bfloat16, D, G> {
    using type = MmaPath<D, G>;
};

// --------------------------------------------------------------- the plan
__device__ __forceinline__ int row_live(int len, int S) {
    return len > 0 ? min(len, S) : S;
}

__host__ __device__ __forceinline__ long long cta_lo(long long c,
                                                     long long total, int n) {
    return c * total / n;
}

// CTAs that get work: at most one per tile, so that every CTA below the
// count holds at least one tile and a row's pieces are numbered without
// gaps.
__device__ __forceinline__ int busy_ctas(int grid, long long total) {
    return (int)min((long long)grid, total);
}

// The CTA whose range holds global tile x.
__device__ __forceinline__ int cta_of(long long x, long long total, int n) {
    long long c = x * n / total;
    while (c + 1 < n && cta_lo(c + 1, total, n) <= x) ++c;
    while (c > 0 && cta_lo(c, total, n) > x) --c;
    return (int)c;
}

struct Scan {
    long long total;     // tiles of one kv head over all sequences
    int b;               // the sequence whose rows hold tile t
    long long before;    // its rows start at tile hkv * before
    long long before_q;  // tiles of one kv head before sequence b_query
};

// Run by a whole warp; every lane gets the result.
__device__ Scan scan_plan(const int32_t* __restrict__ lengths, int B, int S,
                          int bk, int hkv, long long t, int b_query) {
    const int lane = threadIdx.x & 31;
    Scan r{0, -1, 0, 0};
    for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const long long nt =
            b < B ? (row_live(lengths[b], S) + bk - 1) / bk : 0;
        long long incl = nt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long u = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += u;
        }
        const long long excl = r.total + incl - nt;
        const unsigned hit = __ballot_sync(
            kFull, b < B && (long long)hkv * (excl + nt) > t);
        if (r.b < 0 && hit) {
            const int l = __ffs(hit) - 1;
            r.b = b0 + l;
            r.before = __shfl_sync(kFull, excl, l);
        }
        if (b_query >= b0 && b_query < b0 + 32)
            r.before_q = __shfl_sync(kFull, excl, b_query - b0);
        r.total += __shfl_sync(kFull, incl, 31);
    }
    return r;
}

// Where a walk over a CTA's tiles stands: one ring stage.
struct Cursor {
    int b, kvh;      // the row
    int len, live;   // lengths[b] and the row's live positions
    int tile;        // tile within the row
    int off;         // the stage's first position within the tile
    int phase;       // 0: K, 1: V
    long long g;     // global index of the tile
};

__device__ __forceinline__ int tile_end(const Cursor& c, int bk) {
    return min(c.tile * bk + bk, c.live);
}

__device__ __forceinline__ void advance(Cursor& c, int rows, int bk, int S,
                                        int hkv, long long t_hi,
                                        const int32_t* __restrict__ lengths) {
    c.off += rows;
    if (c.tile * bk + c.off < tile_end(c, bk)) return;
    c.off = 0;
    if (c.phase == 0) {
        c.phase = 1;
        return;
    }
    c.phase = 0;
    ++c.g;
    if ((long long)(c.tile + 1) * bk < c.live) {
        ++c.tile;
        return;
    }
    c.tile = 0;
    if (++c.kvh == hkv) {
        c.kvh = 0;
        ++c.b;
    }
    if (c.g < t_hi) {
        c.len = lengths[c.b];
        c.live = row_live(c.len, S);
    }
}

// --------------------------------------------------------------- kernels
// Dynamic shared memory: the ring (kStages slots), then the tile's scores
// [G][block_k] f32, which a piece's end reuses for the cross-warp sum of
// acc (kRedFloats).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int B, int H, int Hkv,
                    int S, int bk, int max_pieces, float scale) {
    using L = Layout<T, D, G>;
    constexpr int kVec = L::kVec, kChunks = L::kChunks, kRows = L::kRows;
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int kRing = L::kRing;
    float* sc = reinterpret_cast<float*>(smem + kRing * L::kSlotBytes);
    __shared__ float s_m[G], s_l[G], s_alpha[G];

    const int cta = blockIdx.x;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

    // ---- the plan: this CTA's tiles [t_lo, t_hi) and its first row
    const long long total =
        (long long)Hkv * scan_plan(lengths, B, S, bk, Hkv, -1, -1).total;
    const int n_ctas = busy_ctas(gridDim.x, total);
    if (cta >= n_ctas) return;
    const long long t_lo = cta_lo(cta, total, n_ctas);
    const long long t_hi = cta_lo(cta + 1, total, n_ctas);
    const Scan at = scan_plan(lengths, B, S, bk, Hkv, t_lo, -1);
    Cursor cc;
    cc.b = at.b;
    cc.len = lengths[at.b];
    cc.live = row_live(cc.len, S);
    {
        const long long nt = (cc.live + bk - 1) / bk;
        const long long r = t_lo - (long long)Hkv * at.before;
        cc.kvh = (int)(r / nt);
        cc.tile = (int)(r % nt);
    }
    cc.off = 0;
    cc.phase = 0;
    cc.g = t_lo;
    Cursor pc = cc;

    // rows past a partial stage's end are read by the mma tiles (and
    // weighted 0): start the ring from zeros, not from stale bits
    for (int e = tid; e < kRing * L::kSlotBytes / 16; e += kThreads)
        reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    auto issue = [&](const Cursor& c, int slot) {
        const int p0 = c.tile * bk + c.off;
        const int n = min(kRows, tile_end(c, bk) - p0);
        const T* base = (c.phase ? v : k)
            + (((long long)c.b * S + p0) * Hkv + c.kvh) * D;
        unsigned char* dst = smem + slot * L::kSlotBytes;
        for (int e = tid; e < n * kChunks; e += kThreads) {
            const int i = e / kChunks, ch = e % kChunks;
            cp_async16(dst + i * L::kRowBytes + ch * 16,
                       base + (long long)i * Hkv * D + ch * kVec);
        }
    };

#pragma unroll 1
    for (int s = 0; s < kRing - 1; ++s) {
        if (pc.g < t_hi) {
            issue(pc, s);
            advance(pc, kRows, bk, S, Hkv, t_hi, lengths);
        }
        cp_async_commit();
    }

    typename PathOf<T, D, G>::type path;
    bool fresh = true;

#pragma unroll 1
    for (int cs = 0; cc.g < t_hi; ++cs) {
        cp_async_wait<kRing - 2>();
        __syncthreads();
        if (pc.g < t_hi) {
            issue(pc, (cs + kRing - 1) % kRing);
            advance(pc, kRows, bk, S, Hkv, t_hi, lengths);
        }
        cp_async_commit();

        const unsigned char* st = smem + (cs % kRing) * L::kSlotBytes;
        const int t0 = cc.tile * bk;
        const int tile_n = tile_end(cc, bk) - t0;
        const int n = min(kRows, tile_n - cc.off);
        const long long h0 = (long long)cc.b * H + (long long)cc.kvh * G;
        if (fresh) {
            path.start(q + h0 * D);
            if (tid < G) {
                s_m[tid] = -INFINITY;
                s_l[tid] = 0.f;
            }
            fresh = false;
        }

        if (cc.phase == 0) {
            path.scores(st, n, sc + cc.off, bk, cc.len - (t0 + cc.off),
                        scale);
        } else {
            if (cc.off == 0) {
                // the tile's scores are in: max, p = exp(s - m), running l
                for (int g = warp; g < G; g += kWarps) {
                    float* sg = sc + g * bk;
                    float mx = -INFINITY;
                    for (int i = lane; i < tile_n; i += 32)
                        mx = fmaxf(mx, sg[i]);
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
                    const float m_old = s_m[g];
                    const float m_new = fmaxf(m_old, mx);
                    float sum = 0.f;
                    for (int i = lane; i < tile_n; i += 32) {
                        const float p = __expf(sg[i] - m_new);
                        sg[i] = p;
                        sum += p;
                    }
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        sum += __shfl_xor_sync(kFull, sum, o);
                    if (lane == 0) {
                        const float alpha = __expf(m_old - m_new);
                        s_alpha[g] = alpha;
                        s_l[g] = s_l[g] * alpha + sum;
                        s_m[g] = m_new;
                    }
                }
                __syncthreads();
                path.rescale(s_alpha);
            }
            path.pv(st, n, sc + cc.off, bk);
            const bool tile_done = cc.off + kRows >= tile_n;
            const bool piece_done = tile_done
                && ((long long)(cc.tile + 1) * bk >= cc.live
                    || cc.g + 1 == t_hi);
            if (piece_done) {
                // sum acc across warps through sc, in a fixed order
                __syncthreads();
                path.to_red(sc);
                __syncthreads();
                const int piece =
                    cta - cta_of(cc.g - cc.tile, total, n_ctas);
                if (piece < max_pieces) {
                    for (int idx = tid; idx < G * D; idx += kThreads) {
                        const int g = idx / D, d = idx % D;
                        acc_part[((h0 + g) * max_pieces + piece) * D + d] =
                            PathOf<T, D, G>::type::red_sum(sc, g, d);
                    }
                    if (tid < G) {
                        m_part[(h0 + tid) * max_pieces + piece] = s_m[tid];
                        l_part[(h0 + tid) * max_pieces + piece] = s_l[tid];
                    }
                }
                __syncthreads();
                fresh = true;
            }
        }
        advance(cc, kRows, bk, S, Hkv, t_hi, lengths);
    }
    cp_async_wait<0>();
}

// One CTA per (b, h): find the row's pieces from the same plan, rescale
// them to their common max in piece order and divide.
template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const int32_t* __restrict__ lengths,
                      const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, T* __restrict__ out,
                      int B, int H, int Hkv, int S, int D, int bk,
                      int n_ctas, int max_pieces) {
    const long long bh = blockIdx.x;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const int kvh = h / (H / Hkv);
    const Scan sp = scan_plan(lengths, B, S, bk, Hkv, -1, b);
    const long long total = (long long)Hkv * sp.total;
    n_ctas = busy_ctas(n_ctas, total);
    const long long nt = (row_live(lengths[b], S) + bk - 1) / bk;
    const long long first = (long long)Hkv * sp.before_q + kvh * nt;
    const int c0 = cta_of(first, total, n_ctas);
    const int n = min(cta_of(first + nt - 1, total, n_ctas) - c0 + 1,
                      max_pieces);
    const float* mp = m_part + bh * max_pieces;
    const float* lp = l_part + bh * max_pieces;
    float mx = -INFINITY;
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, mp[s]);
    float l = 0.f;
    for (int s = 0; s < n; ++s) l += lp[s] * __expf(mp[s] - mx);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float a = 0.f;
        for (int s = 0; s < n; ++s)
            a += acc_part[(bh * max_pieces + s) * D + d] * __expf(mp[s] - mx);
        out[bh * D + d] = from_f<T>(a * inv_l);
    }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int H, int Hkv, int S, int bk, int n_ctas, int max_pieces,
           cudaStream_t stream) {
    using L = Layout<T, D, G>;
    const int score_floats = G * bk;
    const int sum_floats = L::kRedFloats;
    const size_t smem = (size_t)L::kRing * L::kSlotBytes + sizeof(float) *
        (size_t)(score_floats > sum_floats ? score_floats : sum_floats);
    if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = 1.f / sqrtf((float)D);
    decode_split_kernel<T, D, G><<<n_ctas, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
        m_part, l_part, acc_part, B, H, Hkv, S, bk, max_pieces, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<T><<<B * H, 128, 0, stream>>>(
        (const int32_t*)lengths, m_part, l_part, acc_part, (T*)out, B, H,
        Hkv, S, D, bk, n_ctas, max_pieces);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const void* lengths, void* out, float* mp, float* lp,
                 float* ap, int B, int H, int Hkv, int S, int bk, int n_ctas,
                 int max_pieces, cudaStream_t s) {
    switch (group) {
    case 1:
        return launch<T, D, 1>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, bk, n_ctas, max_pieces, s);
    case 2:
        return launch<T, D, 2>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, bk, n_ctas, max_pieces, s);
    case 4:
        return launch<T, D, 4>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, bk, n_ctas, max_pieces, s);
    case 8:
        return launch<T, D, 8>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, bk, n_ctas, max_pieces, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,) int32; out: (B, H, D);
// all contiguous on the device, 16-byte aligned. m_part, l_part:
// (B, H, max_pieces) f32 scratch; acc_part: (B, H, max_pieces, D) f32
// scratch, max_pieces >= min(n_ctas, ceil(S / block_k)). D in {64, 128};
// H / Hkv in {1, 2, 4, 8}; 1 <= block_k <= S. dtype: 0 float32, 1 bfloat16.
int decode_attn_launch(const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* m_part,
                       void* l_part, void* acc_part, int B, int H, int Hkv,
                       int S, int D, int block_k, int n_ctas, int max_pieces,
                       int dtype, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaGetLastError();
    if (S <= 0 || block_k <= 0 || n_ctas <= 0 || max_pieces <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    float* mp = (float*)m_part;
    float* lp = (float*)l_part;
    float* ap = (float*)acc_part;
    const int g = H / Hkv;
    if (dtype == 0 && D == 64)
        return launch_group<float, 64>(g, q, k, v, lengths, out, mp, lp, ap,
                                       B, H, Hkv, S, block_k, n_ctas,
                                       max_pieces, s);
    if (dtype == 0 && D == 128)
        return launch_group<float, 128>(g, q, k, v, lengths, out, mp, lp, ap,
                                        B, H, Hkv, S, block_k, n_ctas,
                                        max_pieces, s);
    if (dtype == 1 && D == 64)
        return launch_group<__nv_bfloat16, 64>(g, q, k, v, lengths, out, mp,
                                               lp, ap, B, H, Hkv, S, block_k,
                                               n_ctas, max_pieces, s);
    if (dtype == 1 && D == 128)
        return launch_group<__nv_bfloat16, 128>(g, q, k, v, lengths, out, mp,
                                                lp, ap, B, H, Hkv, S,
                                                block_k, n_ctas, max_pieces,
                                                s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
