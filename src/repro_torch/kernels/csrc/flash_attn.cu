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
// the 0.03 ms its bytes need.
//
// Design. The TPU grid's sequential kv axis becomes a loop inside the CTA
// (nothing carries between CTAs on the card). A CTA takes block_q query rows
// of one (b, h) (the registry's block_q, so a tuned point keeps its meaning)
// and walks them as sub-tiles of 64 rows, one warp per 16 rows; sub-tiles
// sit at multiples of 64 whatever block_q is, so a row's computation never
// depends on block_q and the axis stays bit-exact, as on the TPU. For each
// sub-tile the CTA loops over kv tiles of BK positions (the registry's
// block_k), staged in shared memory with 16-byte loads and read by every
// warp; query head h reads kv head h // group straight from k and v, so no
// repeated K/V exists. kv tiles that the mask empties for the whole
// sub-tile (past the diagonal, or before the window) are skipped; that is
// exact, since such a tile adds exp(-1e30 - m) = 0 to every row that has a
// valid key, and every row does.
//
// bf16 takes the tensor cores: mma.sync m16n8k16 with f32 accumulation for
// both products (q k^T products of bf16 values are exact in f32; only the
// order of the sums differs from the reference), operand tiles from shared
// memory by ldmatrix, rows padded by 16 bytes so the loads hit no bank
// twice. p is rounded to bf16 for the p v product, as FlashAttention does;
// the registry's tolerance (5e-2 absolute) bounds that. K and V tiles come
// in by cp.async into two shared stages, so the next tile's copy overlaps
// this tile's products (no TMA or wgmma yet). Scores are kept in log2
// units so each exponential is one ex2 instruction, and only tiles that cross
// the diagonal, the window's edge or the sequence's end evaluate the mask.
// float32 takes a CUDA core
// kernel with f32 products throughout: 4 lanes per query row, each holding a
// quarter of q and of acc, its tiles loaded without overlap.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared) and bound with
// ctypes: the entry point takes raw device pointers and the caller's
// stream, launches, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr float kNegInf = -1e30f;      // the reference's mask value

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
constexpr int kSubRows = 64;           // query rows per sub-tile (4 x 16)
constexpr int kPad = 8;                // bf16 padding per shared row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16-byte global -> shared copy that bypasses registers; with valid false it
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A holds rows
// g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9; B holds column g, rows
// 2t, 2t + 1, 2t + 8, 2t + 9; C holds rows g and g + 8, columns 2t, 2t + 1.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int H, int Hkv, int S,
                  int causal, int window, int block_q, float scale) {
    static_assert(D % 32 == 0 && BK % 16 == 0, "tile shapes");
    constexpr int kLd = D + kPad;
    constexpr int kStage = 2 * BK * kLd;   // one stage: the K tile, the V tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / Hkv);
    const __nv_bfloat16* qb = q + (int64_t)bh * S * D;
    const __nv_bfloat16* kb = k + ((int64_t)b * Hkv + kvh) * S * D;
    const __nv_bfloat16* vb = v + ((int64_t)b * Hkv + kvh) * S * D;
    __nv_bfloat16* ob = out + (int64_t)bh * S * D;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    // the heaviest causal blocks (the last rows) start first
    const int qblk = gridDim.x - 1 - blockIdx.x;
    const int cta_q0 = qblk * block_q;
    const int cta_q1 = min(cta_q0 + block_q, S);
    const float scale_log2 = scale * 1.4426950408889634f;   // scale * log2(e)

    for (int q0 = cta_q0; q0 < cta_q1; q0 += kSubRows) {
        const int r0 = q0 + warp * 16 + g;
        const int r1 = r0 + 8;
        uint32_t qa[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            qa[kk][0] = r0 < cta_q1 ? ld_u32(qb + (int64_t)r0 * D + c) : 0u;
            qa[kk][1] = r1 < cta_q1 ? ld_u32(qb + (int64_t)r1 * D + c) : 0u;
            qa[kk][2] = r0 < cta_q1 ? ld_u32(qb + (int64_t)r0 * D + c + 8)
                                    : 0u;
            qa[kk][3] = r1 < cta_q1 ? ld_u32(qb + (int64_t)r1 * D + c + 8)
                                    : 0u;
        }
        float o[D / 8][4];
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
        float m[2] = {kNegInf, kNegInf};
        float l[2] = {0.f, 0.f};           // this lane's share of the row sum

        const int q_last = min(q0 + kSubRows, cta_q1) - 1;
        int kv_lo, kv_hi;
        kv_range(q0, q_last + 1, S, causal, window, BK, &kv_lo, &kv_hi);
        // two stages: the next tile's copy runs while this one is used
        auto load_tile = [&](int stage, int kv0) {
            __nv_bfloat16* kd = smem + stage * kStage;
            __nv_bfloat16* vd = kd + BK * kLd;
            for (int idx = threadIdx.x; idx < BK * D / 8; idx += kThreads) {
                const int row = idx / (D / 8), col = (idx % (D / 8)) * 8;
                const int pos = kv0 + row;
                const int64_t off = (int64_t)(pos < S ? pos : 0) * D + col;
                cp_async16(kd + row * kLd + col, kb + off, pos < S);
                cp_async16(vd + row * kLd + col, vb + off, pos < S);
            }
        };
        load_tile(0, kv_lo);
        cp_async_commit();
        int it = 0;
        for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK, ++it) {
            const int cur = it & 1;
            if (kv0 + BK < kv_hi) load_tile(cur ^ 1, kv0 + BK);
            cp_async_commit();
            cp_async_wait_one();           // this tile has landed
            __syncthreads();
            const __nv_bfloat16* ks = smem + cur * kStage;
            const __nv_bfloat16* vs = ks + BK * kLd;

            // s = q k^T for this warp's 16 rows x BK positions
            float sc[BK / 8][4];
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < D / 16; kk += 2) {
                    // matrices: (k-step kk: cols 0-7, 8-15), (kk+1: same)
                    uint32_t bf[4];
                    const int mi = lane / 8;
                    ldsm_x4(bf, ks + (nt * 8 + lane % 8) * kLd + kk * 16
                                    + mi * 8);
                    mma_bf16(sc[nt], qa[kk], bf[0], bf[1]);
                    mma_bf16(sc[nt], qa[kk + 1], bf[2], bf[3]);
                }
            }
            // scale (into log2 units, so p = 2^(s - m)), mask, online
            // softmax (rows r0: e = 0, 1; r1: e = 2, 3). Only a tile that
            // crosses the diagonal, the window's edge or the sequence's end
            // needs the mask; the test is the same for the whole CTA.
            const bool masked = kv0 + BK > S
                || (causal && kv0 + BK - 1 > q0)
                || (window > 0 && q_last - kv0 >= window);
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float sv = sc[nt][e] * scale_log2;
                    if (masked) {
                        const int row = e < 2 ? r0 : r1;
                        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
                        sv = mask_score(sv, row, col, S, causal, window);
                    }
                    sc[nt][e] = sv;
                    mx[e >> 1] = fmaxf(mx[e >> 1], sv);
                }
            }
            float alpha[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                alpha[i] = fast_exp2(m[i] - m_new);
                m[i] = m_new;
            }
            float rs[2] = {0.f, 0.f};
#pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float p = fast_exp2(sc[nt][e] - m[e >> 1]);
                    sc[nt][e] = p;
                    rs[e >> 1] += p;
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
            for (int nd = 0; nd < D / 8; ++nd) {
                o[nd][0] *= alpha[0];
                o[nd][1] *= alpha[0];
                o[nd][2] *= alpha[1];
                o[nd][3] *= alpha[1];
            }
            // o += p v: p's C fragments are the A fragments of the product
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                uint32_t pa[4];
                pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
                pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
                pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
                pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
                for (int nd = 0; nd < D / 8; nd += 2) {
                    // matrices: (keys 0-7, d nd), (keys 8-15, d nd),
                    //           (keys 0-7, d nd+1), (keys 8-15, d nd+1)
                    uint32_t bf[4];
                    const int mi = lane / 8;
                    ldsm_x4_t(bf, vs + (kk * 16 + (mi & 1) * 8 + lane % 8)
                                      * kLd + (nd + (mi >> 1)) * 8);
                    mma_bf16(o[nd], pa, bf[0], bf[1]);
                    mma_bf16(o[nd + 1], pa, bf[2], bf[3]);
                }
            }
            __syncthreads();               // before the stage is refilled
        }
        // finish: the row sum over the quad, acc / max(l, 1e-30)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            l[i] = 1.f / fmaxf(l[i], 1e-30f);
        }
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
            const int c = nd * 8 + 2 * t;
            if (r0 < cta_q1)
                *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * D + c) =
                    pack_bf16(o[nd][0] * l[0], o[nd][1] * l[0]);
            if (r1 < cta_q1)
                *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * D + c) =
                    pack_bf16(o[nd][2] * l[1], o[nd][3] * l[1]);
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

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int H, int Hkv, int S, int causal, int window,
                int block_q, float scale, cudaStream_t stream) {
    const int smem = 2 * 2 * BK * (D + kPad) * (int)sizeof(__nv_bfloat16);
    cudaFuncSetAttribute(flash_bf16_kernel<D, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((S + block_q - 1) / block_q, B * H);
    flash_bf16_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, Hkv, S, causal,
        window, block_q, scale);
    return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int H, int Hkv, int S, int causal, int window, int block_q,
               float scale, cudaStream_t stream) {
    const int smem = 2 * BK * D * (int)sizeof(float);
    cudaFuncSetAttribute(flash_f32_kernel<D, BK>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((S + block_q - 1) / block_q, B * H);
    flash_f32_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, H,
        Hkv, S, causal, window, block_q, scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, int block_k, const void* q, const void* k,
             const void* v, void* out, int B, int H, int Hkv, int S,
             int causal, int window, int block_q, float scale,
             cudaStream_t s) {
    if (dtype == 1) {
        if (block_k == 32)
            return launch_bf16<D, 32>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, s);
        if (block_k == 64)
            return launch_bf16<D, 64>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, s);
        if (block_k == 128)
            return launch_bf16<D, 128>(q, k, v, out, B, H, Hkv, S, causal,
                                       window, block_q, scale, s);
    } else if (dtype == 0) {
        if (block_k == 32)
            return launch_f32<D, 32>(q, k, v, out, B, H, Hkv, S, causal,
                                     window, block_q, scale, s);
        if (block_k == 64)
            return launch_f32<D, 64>(q, k, v, out, B, H, Hkv, S, causal,
                                     window, block_q, scale, s);
        if (block_k == 128)
            return launch_f32<D, 128>(q, k, v, out, B, H, Hkv, S, causal,
                                      window, block_q, scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (B, H, S, D); k, v: (B, Hkv, S, D); all contiguous on the device,
// 16-byte aligned. D in {64, 128}; block_k in {32, 64, 128}; block_q >= 1.
// dtype: 0 float32, 1 bfloat16.
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int Hkv, int S, int D, int causal,
                      int window, int block_q, int block_k, int dtype,
                      void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
    const float scale = 1.f / sqrtf((float)D);
    cudaStream_t s = (cudaStream_t)stream;
    if (D == 64)
        return launch_d<64>(dtype, block_k, q, k, v, out, B, H, Hkv, S,
                            causal, window, block_q, scale, s);
    if (D == 128)
        return launch_d<128>(dtype, block_k, q, k, v, out, B, H, Hkv, S,
                             causal, window, block_q, scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
