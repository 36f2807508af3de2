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
// Design. The TPU grid's sequential kv axis becomes split-K
// (flash-decoding): CTA (split, kv head, b) takes one contiguous range of
// positions, n_split ranges per row, so that B * Hkv * n_split CTAs fill the
// card even at B * Hkv = 64 (the wrapper picks n_split; it is not a registry
// axis). Inside a CTA the carry is a loop over tiles of block_k positions
// (the registry's block_k), one online-softmax rescale per tile as on the
// TPU. A CTA serves all `group` query heads that read its kv head, so K and
// V are read once per kv head, never repeated per query head. Each position's
// D-vector is spread over D / (16 / sizeof(T)) lanes that load 16 bytes each,
// neighbouring lanes on neighbouring addresses; the q . k partial sums are
// reduced across those lanes with shuffles. Scores of a tile go to shared
// memory, one warp per head takes their max and exp, then every lane adds
// p * v for its slice. The CTA stops at the row's length (ranges past it
// exit at once), so only the rows below each length are read. Each lane
// starts kUnroll positions' 16-byte loads before it uses any of them, so
// enough bytes are in flight to cover HBM latency. A second
// kernel combines the n_split partial (m, l, acc) of each (b, h) with the
// usual rescale and writes acc / max(l, 1e-30).
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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // positions' loads in flight per lane
constexpr float kNegInf = -1e30f;      // the reference's mask value

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

// Shared memory: the tile's scores [G][block_k], later reused for the
// cross-slot sum of acc [slots][G][D]. G (query heads per kv head) is a
// template parameter so q and acc take exactly G * 16 bytes of registers.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int H, int Hkv, int S,
                    int block_k, int split_len, float scale) {
    constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
    constexpr int kLanes = D / kVec;           // lanes per position
    constexpr int kSlots = kThreads / kLanes;  // positions per pass
    static_assert(kLanes <= 32 && 32 % kLanes == 0, "lanes per position");
    extern __shared__ float smem[];
    __shared__ float s_m[G], s_l[G], s_alpha[G];

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int n_split = gridDim.x;
    const int piece = threadIdx.x % kLanes;
    const int slot = threadIdx.x / kLanes;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    const int len = lengths[b];
    const int hi = len > 0 ? min(len, S) : S;   // len <= 0: mean of all v
    const int lo_pos = split * split_len;
    const int end = min(lo_pos + split_len, hi);

    const int64_t h0 = (int64_t)b * H + (int64_t)kvh * G;
    float qf[G][kVec];
    float acc[G][kVec];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        unpack<T, kVec>(*reinterpret_cast<const uint4*>(
                            q + (h0 + g) * D + piece * kVec), qf[g]);
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[g][c] = 0.f;
    }
    if (threadIdx.x < G) {
        s_m[threadIdx.x] = -INFINITY;
        s_l[threadIdx.x] = 0.f;
    }
    __syncthreads();

    const int64_t row_stride = (int64_t)Hkv * D;       // one position
    const uint4* kb = reinterpret_cast<const uint4*>(
        k + ((int64_t)b * S * Hkv + kvh) * D + piece * kVec);
    const uint4* vb = reinterpret_cast<const uint4*>(
        v + ((int64_t)b * S * Hkv + kvh) * D + piece * kVec);
    const int64_t vec_stride = row_stride / kVec;      // in uint4

    for (int t0 = lo_pos; t0 < end; t0 += block_k) {
        const int tile_n = min(block_k, end - t0);
        // scores: every lane runs the same trip count for the shuffles;
        // kUnroll positions' loads start before any is used
        for (int i0 = 0; i0 < tile_n; i0 += kSlots * kUnroll) {
            uint4 kr[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = i0 + u * kSlots + slot;
                if (i < tile_n) kr[u] = kb[(int64_t)(t0 + i) * vec_stride];
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = i0 + u * kSlots + slot;
                float part[G];
#pragma unroll
                for (int g = 0; g < G; ++g) part[g] = 0.f;
                if (i < tile_n) {
                    float kf[kVec];
                    unpack<T, kVec>(kr[u], kf);
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int c = 0; c < kVec; ++c)
                            part[g] = fmaf(qf[g][c], kf[c], part[g]);
                }
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int off = kLanes / 2; off > 0; off >>= 1)
                        part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
                if (i < tile_n && piece == 0) {
                    const bool valid = t0 + i < len;
#pragma unroll
                    for (int g = 0; g < G; ++g)
                        smem[g * block_k + i] = valid ? part[g] * scale
                                                      : kNegInf;
                }
            }
        }
        __syncthreads();
        // one warp per head: tile max, p = exp(s - m), running l
        for (int g = warp; g < G; g += kWarps) {
            float* sg = smem + g * block_k;
            float mx = -INFINITY;
            for (int i = lane; i < tile_n; i += 32) mx = fmaxf(mx, sg[i]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_old = s_m[g];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int i = lane; i < tile_n; i += 32) {
                const float p = __expf(sg[i] - m_new);
                sg[i] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
                const float alpha = __expf(m_old - m_new);
                s_alpha[g] = alpha;
                s_l[g] = s_l[g] * alpha + sum;
                s_m[g] = m_new;
            }
        }
        __syncthreads();
        // acc = acc * alpha + sum_i p_i v_i over this lane's slice
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const float alpha = s_alpha[g];
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[g][c] *= alpha;
        }
        for (int i0 = slot; i0 < tile_n; i0 += kSlots * kUnroll) {
            uint4 vr[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = i0 + u * kSlots;
                if (i < tile_n) vr[u] = vb[(int64_t)(t0 + i) * vec_stride];
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = i0 + u * kSlots;
                if (i < tile_n) {
                    float vf[kVec];
                    unpack<T, kVec>(vr[u], vf);
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        const float p = smem[g * block_k + i];
#pragma unroll
                        for (int c = 0; c < kVec; ++c)
                            acc[g][c] = fmaf(p, vf[c], acc[g][c]);
                    }
                }
            }
        }
        __syncthreads();
    }

    // sum the slots' partial acc, write this split's (m, l, acc)
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < kVec; ++c)
            smem[(slot * G + g) * D + piece * kVec + c] = acc[g][c];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
        float a = 0.f;
        for (int s = 0; s < kSlots; ++s) a += smem[s * G * D + idx];
        const int g = idx / D, d = idx % D;
        acc_part[((h0 + g) * n_split + split) * D + d] = a;
    }
    if (threadIdx.x < G) {
        m_part[(h0 + threadIdx.x) * n_split + split] = s_m[threadIdx.x];
        l_part[(h0 + threadIdx.x) * n_split + split] = s_l[threadIdx.x];
    }
}

// One CTA per (b, h): rescale the splits to their common max and divide.
// A split past the row's length holds m = -inf and weighs exp(-inf) = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part, T* __restrict__ out,
                      int n_split, int D) {
    const int64_t bh = blockIdx.x;
    const float* mp = m_part + bh * n_split;
    const float* lp = l_part + bh * n_split;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, mp[s]);
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) l += lp[s] * __expf(mp[s] - mx);
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    for (int d = threadIdx.x; d < D; d += kThreads) {
        float a = 0.f;
        for (int s = 0; s < n_split; ++s)
            a += acc_part[(bh * n_split + s) * D + d] * __expf(mp[s] - mx);
        out[bh * D + d] = from_f<T>(a * inv_l);
    }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int H, int Hkv, int S, int block_k, int n_split, int split_len,
           cudaStream_t stream) {
    constexpr int kSlots = kThreads / (D / (16 / sizeof(T)));
    const int score_floats = G * block_k;
    const int sum_floats = kSlots * G * D;
    const size_t smem = sizeof(float) *
        (size_t)(score_floats > sum_floats ? score_floats : sum_floats);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(decode_split_kernel<T, D, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    }
    const float scale = 1.f / sqrtf((float)D);
    decode_split_kernel<T, D, G><<<dim3(n_split, Hkv, B), kThreads, smem,
                                   stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
        m_part, l_part, acc_part, H, Hkv, S, block_k, split_len, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
        m_part, l_part, acc_part, (T*)out, n_split, D);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_group(int group, const void* q, const void* k, const void* v,
                 const void* lengths, void* out, float* mp, float* lp,
                 float* ap, int B, int H, int Hkv, int S, int block_k,
                 int n_split, int split_len, cudaStream_t s) {
    switch (group) {
    case 1:
        return launch<T, D, 1>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, block_k, n_split, split_len, s);
    case 2:
        return launch<T, D, 2>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, block_k, n_split, split_len, s);
    case 4:
        return launch<T, D, 4>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, block_k, n_split, split_len, s);
    case 8:
        return launch<T, D, 8>(q, k, v, lengths, out, mp, lp, ap, B, H, Hkv,
                               S, block_k, n_split, split_len, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,) int32; out: (B, H, D);
// all contiguous on the device, 16-byte aligned. m_part, l_part:
// (B, H, n_split) f32 scratch; acc_part: (B, H, n_split, D) f32 scratch.
// D in {64, 128}; H / Hkv in {1, 2, 4, 8}; split_len a multiple of block_k with
// n_split * split_len >= S. dtype: 0 float32, 1 bfloat16.
int decode_attn_launch(const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* m_part,
                       void* l_part, void* acc_part, int B, int H, int Hkv,
                       int S, int D, int block_k, int n_split, int split_len,
                       int dtype, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    float* mp = (float*)m_part;
    float* lp = (float*)l_part;
    float* ap = (float*)acc_part;
    const int g = H / Hkv;
    if (dtype == 0 && D == 64)
        return launch_group<float, 64>(g, q, k, v, lengths, out, mp, lp, ap,
                                       B, H, Hkv, S, block_k, n_split,
                                       split_len, s);
    if (dtype == 0 && D == 128)
        return launch_group<float, 128>(g, q, k, v, lengths, out, mp, lp, ap,
                                        B, H, Hkv, S, block_k, n_split,
                                        split_len, s);
    if (dtype == 1 && D == 64)
        return launch_group<__nv_bfloat16, 64>(g, q, k, v, lengths, out, mp,
                                               lp, ap, B, H, Hkv, S, block_k,
                                               n_split, split_len, s);
    if (dtype == 1 && D == 128)
        return launch_group<__nv_bfloat16, 128>(g, q, k, v, lengths, out, mp,
                                                lp, ap, B, H, Hkv, S,
                                                block_k, n_split, split_len,
                                                s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
