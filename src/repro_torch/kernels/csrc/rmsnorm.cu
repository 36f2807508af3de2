// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_kernel (body
// _rmsnorm_kernel), the TPU kernel that keeps a block of rows with its full
// feature dimension in VMEM.
//
// Computes, for each row of x (R, D): var = mean(f32(x)^2) in f32, then
// y = x * rsqrt(var + eps) rounded to x's type, then y * scale rounded
// again -- the reference's cast order, which decides bf16 bits.
//
// Bound on the card: bytes. The function reads x once and writes the output
// once (scale is D elements), so the least time is
// (2 * R * D + D) * sizeof(T) / 3.35 TB/s (H100 SXM HBM3); at the full-width
// input (32768 x 4096 bf16) that is 536,879,104 bytes, 0.160 ms. Two flops
// per element put it far below the tensor-core line.
//
// Design: one warp per row, so a row's sum of squares is a warp shuffle
// reduction in a fixed order and never sees another row: block_rows (rows
// per CTA, the registry's exact axis) only decides which CTA a row goes to,
// and the output is bit-identical for every block_rows. Each lane moves
// 16-byte vectors, neighbouring lanes on neighbouring addresses. The first
// kCache vectors of each lane stay in registers between the two passes (the
// whole row for D <= 4096 bf16 or 2048 f32), so x is read from device
// memory once; longer rows re-read the tail, which the L1 cache holds.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared) and bound with
// ctypes: the entry point takes raw device pointers and the caller's
// stream, launches, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 16;       // 16-byte vectors a lane keeps in registers

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

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& u) {
    constexpr int kVec = 16 / sizeof(T);
    const T* e = reinterpret_cast<const T*>(&u);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
        const float f = to_f(e[c]);
        s = fmaf(f, f, s);
    }
    return s;
}

template <typename T>
__device__ __forceinline__ uint4 normalize(const uint4& u, const uint4& sc,
                                           float inv) {
    constexpr int kVec = 16 / sizeof(T);
    const T* e = reinterpret_cast<const T*>(&u);
    const T* s = reinterpret_cast<const T*>(&sc);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
        const T y = from_f<T>(to_f(e[c]) * inv);
        oe[c] = from_f<T>(to_f(y) * to_f(s[c]));
    }
    return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int d, float eps,
               int block_rows) {
    constexpr int kVec = 16 / sizeof(T);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nvec = d / kVec;
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    const int64_t row0 = (int64_t)blockIdx.x * block_rows;
    for (int r = warp; r < block_rows; r += kWarps) {
        const int64_t row = row0 + r;
        if (row >= rows) break;
        const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
        uint4* orow = reinterpret_cast<uint4*>(out + row * d);
        uint4 buf[kCache];
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < kCache; ++j) {
            const int i = lane + 32 * j;
            if (i < nvec) {
                buf[j] = xr[i];
                ss += sum_squares<T>(buf[j]);
            }
        }
        for (int i = lane + 32 * kCache; i < nvec; i += 32) {
            ss += sum_squares<T>(xr[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            ss += __shfl_xor_sync(0xffffffffu, ss, off);
        }
        const float inv = rsqrtf(ss / (float)d + eps);
#pragma unroll
        for (int j = 0; j < kCache; ++j) {
            const int i = lane + 32 * j;
            if (i < nvec) orow[i] = normalize<T>(buf[j], sv[i], inv);
        }
        for (int i = lane + 32 * kCache; i < nvec; i += 32) {
            orow[i] = normalize<T>(xr[i], sv[i], inv);
        }
    }
}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous; scale: (d,); all of one type, 16-byte
// aligned, d * sizeof(T) a multiple of 16. dtype: 0 float32, 1 bfloat16.
int rmsnorm_launch(const void* x, const void* scale, void* out, int64_t rows,
                   int d, float eps, int block_rows, int dtype,
                   void* stream) {
    if (rows > 0) {
        const unsigned grid = (unsigned)((rows + block_rows - 1) / block_rows);
        cudaStream_t s = (cudaStream_t)stream;
        if (dtype == 0) {
            rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
                (const float*)x, (const float*)scale, (float*)out, rows, d,
                eps, block_rows);
        } else {
            rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
                (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
                (__nv_bfloat16*)out, rows, d, eps, block_rows);
        }
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
