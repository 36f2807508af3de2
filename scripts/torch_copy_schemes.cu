// Two persistent designs of compact_chunks, kept for
// scripts/torch_copy_designs.py to time beside the shipped kernel
// (src/repro_torch/kernels/csrc/compact_pack.cu), which they did not beat. Both compute
// out[i] = src[chunk_map[i]] over blocks of block_bytes (a multiple of 16)
// in 4 KiB segments, bit for bit.
//
// warp_copy: a grid of n_ctas CTAs of 256 threads whose warps stride over
// the output's segments, two at a time: each lane loads 16 vectors (8 KiB a
// warp) before it stores any, with the streaming hints.
//
// bulk_copy: one thread per CTA drives a ring of 16 4-KiB shared-memory
// slots: cp.async.bulk loads complete on an mbarrier per slot, and
// cp.async.bulk stores go back out, 12 loads ahead and at most 4 stores
// reading the ring.
//
// Built by the script with nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared; not part of the package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegVecs = 256;        // 16-byte vectors of a segment
constexpr int kSegsInFlight = 2;     // warp_copy: segments before storing
constexpr int kSegBytes = 4096;      // bulk_copy: one ring slot
constexpr int kSlots = 16;
constexpr int kStoresPending = 4;

__global__ void __launch_bounds__(256, 2)
warp_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ out,
                 const int32_t* __restrict__ chunk_map, int64_t n_out,
                 int64_t block_vecs) {
    constexpr int kLaneVecs = kSegVecs / 32;
    const int64_t per_block = (block_vecs + kSegVecs - 1) / kSegVecs;
    const int64_t n_segs = n_out * per_block;
    const int lane = threadIdx.x % 32;
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int64_t n_warps = (int64_t)gridDim.x * (blockDim.x / 32);
    for (int64_t u0 = warp * kSegsInFlight; u0 < n_segs;
         u0 += n_warps * kSegsInFlight) {
        const uint4* from[kSegsInFlight];
        uint4* to[kSegsInFlight];
        int64_t lim[kSegsInFlight];
#pragma unroll
        for (int s = 0; s < kSegsInFlight; ++s) {
            const int64_t u = u0 + s;
            lim[s] = 0;
            from[s] = src;
            to[s] = out;
            if (u < n_segs) {
                const int64_t o = u / per_block;
                const int64_t base = (u - o * per_block) * kSegVecs;
                from[s] = src + (int64_t)chunk_map[o] * block_vecs + base;
                to[s] = out + o * block_vecs + base;
                lim[s] = block_vecs - base;
            }
        }
        uint4 r[kSegsInFlight][kLaneVecs];
#pragma unroll
        for (int s = 0; s < kSegsInFlight; ++s)
#pragma unroll
            for (int e = 0; e < kLaneVecs; ++e) {
                const int idx = e * 32 + lane;
                if (idx < lim[s]) r[s][e] = __ldcs(from[s] + idx);
            }
#pragma unroll
        for (int s = 0; s < kSegsInFlight; ++s)
#pragma unroll
            for (int e = 0; e < kLaneVecs; ++e) {
                const int idx = e * 32 + lane;
                if (idx < lim[s]) __stcs(to[s] + idx, r[s][e]);
            }
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

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

__global__ void __launch_bounds__(32)
bulk_copy_kernel(const char* __restrict__ src, char* __restrict__ out,
                 const int32_t* __restrict__ chunk_map, int64_t n_out,
                 int64_t block_bytes) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t bars[kSlots];
    if (threadIdx.x != 0) return;
    const int64_t per_block = (block_bytes + kSegBytes - 1) / kSegBytes;
    const int64_t n_segs = n_out * per_block;
    const int64_t c = blockIdx.x, grid = gridDim.x;
    if (c >= n_segs) return;
    const int64_t mine = (n_segs - c + grid - 1) / grid;
    for (int s = 0; s < kSlots; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_u32(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // segment i of this CTA: its output block, offset and bytes
    auto where = [&](int64_t i, int64_t* o, int64_t* base) {
        const int64_t u = c + i * grid;
        *o = u / per_block;
        *base = (u - *o * per_block) * kSegBytes;
        return (int)min((int64_t)kSegBytes, block_bytes - *base);
    };
    auto load = [&](int64_t i) {
        int64_t o, base;
        const int bytes = where(i, &o, &base);
        const int slot = (int)(i % kSlots);
        const uint32_t bar = smem_u32(&bars[slot]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(ring + slot * kSegBytes)),
               "l"(src + (int64_t)chunk_map[o] * block_bytes + base),
               "r"(bytes), "r"(bar) : "memory");
    };
    constexpr int kAhead = kSlots - kStoresPending;
    for (int64_t i = 0; i < kAhead && i < mine; ++i) load(i);
    for (int64_t i = 0; i < mine; ++i) {
        const int slot = (int)(i % kSlots);
        mbar_wait(smem_u32(&bars[slot]), (int)((i / kSlots) & 1));
        int64_t o, base;
        const int bytes = where(i, &o, &base);
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1],"
                     " %2;\n"
                     :: "l"(out + o * block_bytes + base),
                        "r"(smem_u32(ring + slot * kSegBytes)), "r"(bytes)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (i + kAhead < mine) {
            asm volatile("cp.async.bulk.wait_group.read %0;\n"
                         :: "n"(kStoresPending) : "memory");
            load(i + kAhead);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// n_ctas: the persistent grid (the script passes 2 per SM for warp_copy,
// 3 per SM for bulk_copy, as many as fit).
int warp_copy_launch(const void* src, void* out, const void* chunk_map,
                     int64_t n_out, int64_t block_bytes, int64_t n_ctas,
                     void* stream) {
    if (n_out > 0)
        warp_copy_kernel<<<(unsigned)n_ctas, 256, 0, (cudaStream_t)stream>>>(
            (const uint4*)src, (uint4*)out, (const int32_t*)chunk_map, n_out,
            block_bytes / 16);
    return (int)cudaGetLastError();
}

int bulk_copy_launch(const void* src, void* out, const void* chunk_map,
                     int64_t n_out, int64_t block_bytes, int64_t n_ctas,
                     void* stream) {
    if (n_out <= 0) return (int)cudaGetLastError();
    const int smem = kSlots * kSegBytes;
    cudaError_t err = cudaFuncSetAttribute(
        bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    bulk_copy_kernel<<<(unsigned)n_ctas, 32, smem, (cudaStream_t)stream>>>(
        (const char*)src, (char*)out, (const int32_t*)chunk_map, n_out,
        block_bytes);
    return (int)cudaGetLastError();
}

}  // extern "C"
