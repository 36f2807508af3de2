// Compaction kernels for Hopper (sm_90a): the AutoComp rewrite inner loop.
//
// Token shards are laid out in 1024-token chunks of 8 rows x 128 columns,
// so compacting fragments into target-size files is a permutation of whole
// chunks, and a rewrite-delete is the same permutation with some 128-token
// rows left out. Both kernels below are pure data movement: they move bytes
// and never look at them, so they are bit-exact for every dtype.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes: every entry point takes raw device pointers and
// the caller's stream, launches, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // 16-byte vectors in flight per thread
constexpr int kChunkRows = 8;
constexpr int kDropSlot = 127;   // plan_filter's sentinel for a dropped row

// compact_chunks: out[i] = src[chunk_map[i]] over blocks of g*8 rows.
//
// Replaces src/repro/kernels/compact_pack/compact_pack.py::
// compact_chunks_kernel (body _copy_kernel), the scalar-prefetched DMA
// gather on the TPU.
//
// Bound on the card: bytes. Every output block is read once and written
// once, so the least time is 2 * n_out * block_bytes / 3.35 TB/s (H100
// SXM HBM3); at one 511-file bin of the main path (130,816 chunks,
// 511 MiB each way) that is about 0.32 ms.
//
// Design: one CTA per output block (a block is g*8 rows of 128 elements,
// 4 KiB to 64 KiB of int32). The CTA reads its own chunk_map entry -- the
// GPU counterpart of scalar prefetch -- and copies the block with 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses,
// kUnroll vectors in flight per thread so each SM keeps enough bytes
// outstanding to cover HBM latency. Loads and stores use the streaming
// (evict-first) hints: every byte is touched once and the working set is
// far above the 50 MB L2. Offsets are 64-bit, so sources beyond 2 GiB stay
// correct. Larger g means fewer, larger CTAs; the block_chunks axis maps
// to it and coarsen_plan decides which g a plan supports.
__global__ void __launch_bounds__(kThreads)
compact_chunks_kernel(const uint4* __restrict__ src, uint4* __restrict__ out,
                      const int32_t* __restrict__ chunk_map,
                      int64_t block_vecs) {
    const int64_t o = blockIdx.x;
    const int64_t s = chunk_map[o];
    const uint4* from = src + s * block_vecs;
    uint4* to = out + o * block_vecs;
    for (int64_t base = threadIdx.x; base < block_vecs;
         base += (int64_t)kThreads * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t k = base + (int64_t)u * kThreads;
            v[u] = k < block_vecs ? __ldcs(from + k) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int64_t k = base + (int64_t)u * kThreads;
            if (k < block_vecs) __stcs(to + k, v[u]);
        }
    }
}

// compact_filter: the fused filter+pack of a rewrite-delete.
//
// Replaces src/repro/kernels/compact_pack/compact_pack.py::
// compact_filter_kernel (body _filter_kernel).
//
// Bound on the card: bytes. The function must read each kept row once and
// write each output row once (plus the small plan tables), so the least
// time is (kept_rows + out_rows) * row_bytes / 3.35 TB/s (H100 SXM).
//
// Design: the TPU kernel walks the touched chunks in order through a
// 16-row staging window with a VMEM carry, because its grid is sequential.
// Here every step is independent. plan_filter's tables give each kept row
// its final place directly: row j of step i lands at output row
// 8*out_idx[i] + dest[8*i + j], which equals the count of kept rows before
// it, so each output row is written by exactly one thread -- no atomics,
// no carry, deterministic. One CTA per step; each thread moves one 16-byte
// piece of a row. Dropped rows are never read (the TPU kernel reads the
// whole touched chunk); fully dropped chunks have no step at all; the flush
// step plan_filter may append (every row DROP_SLOT) does nothing. CTA 0
// also zero-fills the padding rows [n_kept_rows, n_out_rows) of the last
// output chunk, which no kept row touches, so the wrapper can hand in an
// uninitialised output.
__global__ void __launch_bounds__(kThreads)
compact_filter_kernel(const uint4* __restrict__ src, uint4* __restrict__ out,
                      const int32_t* __restrict__ chunk_sel,
                      const int32_t* __restrict__ out_idx,
                      const int32_t* __restrict__ dest,
                      int64_t row_vecs, int64_t n_kept_rows,
                      int64_t n_out_rows) {
    const int64_t i = blockIdx.x;
    const int64_t chunk_vecs = kChunkRows * row_vecs;
    const uint4* from = src + (int64_t)chunk_sel[i] * chunk_vecs;
    const int64_t out_row0 = (int64_t)kChunkRows * out_idx[i];
    for (int64_t k = threadIdx.x; k < chunk_vecs; k += kThreads) {
        const int64_t j = k / row_vecs;
        const int d = dest[i * kChunkRows + j];
        if (d != kDropSlot) {
            const int64_t c = k - j * row_vecs;
            __stcs(out + (out_row0 + d) * row_vecs + c, __ldcs(from + k));
        }
    }
    if (i == 0) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int64_t k = n_kept_rows * row_vecs + threadIdx.x;
             k < n_out_rows * row_vecs; k += kThreads) {
            out[k] = zero;
        }
    }
}

}  // namespace

extern "C" {

// src, out: 16-byte aligned device buffers; chunk_map: n_out int32 on the
// device; block_bytes: bytes of one gathered block (a multiple of 16).
int compact_chunks_launch(const void* src, void* out, const void* chunk_map,
                          int64_t n_out, int64_t block_bytes, void* stream) {
    if (n_out > 0) {
        compact_chunks_kernel<<<(unsigned)n_out, kThreads, 0,
                                (cudaStream_t)stream>>>(
            (const uint4*)src, (uint4*)out, (const int32_t*)chunk_map,
            block_bytes / 16);
    }
    return (int)cudaGetLastError();
}

// chunk_sel, out_idx: n_steps int32 on the device; dest: 8 * n_steps int32
// on the device; row_bytes: bytes of one 128-element row (a multiple of
// 16).
int compact_filter_launch(const void* src, void* out, const void* chunk_sel,
                          const void* out_idx, const void* dest,
                          int64_t n_steps, int64_t row_bytes,
                          int64_t n_kept_rows, int64_t n_out_rows,
                          void* stream) {
    if (n_steps > 0) {
        compact_filter_kernel<<<(unsigned)n_steps, kThreads, 0,
                                (cudaStream_t)stream>>>(
            (const uint4*)src, (uint4*)out, (const int32_t*)chunk_sel,
            (const int32_t*)out_idx, (const int32_t*)dest, row_bytes / 16,
            n_kept_rows, n_out_rows);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
