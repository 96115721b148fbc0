// Paged KV-cache gather for Hopper (sm_90a): out[b, i] = store[page_table[b, i]].
//
// Replaces: repro/kernels/paged_attention/kernel.py:65 `paged_gather`
// (pallas_call at :87).  store (P, ps, H, D) and an int32 page table (B, n)
// give (B, n, ps, H, D); the kernel is dtype-blind and copies whole pages of
// ps * H * D elements (fp32 or bf16).  Page ids are trusted, as in the
// reference.
//
// What bounds it on the H100: it does no arithmetic, so its least time is
// the bytes it moves, each page read once and written once, over the 3.35
// TB/s of device memory.  At the paged decode step of the main path
// (qwen3-1.7b, page 16 x 8 x 128 bf16 = 32 KB) one call moves a few MB.
//
// Design: one block per (b, i) table entry.  The block reads its page id
// once from the table (the TPU's scalar prefetch, kernel.py:79-86, becomes
// this one load) and copies the contiguous page with 16-byte vector loads
// and stores, neighbouring threads on neighbouring addresses, each thread
// issuing eight loads before its eight stores.  A page whose
// size is not a multiple of 16 bytes takes a 2-byte copy instead.  One fixed
// schedule (256 threads); making it a SIP search space is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

constexpr int UNROLL = 8;     // loads in flight per thread before its stores

template <typename U>
__global__ void __launch_bounds__(NT)
gather_pages(const U* __restrict__ store, const int* __restrict__ page_table,
             U* __restrict__ out, long long units_per_page) {
    const long long entry = blockIdx.x;
    const long long page = page_table[entry];
    const U* src = store + page * units_per_page;
    U* dst = out + entry * units_per_page;
    for (long long base = threadIdx.x; base < units_per_page; base += NT * UNROLL) {
        U r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * NT;
            if (i < units_per_page) r[u] = src[i];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * NT;
            if (i < units_per_page) dst[i] = r[u];
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// store: num_pages contiguous pages of `page_bytes` bytes; page_table:
// n_entries int32 page ids; out: n_entries pages.  Returns the CUDA error of
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int paged_gather(const void* store, const void* page_table, void* out,
                            long long n_entries, long long page_bytes, void* stream) {
    if (n_entries < 0 || n_entries > 0x7fffffffLL || page_bytes <= 0 || page_bytes % 2 != 0)
        return (int)cudaErrorInvalidValue;
    if (n_entries == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(page_table);
    if (page_bytes % 16 == 0 && aligned16(store) && aligned16(out)) {
        gather_pages<uint4><<<(unsigned)n_entries, NT, 0, s>>>(
            static_cast<const uint4*>(store), pt, static_cast<uint4*>(out), page_bytes / 16);
    } else {
        gather_pages<uint16_t><<<(unsigned)n_entries, NT, 0, s>>>(
            static_cast<const uint16_t*>(store), pt, static_cast<uint16_t*>(out),
            page_bytes / 2);
    }
    return (int)cudaGetLastError();
}
