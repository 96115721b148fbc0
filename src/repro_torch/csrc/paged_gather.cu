// Paged KV-cache gather for Hopper (sm_90a), emitted per SIP schedule:
// out[b, i] = store[page_table[b, i]].
//
// Replaces: repro/kernels/paged_attention/kernel.py:65 `paged_gather`
// (pallas_call at :87).  store (P, ps, H, D) and an int32 page table (B, n)
// give (B, n, ps, H, D); the kernel is dtype-blind and moves units of UNIT
// bytes.  Page ids follow the reference kernel's contract (its index map
// clamps the block index): an id in [-P, 0) wraps to id + P, and then every
// id is clamped into [0, P - 1], so an id outside [-P, P) reads the first or
// the last page, never outside the store.
//
// The body is `Program.emit(order)` of paged_attention/kernel.py::
// make_program: the page is cut into ROWS row blocks x NCH head-dim chunks,
// and each tile (r, c) is one MEM load into registers of its own, t{r}_{c},
// and one MEM store from them.  SIP reorders that copy stream (e.g. all
// loads before all stores, for more loads in flight).  Each thread stores
// only what it loaded, so no order needs a barrier.
//
// What bounds it on the H100: no arithmetic, so the bytes it moves, each
// page read once and written once, over 3.35 TB/s.
//
// One block per table entry; the block reads its page id once (the TPU's
// scalar prefetch, kernel.py:79-86, becomes this one load).

template <int R, int C>
__device__ __forceinline__ int tile_off(int e) {
    const int seg = e / CDU, u = e % CDU;
    return ((R * RB + seg / H) * H + seg % H) * DU + C * CDU + u;
}

template <int R, int C>
__device__ __forceinline__ void load_tile(const U* __restrict__ src, U (&t)[PER]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * NT;
        if (e < TU) t[i] = src[tile_off<R, C>(e)];
    }
}

template <int R, int C>
__device__ __forceinline__ void store_tile(U* __restrict__ dst, const U (&t)[PER]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * NT;
        if (e < TU) dst[tile_off<R, C>(e)] = t[i];
    }
}

extern "C" __global__ void __launch_bounds__(NT)
paged_gather(const U* __restrict__ store, const int* __restrict__ page_table,
             U* __restrict__ out, int num_pages) {
/*@BUFFERS@*/
    const long long entry = blockIdx.x;
    int page = page_table[entry];
    if (page < 0) page += num_pages;
    page = min(max(page, 0), num_pages - 1);
    const U* src = store + (size_t)page * PAGE_UNITS;
    U* dst = out + (size_t)entry * PAGE_UNITS;
/*@BODY@*/
}
