// Fused GEMM + LeakyReLU for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/gemm_fused/kernel.py:89 `pallas_gemm_leaky_relu`
// (pallas_call at :105).  y = LeakyReLU(x @ w) with alpha 0.01; x (m, K) and
// w (K, n) row-major, fp32 or bf16 in and out, sums in fp32.
//
// The body is `Program.emit(order)` of gemm_fused/kernel.py::make_program.
// Per k step s the MEM instructions ld_x{s} (a BM x BK tile of x) and ld_w{s}
// (a BK x BN tile of w) copy into buffers X{s}, W{s} of their own in shared
// memory with cp.async and commit one group each; the COMPUTE instruction
// dot{s} adds their product into acc, registers updated in place (the IR's
// acc{s} chain is totally ordered); the LeakyReLU epilogue runs in registers
// before the one store.  Buffers are placed by liveness in the schedule's
// order, and kernels/_emit.py::AsyncPlanner puts cp_async_wait<N>() and
// __syncthreads() ahead of each group's first reader.  So the order is the
// software pipeline: the default (load, load, dot per step) keeps no copy in
// flight during a product; hoisting step s+1's loads above dot{s} keeps one
// step in flight, paid for in shared memory.
//
// bf16 (GEMM_WGMMA 1): one warpgroup (128 threads) per 64 rows and up to 256
// columns of the tile; dot{s} issues wgmma m64nBNWk16 per 16 of BK, both
// operands read from shared memory by descriptor, the fp32 accumulator in
// registers.  Shared memory holds the no-swizzle core-matrix layout (8 rows
// x 16 bytes, 128 contiguous bytes): chunk e of a copy lands at byte 16 e,
// so a warp's 16-byte copies fill 512 contiguous bytes (no bank conflicts)
// and read 64 contiguous bytes of 8 rows of global memory; the 128-byte
// swizzle would need tiles of 64 K elements, and the knob space offers BK 8.
// X (MP x KP) is K-major: core (8-row group i, K chunk j) at (i KP/8 + j) 128
// bytes, so LBO 128 and SBO 16 KP.  W (KP x BN) is N-major (the transpose
// bit): core (8-row K group i, N chunk j) at (i BN/8 + j) 128 bytes, so LBO
// 16 BN and SBO 128.  A tile smaller than the instruction (BM < 64, BK < 16)
// is zero-filled in shared memory to MP = 64 rows, KP = 16; the padded rows
// are never stored.
//
// f32 (GEMM_WGMMA 0): the 3xTF32 split on mma.sync m16n8k8: a = a_hi + a_lo,
// b likewise, and acc += a_lo b_hi + a_hi b_lo + a_hi b_hi per k8 step, each
// product in tf32, the step's sum added to acc in fp32 (rounded to nearest),
// near float32 rounding of the fp32 product where plain TF32 misses the
// oracle at K 2048.  Warps in a WR x WC grid each own
// MT x NTL tiles of 16 x 8; tiles stay row-major with a 16-byte pad per row
// (LDX = BK + 4, LDW = BN + 8 floats: conflict-free fragment reads); BM < 16
// is zero-filled to 16 rows.
//
// What bounds it on the H100: at the paper's shape (512 x 512 x 2048, bf16)
// the least time is 1.41 us for its 4.72 MB against 1.09 us for its 1.07
// GFLOP on the tensor cores, so bytes.  The default tile (128, 128, 128)
// gives 16 blocks on 132 SMs, each of which streams 1 MB through cp.async
// with no TMA and no producer warp; more blocks or a deeper order is what
// the search can buy.
//
// Grid (ceil(m / BM), ceil(n / BN)); NT threads.

#if GEMM_WGMMA
// the tile's global rows r < rows and chunks c < chunks hold data; the rest of
// the RP x CP-chunk tile is zero-filled.  Chunk e lands at element 8 e.
template <int RP, int CP>
__device__ __forceinline__ void load_cores(const T* __restrict__ src, T* __restrict__ dst,
                                           size_t ld, int rows, int chunks) {
#pragma unroll 4
    for (int e = threadIdx.x; e < RP * CP; e += NT) {
        const int r = (e / (8 * CP)) * 8 + e % 8, c = (e / 8) % CP;
        const bool ok = r < rows && c < chunks;
        cp_async16(dst + 8 * e, src + (ok ? r * ld + 8 * c : 0), ok);
    }
}

__device__ __forceinline__ void load_x(const T* __restrict__ x, T* __restrict__ dst, int row0,
                                       int k0) {
    load_cores<MP, KP / 8>(x + (size_t)row0 * KDIM + k0, dst, KDIM, BM, BK / 8);
}

__device__ __forceinline__ void load_w(const T* __restrict__ w, T* __restrict__ dst, int k0,
                                       int col0, int n) {
    load_cores<KP, BN / 8>(w + (size_t)k0 * n + col0, dst, n, BK, BN / 8);
}

__device__ __forceinline__ void dot_tile(const T* __restrict__ xs, const T* __restrict__ ws,
                                         float (&acc)[NACC]) {
    const int wg = threadIdx.x / 128, wm = wg % WM, wn = wg / WM;
    const T* xa = xs + 64 * wm * KP;          // the warpgroup's 64-row strip
    const T* wb = ws + 8 * wn * BNW;          // and its BNW columns
    fence_regs<NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk)
        wgmma_bf16<BNW>(acc, smem_desc(xa + 128 * kk, A_LBO, A_SBO),
                        smem_desc(wb + 16 * BN * kk, B_LBO, B_SBO));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NACC>(acc);
}

// accumulator i of a thread: row 16 warp + lane / 4 + 8 (i / 2 % 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2 of its warpgroup's 64 x BNW tile
__device__ __forceinline__ void acc_at(int i, int& r, int& c) {
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    r = 64 * (wg % WM) + 16 * ((threadIdx.x / 32) % 4) + lane / 4 + 8 * ((i / 2) % 2);
    c = BNW * (wg / WM) + 8 * (i / 4) + 2 * (lane % 4);
}
#else
__device__ __forceinline__ void load_x(const T* __restrict__ x, T* __restrict__ dst, int row0,
                                       int k0) {
    constexpr int CH = BK / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < MP * CH; e += NT) {
        const int r = e / CH, c = e % CH;
        const bool ok = r < BM;
        cp_async16(dst + r * LDX + 4 * c, x + (ok ? (size_t)(row0 + r) * KDIM + k0 + 4 * c : 0),
                   ok);
    }
}

__device__ __forceinline__ void load_w(const T* __restrict__ w, T* __restrict__ dst, int k0,
                                       int col0, int n) {
    constexpr int CH = BN / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < BK * CH; e += NT) {
        const int r = e / CH, c = e % CH;
        cp_async16(dst + r * LDW + 4 * c, w + (size_t)(k0 + r) * n + col0 + 4 * c, true);
    }
}

__device__ __forceinline__ void dot_tile(const T* __restrict__ xs, const T* __restrict__ ws,
                                         float (&acc)[NACC]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* xa = xs + (warp % WR) * MT * 16 * LDX;
    const float* wb = ws + (warp / WR) * NTL * 8;
#pragma unroll 2
    for (int kk = 0; kk < BK / 8; ++kk) {
        unsigned ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                split_tf32(xa[(16 * mt + g + 8 * (q & 1)) * LDX + 8 * kk + t + 4 * (q >> 1)],
                           ah[mt][q], al[mt][q]);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
            unsigned bh0, bl0, bh1, bl1;
            split_tf32(wb[(8 * kk + t) * LDW + 8 * nt + g], bh0, bl0);
            split_tf32(wb[(8 * kk + t + 4) * LDW + 8 * nt + g], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                // the tensor cores' fp32 sums are not rounded to nearest
                // (their errors share a sign and grow with K), so each k8
                // step's three products start from zero and join acc by a
                // rounded fp32 add
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                mma_tf32_1688(d, al[mt], bh0, bh1);
                mma_tf32_1688(d, ah[mt], bl0, bl1);
                mma_tf32_1688(d, ah[mt], bh0, bh1);
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[4 * (mt * NTL + nt) + q] += d[q];
            }
        }
    }
}

// accumulator i = 4 (mt NTL + nt) + q of a thread: row 16 mt + lane / 4 +
// 8 (q / 2), column 8 nt + 2 (lane % 4) + q % 2 of its warp's tile
__device__ __forceinline__ void acc_at(int i, int& r, int& c) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    r = (warp % WR) * MT * 16 + 16 * (i / (4 * NTL)) + lane / 4 + 8 * ((i % 4) / 2);
    c = (warp / WR) * NTL * 8 + 8 * ((i / 4) % NTL) + 2 * (lane % 4);
}
#endif

__device__ __forceinline__ void store_o(T* __restrict__ o, const float (&acc)[NACC], int row0,
                                        int col0, int m, int n) {
#pragma unroll
    for (int i = 0; i < NACC; i += 2) {
        int r, c;
        acc_at(i, r, c);
        if (r < BM && row0 + r < m) store2(o + (size_t)(row0 + r) * n + col0 + c, acc[i], acc[i + 1]);
    }
}

extern "C" __global__ void __launch_bounds__(NT)
gemm_fused_leaky_relu(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ o,
                      int m, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
/*@BUFFERS@*/
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    float acc[NACC];
/*@BODY@*/
}
