// Fused GEMM + LeakyReLU for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/gemm_fused/kernel.py:89 `pallas_gemm_leaky_relu`
// (pallas_call at :105).  y = LeakyReLU(x @ w) with alpha 0.01; x (m, K) and
// w (K, n) row-major, fp32 or bf16 in and out; products and sums in fp32 FMA.
// No TF32 and no bf16 products: with K = 2048 they miss the oracle's
// atol = 2e-2 near zero outputs.
//
// The body is `Program.emit(order)` of gemm_fused/kernel.py::make_program.
// Per k step s the MEM instructions ld_x{s} (a BM x BK tile of x) and ld_w{s}
// (a BK x BN tile of w) fill buffers X{s}, W{s} of their own in shared
// memory, and the COMPUTE instruction dot{s} adds their product into acc, one
// register accumulator per thread updated in place (the IR's acc{s} chain is
// totally ordered); the LeakyReLU epilogue runs in registers before the one
// store.  The #defines above and the buffer pointers below are filled per
// schedule: buffers are placed by liveness in the schedule's order, and
// __syncthreads() stands wherever an instruction reads or overwrites what
// other threads of the block touched since the last barrier.
//
// What bounds it on the H100: at the paper's shape (512 x 512 x 2048, bf16)
// the least time is 1.41 us for its 4.72 MB against 1.09 us for its 1.07
// GFLOP on the tensor cores, so bytes; this version multiplies on the CUDA
// cores in fp32 (67 TFLOP/s peak, about 16 us) and re-reads each operand
// from shared memory per FMA pair, far above either bound.  Tensor cores
// (wgmma), TMA and cp.async pipelines are later work.
//
// Grid (ceil(m / BM), ceil(n / BN)); NT = TR * TC threads; thread (ty, tx)
// owns rows ty + TR i (i < TM) and columns tx + TC j (j < TN) of the tile.

__device__ __forceinline__ void load_x(const T* __restrict__ x, T* __restrict__ dst, int row0,
                                       int k0, int m) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
        const int r = e / BK, c = e % BK, g = row0 + r;
        dst[r * LDX + c] = g < m ? x[(size_t)g * KDIM + k0 + c] : T(0);
    }
}

__device__ __forceinline__ void load_w(const T* __restrict__ w, T* __restrict__ dst, int k0,
                                       int col0, int n) {
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN, g = col0 + c;
        dst[r * LDW + c] = g < n ? w[(size_t)(k0 + r) * n + g] : T(0);
    }
}

__device__ __forceinline__ void dot_tile(const T* __restrict__ xs, const T* __restrict__ ws,
                                         float (&acc)[TM][TN]) {
    const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f(xs[(ty + TR * i) * LDX + kk]);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = to_f(ws[kk * LDW + tx + TC * j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

extern "C" __global__ void __launch_bounds__(NT)
gemm_fused_leaky_relu(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ o,
                      int m, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
/*@BUFFERS@*/
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
    float acc[TM][TN];
/*@BODY@*/
}
