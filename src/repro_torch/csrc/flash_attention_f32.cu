// Flash-attention forward for Hopper (sm_90a), float32: the operand path of
// the tensor-core kernel, emitted ahead of flash_attention.cu (with TF32 1),
// which holds the loads, masks, online softmax, store and the kernel itself.
//
// Replaces: repro/kernels/flash_attention/kernel.py:179 `pallas_attention`
// (pallas_call at :210) for float32 calls: the registry's workloads, the
// 4-layer differential serve run and bidirectional f32 calls.
//
// Both products run 3xTF32 on mma.sync m16n8k8, one warp per 16-row strip:
// each operand is split x = hi + lo (split_trunc) and a product is
// lo hi + hi lo + hi hi, accumulated by the tensor cores straight into the
// fp32 scores and output registers.  Their fp32 sums are not rounded to
// nearest, but a score sums at most D / 8 = 16 steps and the output's sums
// are rescaled per kv block, so their error stays far under float32's
// tolerance here, where gemm_fused.cu's K of 2048 steps needs a rounded add
// per step; the adds would cost registers (ptxas spilled at D 128) and
// time.  Fragments come from 32-bit shared loads (ldmatrix moves 16-bit
// elements): Q and K are read as (row lane / 4, column lane % 4), V as
// (row 2 (lane % 4), column lane / 4), and the row stride LD = DP + 4 floats
// puts a quad's reads on distinct banks in both.
//
// P as the A operand, without shuffles: the accumulator of key tile j holds
// keys 2 t and 2 t + 1 of a thread's rows (t = lane % 4), where the A
// fragment wants k = t and k = t + 4.  So pv_tile reads key 2 t as k = t and
// key 2 t + 1 as k = t + 4, and takes V's rows 2 t and 2 t + 1 as B's k = t
// and k = t + 4: the same keys in another order, the same sum.
//
// What bounds it on the H100: its operations at the float32 rate, 67
// TFLOP/s (B4 S128 D128 causal: 4.04 us against 3.76 us for its bytes); the
// tensor cores run the three TF32 products of each at up to 495 TFLOP/s, and
// the splits, one per operand element read, run on the CUDA cores.

// x = hi + lo: hi keeps x's top 19 bits (a tf32 value, cut toward zero) and
// lo = x - hi exactly, passed whole: mma reads only the top 19 bits of a tf32
// operand, so lo is cut to tf32 there.  Two instructions where split_tf32's
// rounding takes more; lo hi + hi lo + hi hi keeps about 21 of float32's 24
// mantissa bits.
__device__ __forceinline__ void split_trunc(float x, unsigned& hi, unsigned& lo) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// fragment element q of key tile j: row lane / 4 + 8 (q / 2) of the warp's
// strip, key 8 j + 2 (lane % 4) + q % 2 of the chunk
__device__ __forceinline__ void qk_tile(const float* __restrict__ qs, const float* __restrict__ ks,
                                        float (&s)[NTK][4]) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* qa = qs + 16 * (threadIdx.x / 32) * LD;
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
        // A: rows g, g + 8 and columns t, t + 4 of the strip's k8 slice
        unsigned ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            split_trunc(qa[(g + 8 * (q & 1)) * LD + 8 * kk + t + 4 * (q >> 1)], ah[q], al[q]);
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
            // B (column-major K^T): key 8 j + g, columns t and t + 4
            unsigned bh0, bl0, bh1, bl1;
            const float* kr = ks + (8 * j + g) * LD + 8 * kk + t;
            split_trunc(kr[0], bh0, bl0);
            split_trunc(kr[4], bh1, bl1);
            mma_tf32_1688(s[j], al, bh0, bh1);
            mma_tf32_1688(s[j], ah, bl0, bl1);
            mma_tf32_1688(s[j], ah, bh0, bh1);
        }
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] *= SCALE;
}

// acc (d tile n, element q: row lane / 4 + 8 (q / 2), column 8 n + 2 (lane %
// 4) + q % 2) += p V{c}, keys permuted inside each k8 slice (see above)
__device__ __forceinline__ void pv_tile(const float (&p)[NTK][4], const float* __restrict__ vs,
                                        float (&acc)[NTD][4]) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < NTK; ++kk) {
        // A: (row g, key 2t), (row g + 8, key 2t), (row g, key 2t + 1),
        // (row g + 8, key 2t + 1)
        unsigned ah[4], al[4];
        split_trunc(p[kk][0], ah[0], al[0]);
        split_trunc(p[kk][2], ah[1], al[1]);
        split_trunc(p[kk][1], ah[2], al[2]);
        split_trunc(p[kk][3], ah[3], al[3]);
        const float* vr = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NTD; ++n) {
            unsigned bh0, bl0, bh1, bl1;
            split_trunc(vr[8 * n], bh0, bl0);
            split_trunc(vr[LD + 8 * n], bh1, bl1);
            mma_tf32_1688(acc[n], al, bh0, bh1);
            mma_tf32_1688(acc[n], ah, bl0, bl1);
            mma_tf32_1688(acc[n], ah, bh0, bh1);
        }
    }
}
