// Flash-attention forward for Hopper (sm_90a) on the tensor cores (mma.sync),
// emitted per SIP schedule: bf16 from this file alone, float32 with its
// operand path (qk_tile, pv_tile: 3xTF32) from flash_attention_f32.cu
// emitted ahead of it (TF32 1).
//
// Replaces: repro/kernels/flash_attention/kernel.py:179 `pallas_attention`
// (pallas_call at :210).  Computes the same function as that kernel and its
// oracle repro/kernels/flash_attention/ref.py:15: softmax attention over
// right-aligned rows (query i sits at position i + skv - sq), causal and
// sliding-window masks, GQA (query head h reads kv head h / (Hq / Hkv) of the
// same batch row), finite NEG_INF = -1e30 masking, p re-masked after the
// exp, and the output written as acc / max(l, 1e-30), so a row with no
// visible key is 0, never NaN.  bf16 or fp32 in and out, fp32 sums.
//
// The body is `Program.emit(order)` of flash_attention/kernel.py::
// make_program, placed inside the loop over kv blocks: the TPU's sequential
// kv grid axis becomes that loop, one block per (batch * query head, BQ-row
// query tile).  The FlashAttention-2 shape: warp w owns query rows
// [16 w, 16 w + 16) of the tile (BQ < 16 is zero-filled to one strip).  MEM
// instructions ld_q (first kv block only: q stays in its buffer), ld_k{c},
// ld_v{c} copy into shared buffers of their own with 16-byte cp.async and
// commit one group each, unconditionally; kernels/_emit.py::AsyncPlanner
// waits for a group ahead of its first reader, so hoisting ld_v{c} above
// qk/softmax overlaps V's copy with Q Kᵀ.  qk{c} writes the fp32 score
// fragments of the warp's strip; mask{c}, the online softmax (the running m
// and l, two rows a thread, reduced over the 4 threads of a quad with
// shuffles) and the rescale of the output accumulator stay in registers, so
// the IR's ld_stats / accum / st_stats emit nothing; pv{c} takes the
// probabilities from the score registers as A fragments; st_o writes acc / l
// on the last kv block.  Tiles keep D contiguous with a 16-byte pad per row
// (LD = DP + 16 bytes: no fragment read hits a bank twice); D, and chunks of
// keys, are zero-filled to the product's depth of 32 bytes (DP, CKP: 16
// bf16, 8 fp32).  Rows at or past sq and keys at or past kv_len (the real
// key length, at most skv; a padded call passes its unpadded length) are
// masked here, so no length has to divide a tile; kv blocks wholly above the
// causal diagonal, before the window or at or past kv_len are skipped.
//
// bf16 (below): qk{c} runs mma m16n8k16 with Q (ldmatrix) as A and K{c}
// (ldmatrix) as the column-major B; pv{c} repacks the score fragment as bf16
// A fragments and takes V{c} by ldmatrix.trans.
//
// What bounds it on the H100: at the main path's prefill shapes the least
// time is the bytes of q, k, v and o in bf16 (B4 S128 D128: 1.88 us), the
// operations at 67 TFLOP/s in fp32 (4.04 us); a block reads its kv head's K
// and V once per query tile, so 16 heads of a kv group and the tiles of a
// causal prefill re-read them from L2.

__device__ __forceinline__ bool visible(int qi, int col, int off, int sq, int kv_len) {
    bool ok = qi < sq && col < kv_len;
    const int row = qi + off;
    if (CAUSAL) ok = ok && col <= row;
    if (WINDOW > 0) ok = ok && col > row - WINDOW;
    return ok;
}

// rows [row0, row0 + ROWS) of src (D wide; rows at or past len are zero)
// into the ROWSP x DP tile dst at row stride LD, zero-filled past ROWS and D
template <int ROWS, int ROWSP>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, T* __restrict__ dst,
                                          int row0, int len) {
    constexpr int E = 16 / sizeof(T), CH = DP / E;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWSP * CH; e += NT) {
        const int r = e / CH, c = e % CH, g = row0 + r;
        const bool ok = r < ROWS && g < len && E * c < D;
        cp_async16(dst + r * LD + E * c, src + (ok ? (size_t)g * D + E * c : 0), ok);
    }
}

#if !TF32

// fragment element q of key tile j: row lane / 4 + 8 (q / 2) of the warp's
// strip, key 8 j + 2 (lane % 4) + q % 2 of the chunk
__device__ __forceinline__ void qk_tile(const T* __restrict__ qs, const T* __restrict__ ks,
                                        float (&s)[NTK][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, qs + (16 * warp + lane % 16) * LD + 16 * kk + 8 * (lane / 16));
#pragma unroll
        for (int j = 0; j < NTK; j += 2) {
            unsigned b[4];
            ldmatrix_x4(b, ks + (8 * j + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk
                               + 8 * ((lane / 8) % 2));
            mma_bf16_16816(s[j], a, b[0], b[1]);
            mma_bf16_16816(s[j + 1], a, b[2], b[3]);
        }
    }
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] *= SCALE;
}

// acc (d tile t, element q: row lane / 4 + 8 (q / 2), column 8 t + 2 (lane %
// 4) + q % 2) += p V{c}
__device__ __forceinline__ void pv_tile(const float (&p)[NTK][4], const T* __restrict__ vs,
                                        float (&acc)[NTD][4]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < CKP / 16; ++kk) {
        const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                               pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                               pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
        for (int t = 0; t < NTD; t += 2) {
            unsigned b[4];
            ldmatrix_x4_trans(b, vs + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 8 * t
                                     + 8 * (lane / 16));
            mma_bf16_16816(acc[t], a, b[0], b[1]);
            mma_bf16_16816(acc[t + 1], a, b[2], b[3]);
        }
    }
}

#endif

__device__ __forceinline__ bool seen(int j, int q, int c0, int q0, int off, int sq, int kv_len) {
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x / 32) + lane / 4 + 8 * (q / 2);
    const int col = 8 * j + 2 * (lane % 4) + q % 2;
    return r < BQ && col < CK && visible(q0 + r, c0 + col, off, sq, kv_len);
}

__device__ __forceinline__ void mask_tile(float (&s)[NTK][4], int c0, int q0, int off, int sq,
                                          int kv_len) {
#pragma unroll
    for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (!seen(j, q, c0, q0, off, sq, kv_len)) s[j][q] = NEG_INF;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the online softmax over this kv block's chunks: a thread's rows h = 0, 1
// are lane / 4 + 8 h of its warp's strip; scores become p in place
__device__ __forceinline__ void softmax_rows(float (&s)[NCH][NTK][4], float (&m)[2],
                                             float (&l)[2], float (&acc)[NTD][4], int kb,
                                             int q0, int off, int sq, int kv_len) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < NTK; ++j)
                mx = fmaxf(mx, fmaxf(s[c][j][2 * h], s[c][j][2 * h + 1]));
        const float m_new = fmaxf(m[h], quad_max(mx));
        const float corr = expf(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < NTK; ++j)
#pragma unroll
                for (int q = 2 * h; q < 2 * h + 2; ++q) {
                    const float p = seen(j, q, kb + c * CK, q0, off, sq, kv_len)
                                        ? expf(s[c][j][q] - m_new) : 0.f;
                    s[c][j][q] = p;
                    sum += p;
                }
        l[h] = corr * l[h] + quad_sum(sum);
        m[h] = m_new;
#pragma unroll
        for (int t = 0; t < NTD; ++t) {
            acc[t][2 * h] *= corr;
            acc[t][2 * h + 1] *= corr;
        }
    }
}

__device__ __forceinline__ void store_o(T* __restrict__ op, const float (&acc)[NTD][4],
                                        const float (&l)[2], int q0, int sq) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * (threadIdx.x / 32) + lane / 4 + 8 * h;
        if (r >= BQ || q0 + r >= sq) continue;
        const float l_safe = fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int t = 0; t < NTD; ++t) {
            const int c = 8 * t + 2 * (lane % 4);
            if (c < D)
                store2(op + (size_t)(q0 + r) * D + c, acc[t][2 * h] / l_safe,
                       acc[t][2 * h + 1] / l_safe);
        }
    }
}

extern "C" __global__ void __launch_bounds__(NT)
flash_attention(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int hq, int hkv, int sq, int skv, int kv_len) {
    extern __shared__ __align__(16) unsigned char smem[];
/*@BUFFERS@*/
    const int bh = blockIdx.x;
    const int b = bh / hq;
    const int kvh = b * hkv + (bh % hq) / (hq / hkv);
    const int q0 = blockIdx.y * BQ;
    const int off = skv - sq;
    const T* qp = q + (size_t)bh * sq * D;
    const T* kp = k + (size_t)kvh * skv * D;
    const T* vp = v + (size_t)kvh * skv * D;
    T* op = o + (size_t)bh * sq * D;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    float acc[NTD][4];
#pragma unroll
    for (int t = 0; t < NTD; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

    // keys any row of this tile can see: [kv_lo, kv_hi); a tile that sees
    // none still runs one fully masked block, which writes its zeros
    int kv_hi = kv_len;
    if (CAUSAL) kv_hi = min(kv_hi, q0 + BQ + off);
    int kv_lo = 0;
    if (WINDOW > 0) kv_lo = max(0, q0 + off - WINDOW + 1);
    kv_lo = kv_lo / BK * BK;
    if (kv_hi <= kv_lo) kv_hi = kv_lo + 1;
    for (int kb = kv_lo; kb < kv_hi; kb += BK) {
        const bool first = kb == kv_lo;
        const bool last = kb + BK >= kv_hi;
        float S[NCH][NTK][4];
        __syncthreads();
/*@BODY@*/
    }
}
