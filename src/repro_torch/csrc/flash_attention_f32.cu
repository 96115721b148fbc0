// Flash-attention forward for Hopper (sm_90a), float32, emitted per SIP
// schedule.  The bf16 kernel of the serve path is flash_attention.cu; this
// one serves the float32 calls (the registry's workloads and the 4-layer
// differential run) and keeps the first design: fp32 FMAs on the CUDA cores
// and synchronous loads.
//
// Replaces: repro/kernels/flash_attention/kernel.py:179 `pallas_attention`
// (pallas_call at :210).  Computes the same function as that kernel and its
// oracle repro/kernels/flash_attention/ref.py:15: softmax attention over
// right-aligned rows (query i sits at position i + skv - sq), causal and
// sliding-window masks, GQA (query head h reads kv head h / (Hq / Hkv) of the
// same batch row), finite NEG_INF = -1e30 masking, p re-masked after the
// exp, and the output written as acc / max(l, 1e-30), so a row with no
// visible key is 0, never NaN.  fp32 or bf16 in and out, fp32 arithmetic.
//
// The body is `Program.emit(order)` of flash_attention/kernel.py::
// make_program, placed inside the loop over kv blocks: the TPU's sequential
// kv grid axis becomes that loop, one block per (batch * query head, BQ-row
// query tile).  MEM instructions ld_q (first kv block only: q stays in its
// buffer), ld_k{c}, ld_v{c} fill shared buffers of their own; bf16 tiles stay
// bf16 there and are widened on read.  qk{c} and mask{c} write the fp32 score
// chunk S{c}; softmax (one warp per row) keeps the running m and l in shared
// memory and rescales the register accumulator acc by the correction, so the
// IR's ld_stats / accum / st_stats are register moves and emit nothing;
// pv{c} adds p{c} v{c} into acc; st_o writes acc / l on the last kv block.
// Buffers are placed by liveness in the schedule's order and __syncthreads()
// stands where an instruction reads or overwrites what other threads touched.
// Rows at or past sq and keys at or past kv_len (the real key length, at
// most skv; a padded call passes its unpadded length) are masked here, so no
// length has to divide a tile; kv blocks wholly above the causal diagonal,
// before the window or at or past kv_len are skipped.
//
// What bounds it on the H100: the bytes of q, k, v and o at the shapes it
// serves; this version multiplies with fp32 FMAs on the CUDA cores from
// shared memory, far above that bound.  Tensor cores (3xTF32) are later
// work.

__device__ __forceinline__ bool visible(int qi, int col, int off, int sq, int kv_len) {
    bool ok = qi < sq && col < kv_len;
    const int row = qi + off;
    if (CAUSAL) ok = ok && col <= row;
    if (WINDOW > 0) ok = ok && col > row - WINDOW;
    return ok;
}

template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, T* __restrict__ dst,
                                          int row0, int len) {
    for (int e = threadIdx.x; e < ROWS * D; e += NT) {
        const int r = e / D, c = e % D, g = row0 + r;
        dst[r * LD + c] = g < len ? src[(size_t)g * D + c] : T(0);
    }
}

__device__ __forceinline__ void qk_tile(const T* __restrict__ qs, const T* __restrict__ ks,
                                        float* __restrict__ s) {
#if QK_TILED
    // thread (ty, tx) owns rows ty + QK_TR i and keys tx + QK_TC j of the
    // chunk: QK_TM + QK_TN shared loads per QK_TM * QK_TN FMAs
    const int tx = threadIdx.x % QK_TC, ty = threadIdx.x / QK_TC;
    float a[QK_TM][QK_TN];
#pragma unroll
    for (int i = 0; i < QK_TM; ++i)
#pragma unroll
        for (int j = 0; j < QK_TN; ++j) a[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
        float x[QK_TM], y[QK_TN];
#pragma unroll
        for (int i = 0; i < QK_TM; ++i) x[i] = to_f(qs[(ty + QK_TR * i) * LDQ + d]);
#pragma unroll
        for (int j = 0; j < QK_TN; ++j) y[j] = to_f(ks[(tx + QK_TC * j) * LDK + d]);
#pragma unroll
        for (int i = 0; i < QK_TM; ++i)
#pragma unroll
            for (int j = 0; j < QK_TN; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
    }
#pragma unroll
    for (int i = 0; i < QK_TM; ++i)
#pragma unroll
        for (int j = 0; j < QK_TN; ++j)
            s[(ty + QK_TR * i) * LDS + tx + QK_TC * j] = a[i][j] * SCALE;
#else
    // too few (row, key) pairs to give every thread a tile: one pair each
    for (int e = threadIdx.x; e < BQ * CK; e += NT) {
        const int r = e / CK, j = e % CK;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) a = fmaf(to_f(qs[r * LDQ + d]), to_f(ks[j * LDK + d]), a);
        s[r * LDS + j] = a * SCALE;
    }
#endif
}

__device__ __forceinline__ void mask_tile(float* __restrict__ s, int c0, int q0, int off,
                                          int sq, int kv_len) {
    for (int e = threadIdx.x; e < BQ * CK; e += NT) {
        const int r = e / CK, j = e % CK;
        if (!visible(q0 + r, c0 + j, off, sq, kv_len)) s[r * LDS + j] = NEG_INF;
    }
}

__device__ __forceinline__ void softmax_rows(float* const (&s)[NCH], float* m_s, float* l_s,
                                             float* c_s, int kb, int q0, int off, int sq,
                                             int kv_len, float (&acc)[TM][TN]) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < BQ; r += NT / 32) {
        float mx = NEG_INF;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
            for (int j = lane; j < CK; j += 32) mx = fmaxf(mx, s[c][r * LDS + j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float corr = expf(m_prev - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
            for (int j = lane; j < CK; j += 32) {
                const float p = visible(q0 + r, kb + c * CK + j, off, sq, kv_len)
                                    ? expf(s[c][r * LDS + j] - m_new) : 0.f;
                s[c][r * LDS + j] = p;
                sum += p;
            }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
            m_s[r] = m_new;
            l_s[r] = corr * l_s[r] + sum;
            c_s[r] = corr;
        }
    }
    __syncthreads();
    if (threadIdx.x >= TR * TC) return;
    const int ty = threadIdx.x / TC;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const float corr = c_s[ty + TR * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] *= corr;
    }
}

// acc: thread (ty, tx) owns output rows ty + TR i and columns tx + TC j
__device__ __forceinline__ void pv_tile(const float* __restrict__ p, const T* __restrict__ vs,
                                        float (&acc)[TM][TN]) {
    if (threadIdx.x >= TR * TC) return;
    const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
#pragma unroll 4
    for (int j = 0; j < CK; ++j) {
        float x[TM], y[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) x[i] = p[(ty + TR * i) * LDS + j];
#pragma unroll
        for (int c = 0; c < TN; ++c) y[c] = to_f(vs[j * D + tx + TC * c]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
    }
}

__device__ __forceinline__ void store_o(T* __restrict__ op, const float (&acc)[TM][TN],
                                        const float* l_s, int q0, int sq) {
    if (threadIdx.x >= TR * TC) return;
    const int tx = threadIdx.x % TC, ty = threadIdx.x / TC;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = ty + TR * i;
        if (q0 + r >= sq) continue;
        const float l_safe = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < TN; ++c)
            op[(size_t)(q0 + r) * D + tx + TC * c] = from_f<T>(acc[i][c] / l_safe);
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
    float* const m_s = STATS;
    float* const l_s = STATS + BQ;
    float* const c_s = STATS + 2 * BQ;
    for (int r = threadIdx.x; r < BQ; r += NT) {
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

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
        __syncthreads();
/*@BODY@*/
    }
}
