// Mamba-2 SSD intra-chunk term for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/ssd/kernel.py:82 `pallas_ssd_intra` (pallas_call at
// :100), wrapped by repro/kernels/ssd/pallas_ops.py:201.  For each chunk g and
// head h: y = ((C B^T) * L) x, with L[i, j] = exp(cum_i - cum_j) for j <= i
// (cum the running sum of the chunk's log-decays la) and 0 above the
// diagonal; a non-finite decay is 0, as the reference's oracle
// (pallas_ops.py:151) maps it.  xb (G, Q, H, P), la (G, Q, H), B and C
// (G, Q, N), fp32 or bf16 in and out (the model's path passes fp32).  Tiles,
// S, L and W = S * L are fp32, as in the reference; the running sum of la
// and exp(cum_i - cum_j) are taken in fp64 and L rounded once to fp32, and
// the two dots accumulate fp32 products in fp64 and round once, as the plain
// version (ssd/ref.py::intra_chunk) does.  At positive log-decays (the SIP
// tests' standard-normal draws) the decays span e^+-40 within a chunk and a
// row of y can cancel to a millionth of its largest term: two fp32 sums in
// different orders (cuBLAS picks split-K for some shapes) then differ past
// the tests' 2e-2, while two fp64 sums of the same exact products round to
// the same fp32 value.
//
// The TPU kernel holds a whole chunk per grid cell.  At the model's chunk
// (Q = 256, N = 128, fp32) C and B alone are 256 KB, more than a block's
// 227 KB, so here a block owns one BR-row tile of one (g, h) chunk and walks
// the BR-column tiles at and left of the diagonal (the tiles right of it are
// all zero), as flash attention walks kv blocks: the loop in the block takes
// the place of whole-chunk tiles.  C's row tile, la and its running sum stay
// in shared memory for the whole walk; B, x, the score tile S and the decay
// tile L are per step; y accumulates in registers.
//
// The body is `Program.emit(order)` of ssd/kernel.py::make_program, inside
// the column loop.  MEM instructions: ld_c (the C row tile, first step only),
// ld_b (B's column tile), ld_la (the chunk's la column, first step only),
// ld_x (x's column tile); COMPUTE: dot_cb (S = C B^T over N, register
// tiled), decay (the running sum on the first step, then the L tile),
// mask_mul (S *= L in place), dot_y (acc += S x), st_y (the last step writes
// acc).  Buffers are placed by liveness in the schedule's order and
// __syncthreads() stands where an instruction reads or overwrites what other
// threads touched since the last barrier.
//
// What bounds it on the H100: at the serve prefill's shape (one 256-token
// chunk, 80 heads, N 128, P 64) the 2 Q^2 (N + P) fp32 operations per head
// over 67 TFLOP/s, not its bytes.  This version multiplies on the CUDA cores
// from shared memory, accumulates in fp64 (half the fp32 rate), recomputes
// C B^T for every head (the reference does too: B and C are shared by all
// heads of a group), and runs 101 KB blocks, two per SM.  Tensor cores and
// sharing C B^T across heads are later work.
//
// Grid (G, H, Q / BR); NT threads.

#define FULL_MASK 0xffffffffu
#define FLT_MAX_F 3.402823466e+38f

// BR rows of width N from row row0 of a (Q, N) matrix
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* __restrict__ dst,
                                          int row0) {
    for (int e = threadIdx.x; e < BR * N; e += NT) {
        const int r = e / N, c = e % N;
        dst[r * LDC + c] = to_f(src[(size_t)(row0 + r) * N + c]);
    }
}

// the chunk's Q log-decays of this head (stride h in (G, Q, H))
__device__ __forceinline__ void load_la(const T* __restrict__ lp, int h, float* __restrict__ la) {
    for (int i = threadIdx.x; i < Q; i += NT) la[i] = to_f(lp[(size_t)i * h]);
}

// BR rows of x from row row0 (row stride h * P in (G, Q, H, P))
__device__ __forceinline__ void load_x(const T* __restrict__ xp, int h, float* __restrict__ xs,
                                       int row0) {
    for (int e = threadIdx.x; e < BR * P; e += NT) {
        const int r = e / P, c = e % P;
        xs[r * P + c] = to_f(xp[(size_t)(row0 + r) * h * P + c]);
    }
}

// S[r][c] = sum_k C[r][k] B[c][k]; thread (ty, tx) owns rows ty + CR i and
// columns tx + CC j
__device__ __forceinline__ void cb_tile(const float* __restrict__ cs, const float* __restrict__ bs,
                                        float* __restrict__ s) {
    if (threadIdx.x >= CR * CC) return;
    const int tx = threadIdx.x % CC, ty = threadIdx.x / CC;
    double a[CM][CN];
#pragma unroll
    for (int i = 0; i < CM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) a[i][j] = 0.0;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
        double x[CM], y[CN];
#pragma unroll
        for (int i = 0; i < CM; ++i) x[i] = cs[(ty + CR * i) * LDC + k];
#pragma unroll
        for (int j = 0; j < CN; ++j) y[j] = bs[(tx + CC * j) * LDC + k];
#pragma unroll
        for (int i = 0; i < CM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) a[i][j] = fma(x[i], y[j], a[i][j]);
    }
#pragma unroll
    for (int i = 0; i < CM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
            s[(ty + CR * i) * LDS + tx + CC * j] = (float)a[i][j];
}

// cum = running sum of la in fp64, by one warp: each lane sums a segment, a
// warp scan offsets the segments
__device__ __forceinline__ void running_sum(const float* __restrict__ la, double* __restrict__ cum) {
    if (threadIdx.x < 32) {
        constexpr int SEG = (Q + 31) / 32;
        const int lane = threadIdx.x, lo = lane * SEG;
        double seg = 0.0;
        for (int i = 0; i < SEG; ++i)
            if (lo + i < Q) seg += la[lo + i];
        double incl = seg;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const double t = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl += t;
        }
        double run = incl - seg;
        for (int i = 0; i < SEG; ++i)
            if (lo + i < Q) {
                run += la[lo + i];
                cum[lo + i] = run;
            }
    }
    __syncthreads();
}

// L[r][c] = exp(cum[r0 + r] - cum[c0 + c]) at and below the diagonal, else 0;
// a non-finite decay is 0
__device__ __forceinline__ void decay_tile(const float* __restrict__ la, double* __restrict__ cum,
                                           float* __restrict__ l, int r0, int c0, bool first) {
    if (first) running_sum(la, cum);
    for (int e = threadIdx.x; e < BR * BR; e += NT) {
        const int r = e / BR, c = e % BR, i = r0 + r, j = c0 + c;
        float v = 0.f;
        if (j <= i) {
            v = (float)exp(cum[i] - cum[j]);
            if (!(v <= FLT_MAX_F)) v = 0.f;     // +inf or NaN
        }
        l[r * LDS + c] = v;
    }
}

__device__ __forceinline__ void mul_tile(float* __restrict__ s, const float* __restrict__ l) {
    for (int e = threadIdx.x; e < BR * BR; e += NT) {
        const int r = e / BR, c = e % BR;
        s[r * LDS + c] *= l[r * LDS + c];
    }
}

// acc += W x in fp64; thread (ty, tx) owns output rows ty + YR i and
// columns tx + YC c
__device__ __forceinline__ void y_tile(const float* __restrict__ w, const float* __restrict__ xs,
                                       double (&acc)[YM][YN]) {
    if (threadIdx.x >= YR * YC) return;
    const int tx = threadIdx.x % YC, ty = threadIdx.x / YC;
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
        double a[YM], b[YN];
#pragma unroll
        for (int i = 0; i < YM; ++i) a[i] = w[(ty + YR * i) * LDS + j];
#pragma unroll
        for (int c = 0; c < YN; ++c) b[c] = xs[j * P + tx + YC * c];
#pragma unroll
        for (int i = 0; i < YM; ++i)
#pragma unroll
            for (int c = 0; c < YN; ++c) acc[i][c] = fma(a[i], b[c], acc[i][c]);
    }
}

__device__ __forceinline__ void store_y(T* __restrict__ yp, int h, const double (&acc)[YM][YN],
                                        int r0) {
    if (threadIdx.x >= YR * YC) return;
    const int tx = threadIdx.x % YC, ty = threadIdx.x / YC;
#pragma unroll
    for (int i = 0; i < YM; ++i)
#pragma unroll
        for (int c = 0; c < YN; ++c)
            yp[(size_t)(r0 + ty + YR * i) * h * P + tx + YC * c] = from_f<T>((float)acc[i][c]);
}

extern "C" __global__ void __launch_bounds__(NT)
ssd_intra_chunk(const T* __restrict__ xb, const T* __restrict__ la, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int h) {
    extern __shared__ __align__(16) unsigned char smem[];
/*@BUFFERS@*/
    const size_t g = blockIdx.x;
    const int hd = blockIdx.y;
    const int r0 = blockIdx.z * BR;
    const T* cp = Cm + g * Q * N;
    const T* bp = Bm + g * Q * N;
    const T* lp = la + g * Q * h + hd;
    const T* xp = xb + (g * Q * h + hd) * P;
    T* yp = y + (g * Q * h + hd) * P;
    double acc[YM][YN];
#pragma unroll
    for (int i = 0; i < YM; ++i)
#pragma unroll
        for (int c = 0; c < YN; ++c) acc[i][c] = 0.0;
    for (int kb = 0; kb <= r0; kb += BR) {
        const bool first = kb == 0;
        const bool last = kb == r0;
        __syncthreads();
/*@BODY@*/
    }
}
