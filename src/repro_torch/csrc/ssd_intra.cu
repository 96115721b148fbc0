// Mamba-2 SSD intra-chunk term for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/ssd/kernel.py:82 `pallas_ssd_intra` (pallas_call at
// :100), wrapped by repro/kernels/ssd/pallas_ops.py:201.  For each chunk g and
// head h: y = ((C B^T) * L) x, with L[i, j] = exp(cum_i - cum_j) for j <= i
// (cum the running sum of the chunk's log-decays la) and 0 above the
// diagonal; a non-finite decay is 0, as the reference's oracle
// (pallas_ops.py:151) maps it.  xb (G, Q, H, P), la (G, Q, H), B and C
// (G, Q, N), fp32 or bf16 in and out (the model's path passes fp32).
//
// Numbers, as the plain version (ssd/ref.py::intra_chunk) takes them: S =
// C B^T, L and W = S * L are fp32; S is rounded once from an fp64 sum of
// exact products, L once from an fp64 exp of an fp64 running sum, W is an
// fp32 product, and y is an fp64 sum of the exact products W x, rounded once.
// At positive log-decays (the SIP tests' standard-normal draws) the decays
// span e^+-40 within a chunk and a row of y can cancel to a millionth of its
// largest term: two fp32 sums in different orders then differ past the
// tests' 2e-2, two fp64 sums of the same exact products do not.  So both
// dots run on the fp64 tensor cores (DMMA, mma_f64_1684: a product of two
// fp32 values is exact in fp64) with fp64 accumulators, one path for every
// sign of la.
//
// Work split.  The TPU kernel holds a whole chunk per (g, h) grid cell; at
// the model's chunk (Q = 256, N = 128, fp32) C and B alone are 256 KB, more
// than a block's 227 KB.  Here a block owns one BR-row tile of chunk g for a
// group of HG heads (h0 .. h0 + HG - 1; heads at or past h are zero-filled
// and not stored) and walks the BR-column tiles at and left of the diagonal
// (the tiles right of it are zero), as flash attention walks kv blocks.  The
// heads of a chunk share B and C, so C B^T is formed once per column step for
// the whole group, not once per head.  Row tile r walks r + 1 column tiles:
// the grid's y index counts row tiles from the last, so the heavy blocks are
// dispatched first.  Tiles are padded to BRP (16 or 32) rows and columns
// with zeros, as the 16 x 8 x 4 instruction needs.
//
// The body is `Program.emit(order)` of ssd/kernel.py::make_program, inside
// the column loop.  MEM instructions copy with cp.async into shared buffers
// of their own and commit one group each, unconditionally (ld_c and ld_la
// copy on the first step only and commit an empty group after it), and
// kernels/_emit.py::AsyncPlanner waits for a group ahead of its first
// reader, so the order sets how long each copy runs under the instructions
// placed between it and its reader.
// - ld_c: C's row tile; ld_b: B's column tile; ld_la: the group's
//   log-decays; ld_x: x's column tile, HG * P contiguous elements a row.
// - dot_cb: S = C B^T on DMMA, once for the group; the warps split N into
//   KS slices and the first slice adds the others' fp64 sums.
// - decay: the fp64 running sums on the first step; then each head's L tile
//   in factored form, exp(cum_i - cum_j) = exp(cum_i - cum_r0) exp(cum_r0 -
//   cum_j): one exp per row and per column instead of one per entry.  A
//   factor whose argument passes +-600 (it could leave fp64's normal range;
//   only positive la gets there) is NaN, and mask_mul takes that entry's
//   exp whole.
// - mask_mul: W_hh = S * L_hh, each L entry rounded once to fp32 from its
//   fp64 product of factors, W kept as fp64 (exact) for the tensor cores.
// - dot_y: acc_hh += W_hh x_hh on DMMA, the warps in HS groups of HPW
//   heads each; st_y: the last step writes acc.
//
// What bounds it on the H100: at the serve prefill's shape (one 256-token
// chunk, 80 heads, N 128, P 64) its operations: C B^T once per chunk and
// W x per head at and below the diagonal, over the fp64 tensor cores' 67
// TFLOP/s (the same rate as fp32 on the CUDA cores).  What holds it back
// instead: every fp32 operand of C B^T and every x operand is widened to
// fp64 on its way from shared memory to a fragment (a conversion per use;
// the N split and the head groups give each warp more tiles of one
// product, so fewer conversions per product), and within a block a step's
// copies, products and decay wait on each other at barriers.  32-row tiles
// keep a block at ~90 KB, so two blocks of 8 warps share an SM and overlap
// each other's phases.
//
// Grid (G * ceil(h / HG), Q / BR); NT threads.

#define FULL_MASK 0xffffffffu
#define FLT_MAX_F 3.402823466e+38f
// past this |argument| an exp factor could leave fp64's normal range
#define EXP_SPLIT_MAX 600.0

// rows [row0, row0 + BR) of a (Q, N) matrix into a BRP x LDC tile; rows past
// BR are zero
__device__ __forceinline__ void load_rows(const T* __restrict__ src, T* __restrict__ dst,
                                          int row0) {
    constexpr int EPC = CW / (int)sizeof(T), CPR = N / EPC;
    for (int e = threadIdx.x; e < BRP * CPR; e += NT) {
        const int r = e / CPR, c = e % CPR;
        const bool ok = r < BR;
        cp_async_n<CW>(dst + r * LDC + EPC * c, src + (ok ? (size_t)(row0 + r) * N + EPC * c : 0),
                       ok);
    }
}

// the chunk's Q log-decays of heads h0 .. h0 + HG - 1 (stride h in
// (G, Q, H)) as la[HG i + hh]; heads at or past h are 0
__device__ __forceinline__ void load_la(const T* __restrict__ lp, int h, int h0,
                                        T* __restrict__ la) {
    for (int e = threadIdx.x; e < Q * HG; e += NT) {
        const int i = e / HG, hh = e % HG;
        const bool ok = h0 + hh < h;
        const T* src = lp + (ok ? (size_t)i * h + h0 + hh : 0);
        if constexpr (sizeof(T) == 4) cp_async_n<4>(la + e, src, ok);
        else la[e] = ok ? *src : (T)0;
    }
}

// rows [row0, row0 + BR) of x for heads h0 .. h0 + HG - 1 (HG P contiguous
// elements a row, row stride h P in (G, Q, H, P)) into a BRP x LDX tile;
// rows past BR and heads at or past h are zero
__device__ __forceinline__ void load_x(const T* __restrict__ xp, int h, int h0,
                                       T* __restrict__ xs, int row0) {
    constexpr int EPC = XW / (int)sizeof(T), CPR = HG * P / EPC;
    for (int e = threadIdx.x; e < BRP * CPR; e += NT) {
        const int r = e / CPR, c = e % CPR;
        const bool ok = r < BR && h0 + EPC * c / P < h;
        cp_async_n<XW>(xs + r * LDX + EPC * c,
                       xp + (ok ? ((size_t)(row0 + r) * h + h0) * P + EPC * c : 0), ok);
    }
}

// S = C B^T over N on DMMA, rounded once to fp32.  The warps split N into
// KS slices of KSL; within a slice, warp ws owns the 16-row strip ws % MT
// and the 8-column tiles ws / MT + (WPS / MT) j, WPS = 8 / KS warps a
// slice (more tiles a warp: fewer fp32 operands widened per product).  The
// slices past the first leave their fp64 sums in part; the first adds them
// before it rounds.
__device__ __forceinline__ void cb_tile(const T* __restrict__ cs, const T* __restrict__ bs,
                                        float* __restrict__ s, double* __restrict__ part) {
    constexpr int WPS = NT / 32 / KS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int slice = warp / WPS, ws = warp % WPS;
    const int m0 = 16 * (ws % MT), nw = 8 * (ws / MT);
    const bool active = nw < BRP;
    double d[NJC][4];
#pragma unroll
    for (int j = 0; j < NJC; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[j][q] = 0.0;
    if (active) {
        const int lo = KSL * slice, hi = min(lo + KSL, N);
#pragma unroll 4
        for (int k0 = lo; k0 < hi; k0 += 4) {
            const int k = k0 + tq;
            const bool kok = N % 4 == 0 || k < N;
            const double a[2] = {kok ? (double)to_f(cs[(m0 + gq) * LDC + k]) : 0.0,
                                 kok ? (double)to_f(cs[(m0 + gq + 8) * LDC + k]) : 0.0};
#pragma unroll
            for (int j = 0; j < NJC; ++j) {
                const int n0 = nw + 8 * (WPS / MT) * j;
                if (n0 < BRP)
                    mma_f64_1684(d[j], a, kok ? (double)to_f(bs[(n0 + gq) * LDC + k]) : 0.0);
            }
        }
    }
    if (KS > 1) {
        if (slice > 0 && active)
#pragma unroll
            for (int j = 0; j < NJC; ++j) {
                const int n0 = nw + 8 * (WPS / MT) * j;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (n0 < BRP)
                        part[(slice - 1) * BRP * LDP + (m0 + gq + 8 * (q / 2)) * LDP + n0
                             + 2 * tq + q % 2] = d[j][q];
            }
        __syncthreads();
        if (slice == 0 && active)
            for (int sl = 0; sl < KS - 1; ++sl)
#pragma unroll
                for (int j = 0; j < NJC; ++j) {
                    const int n0 = nw + 8 * (WPS / MT) * j;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (n0 < BRP)
                            d[j][q] += part[sl * BRP * LDP + (m0 + gq + 8 * (q / 2)) * LDP
                                            + n0 + 2 * tq + q % 2];
                }
    }
    if (slice > 0 || !active) return;
#pragma unroll
    for (int j = 0; j < NJC; ++j) {
        const int n0 = nw + 8 * (WPS / MT) * j;
        if (n0 >= BRP) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            s[(m0 + gq + 8 * (q / 2)) * LDS + n0 + 2 * tq + q % 2] = (float)d[j][q];
    }
}

// cum[Q hh + i] = running sum of head hh's la in fp64; warp hh scans head hh:
// each lane sums a segment, a warp scan offsets the segments
__device__ __forceinline__ void running_sum(const T* __restrict__ la, double* __restrict__ cum) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < HG) {
        constexpr int SEG = (Q + 31) / 32;
        const int lo = lane * SEG;
        double seg = 0.0;
        for (int i = 0; i < SEG; ++i)
            if (lo + i < Q) seg += to_f(la[HG * (lo + i) + warp]);
        double incl = seg;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const double t = __shfl_up_sync(FULL_MASK, incl, o);
            if (lane >= o) incl += t;
        }
        double run = incl - seg;
        for (int i = 0; i < SEG; ++i)
            if (lo + i < Q) {
                run += to_f(la[HG * (lo + i) + warp]);
                cum[Q * warp + lo + i] = run;
            }
    }
    __syncthreads();
}

// exp(x) where |x| <= EXP_SPLIT_MAX, else NaN: the factor may not be used
__device__ __forceinline__ double exp_factor(double x) {
    return fabs(x) <= EXP_SPLIT_MAX ? exp(x) : __longlong_as_double(0x7ff8000000000000ll);
}

// The group's L tiles in factored form: exp(cum_i - cum_j) = exp(cum_i -
// cum_r0) exp(cum_r0 - cum_j).  lf[2 BRP hh + r] is row r's factor,
// lf[2 BRP hh + BRP + c] column c's (NaN where it would leave fp64's
// normal range: mul_tile then takes that entry's exp whole)
__device__ __forceinline__ void decay_tile(const T* __restrict__ la, double* __restrict__ cum,
                                           double* __restrict__ lf, int r0, int kb, bool first) {
    if (first) running_sum(la, cum);
    for (int e = threadIdx.x; e < HG * BRP; e += NT) {
        const int hh = e / BRP, r = e % BRP;
        const double* c = cum + Q * hh;
        double* f = lf + 2 * BRP * hh;
        f[r] = r < BR ? exp_factor(c[r0 + r] - c[r0]) : 0.0;
        f[BRP + r] = r < BR ? exp_factor(c[r0] - c[kb + r]) : 0.0;
    }
}

// W_hh = S * L_hh for every head of the group: each entry of L rounded
// once to fp32 from its fp64 factors (or its own exp), 0 above the
// diagonal and where not finite; W_hh is an fp32 product, kept widened to
// fp64 for the tensor cores
__device__ __forceinline__ void mul_tile(const float* __restrict__ s, const double* __restrict__ lf,
                                         const double* __restrict__ cum, double* __restrict__ w,
                                         int r0, int kb) {
    for (int e = threadIdx.x; e < BRP * BRP; e += NT) {
        const int r = e / BRP, c = e % BRP;
        const float cb = s[r * LDS + c];
        const bool seen = r < BR && c < BR && kb + c <= r0 + r;
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
            float l = 0.f;
            if (seen) {
                double x = lf[2 * BRP * hh + r] * lf[2 * BRP * hh + BRP + c];
                if (x != x) x = exp(cum[Q * hh + r0 + r] - cum[Q * hh + kb + c]);
                l = (float)x;
                if (!(l <= FLT_MAX_F)) l = 0.f;     // +inf or NaN
            }
            w[WSZ * hh + r * LDW + c] = (double)(cb * l);
        }
    }
}

// acc[t] += W_hh x_hh over this column tile on DMMA, for the heads hh =
// HS g + t of this warp's group g = warp / WPH (WPH = 8 / HS warps a group);
// in the group, warp w owns the 16-row strips YM (w % YWM) + i and the
// 8-column tiles YN (w / YWM) + j.
__device__ __forceinline__ void y_tile(const double* __restrict__ w, const T* __restrict__ xs,
                                       double (&acc)[HPW][YM][YN][4]) {
    constexpr int WPH = NT / 32 / HS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int grp = warp / WPH, wg = warp % WPH;
    const int m0 = 16 * YM * (wg % YWM), n0 = 8 * YN * (wg / YWM);
    if (n0 >= PP) return;
#pragma unroll
    for (int t = 0; t < HPW; ++t) {
        const int hh = grp + HS * t;
        const double* wh = w + WSZ * hh;
#pragma unroll 4
        for (int k0 = 0; k0 < BRP; k0 += 4) {
            double a[YM][2], b[YN];
#pragma unroll
            for (int i = 0; i < YM; ++i) {
                a[i][0] = wh[(m0 + 16 * i + gq) * LDW + k0 + tq];
                a[i][1] = wh[(m0 + 16 * i + gq + 8) * LDW + k0 + tq];
            }
#pragma unroll
            for (int j = 0; j < YN; ++j) {
                const int n = n0 + 8 * j + gq;
                b[j] = (P % 8 == 0 || n < P) && n0 + 8 * j < PP
                           ? (double)to_f(xs[(k0 + tq) * LDX + P * hh + n]) : 0.0;
            }
#pragma unroll
            for (int i = 0; i < YM; ++i)
#pragma unroll
                for (int j = 0; j < YN; ++j) mma_f64_1684(acc[t][i][j], a[i], b[j]);
        }
    }
}

__device__ __forceinline__ void store_y(T* __restrict__ yp, int h, int h0,
                                        const double (&acc)[HPW][YM][YN][4], int r0) {
    constexpr int WPH = NT / 32 / HS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int grp = warp / WPH, wg = warp % WPH;
    const int m0 = 16 * YM * (wg % YWM), n0 = 8 * YN * (wg / YWM);
#pragma unroll
    for (int t = 0; t < HPW; ++t) {
        const int hh = grp + HS * t;
        if (h0 + hh >= h) continue;
#pragma unroll
        for (int i = 0; i < YM; ++i)
#pragma unroll
            for (int j = 0; j < YN; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int r = m0 + 16 * i + gq + 8 * (q / 2);
                    const int c = n0 + 8 * j + 2 * tq + q % 2;
                    if (r < BR && c < P)
                        yp[((size_t)(r0 + r) * h + h0 + hh) * P + c] =
                            from_f<T>((float)acc[t][i][j][q]);
                }
    }
}

extern "C" __global__ void __launch_bounds__(NT)
ssd_intra_chunk(const T* __restrict__ xb, const T* __restrict__ la, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int h) {
    extern __shared__ __align__(16) unsigned char smem[];
/*@BUFFERS@*/
    const int groups = (h + HG - 1) / HG;
    const size_t g = blockIdx.x / groups;
    const int h0 = HG * (blockIdx.x % groups);
    const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;
    const T* cp = Cm + g * Q * N;
    const T* bp = Bm + g * Q * N;
    const T* lp = la + g * Q * h;
    const T* xp = xb + g * Q * h * P;
    T* yp = y + g * Q * h * P;
    double acc[HPW][YM][YN][4];
#pragma unroll
    for (int t = 0; t < HPW; ++t)
#pragma unroll
        for (int i = 0; i < YM; ++i)
#pragma unroll
            for (int j = 0; j < YN; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[t][i][j][q] = 0.0;
    for (int kb = 0; kb <= r0; kb += BR) {
        const bool first = kb == 0;
        const bool last = kb == r0;
        __syncthreads();
/*@BODY@*/
    }
}
