// Fused RMSNorm for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/rmsnorm/kernel.py:83 `pallas_rmsnorm` (pallas_call
// at :97).  y = x * rsqrt(mean(x^2) + EPS) * gamma per row; x (rows, D) and
// gamma (D,) fp32 or bf16, y in x's dtype, all arithmetic fp32.
//
// What bounds it on the H100: bytes (each x read once, y written once, gamma
// once) over 3.35 TB/s; it does ~4 operations per element.  So the design
// keeps as many bytes in flight as the card can take:
// - The grid is sized by the card, not by the TPU's row tile.  One warp
//   normalizes one row; a block holds NW warps, so the grid is
//   ceil(rows / NW) blocks (1024 at 4096 rows), whatever the schedule's row
//   tile BR is.  BR stays the Program's tile (replications, the CPU face's
//   tiles) and appears nowhere in this text: schedules that differ only in
//   BR share one cubin.  A warp whose row is at or past `rows` returns.
// - 16-byte loads and stores.  Lane l holds vectors l, l + 32, ... of each
//   feature chunk, VEC contiguous elements each (8 bf16 or 4 fp32), so one
//   load instruction of a warp reads 512 neighbouring bytes.  When the
//   chunk's NV vectors are not a multiple of 32 the last vector of a lane is
//   predicated; when a chunk is not a whole number of 16-byte vectors (the
//   smoke widths in bf16) VEC is 1 and every load is a scalar one.  gamma
//   is read through the read-only path.
// - The row stays in registers (CPT fp32 values per lane per chunk, 80 per
//   lane in all at D = 2560) and nothing lives in shared memory.
//
// The body is `Program.emit(order)` of rmsnorm/kernel.py::make_program for
// the warp's row: ld_x{c} loads chunk c of the row into registers x{c},
// sq{c} sums its squares per lane, rstd reduces the lane sums over the warp
// (shuffles) to rsqrt(sum / D + EPS), ld_g{c} loads gamma's chunk c,
// scale{c} forms y{c} = x{c} * rstd * g{c}, st_y{c} stores it.  Each lane
// touches only its own elements and the reduction is a warp shuffle, so no
// order needs a barrier.
//
// Grid ceil(rows / NW); NT = 32 NW threads.

// VEC contiguous elements at p, widened to fp32; 16 bytes in one load when
// VEC > 1 (read-only path when kGamma)
template <bool kGamma>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float* v) {
    if (VEC == 1) {
        v[0] = kGamma ? __ldg(p) : *p;
    } else {
        const float4 f = kGamma ? __ldg(reinterpret_cast<const float4*>(p))
                                : *reinterpret_cast<const float4*>(p);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
}
template <bool kGamma>
__device__ __forceinline__ void load_vec(const bf16_t* __restrict__ p, float* v) {
    if (VEC == 1) {
        v[0] = to_f(kGamma ? __ldg(p) : *p);
    } else {
        const uint4 u = kGamma ? __ldg(reinterpret_cast<const uint4*>(p))
                               : *reinterpret_cast<const uint4*>(p);
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            v[2 * i] = __uint_as_float(w[i] << 16);
            v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
}

// VEC fp32 values rounded to T and stored at p, 16 bytes in one store when
// VEC > 1
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float* v) {
    if (VEC == 1) *p = v[0];
    else *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16_t* __restrict__ p, const float* v) {
    if (VEC == 1) {
        *p = from_f<bf16_t>(v[0]);
    } else {
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // one cvt per pair (nearest even); a NaN takes from_f's 0x7fc0
            w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
            if (v[2 * i] != v[2 * i] || v[2 * i + 1] != v[2 * i + 1])
                w[i] = (unsigned)from_f<bf16_t>(v[2 * i])
                     | ((unsigned)from_f<bf16_t>(v[2 * i + 1]) << 16);
        }
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// chunk C of a row: v[VEC k + i] is element VEC (lane + 32 k) + i of the
// chunk, 0 past its end
template <int C, bool kGamma>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, float (&v)[CPT]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
        const int e = lane + 32 * k;
        if (NV % 32 == 0 || e < NV) {
            load_vec<kGamma>(src + C * CD + VEC * e, &v[VEC * k]);
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[VEC * k + i] = 0.f;
        }
    }
}

__device__ __forceinline__ float sum_sq(const float (&v)[CPT]) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k) s = fmaf(v[k], v[k], s);
    return s;
}

__device__ __forceinline__ float row_rstd(float s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return rsqrtf(s / (float)D + EPS);
}

__device__ __forceinline__ void scale_chunk(const float (&x)[CPT], const float (&g)[CPT],
                                            float r, float (&y)[CPT]) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) y[k] = x[k] * r * g[k];
}

template <int C>
__device__ __forceinline__ void store_chunk(T* __restrict__ dst, const float (&v)[CPT]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
        const int e = lane + 32 * k;
        if (NV % 32 == 0 || e < NV) store_vec(dst + C * CD + VEC * e, &v[VEC * k]);
    }
}

extern "C" __global__ void __launch_bounds__(NT)
rmsnorm_fused(const T* __restrict__ x, const T* __restrict__ gm, T* __restrict__ out,
              int rows) {
/*@BUFFERS@*/
    const int row = blockIdx.x * NW + (threadIdx.x >> 5);
    if (row >= rows) return;
    const T* xr = x + (size_t)row * D;
    T* yr = out + (size_t)row * D;
/*@BODY@*/
}
