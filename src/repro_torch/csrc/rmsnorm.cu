// Fused RMSNorm for Hopper (sm_90a), emitted per SIP schedule.
//
// Replaces: repro/kernels/rmsnorm/kernel.py:83 `pallas_rmsnorm` (pallas_call
// at :97).  y = x * rsqrt(mean(x^2) + EPS) * gamma per row; x (rows, D) and
// gamma (D,) fp32 or bf16, y in x's dtype, all arithmetic fp32.
//
// The TPU kernel holds a (BR x D) tile in VMEM; the reference's first row
// tile, BR = 256, is 2.6 MB at D = 2560 in fp32, far above a block's 227 KB
// of shared memory.  So nothing here lives in shared memory: a block of NW
// warps walks its BR rows, one warp per row at a time, and the warp keeps the
// row in registers, CPT values per lane per feature chunk (lane l holds
// elements l, l + 32, ... of each chunk, so each load instruction of a warp
// reads 32 neighbouring elements).  Every point of the reference's knob
// space (BR x NCH) assembles.
//
// The body is `Program.emit(order)` of rmsnorm/kernel.py::make_program,
// inside the row loop: ld_x{c} loads chunk c of the row into registers x{c},
// sq{c} sums its squares per lane, rstd reduces the lane sums over the warp
// (shuffles) to rsqrt(sum / D + EPS), ld_g{c} loads gamma's chunk c, scale{c}
// forms y{c} = x{c} * rstd * g{c}, st_y{c} stores it.  Each lane touches only
// its own elements and the reduction is a warp shuffle, so no order needs a
// barrier.
//
// What bounds it on the H100: bytes (each x read once, y written once, gamma
// once) over 3.35 TB/s; it does ~4 operations per element.  This version
// loads one element per lane per instruction (no 16-byte vector loads), and
// at BR = 256 a grid of rows / 256 blocks leaves most SMs idle for a few
// thousand rows.
//
// Grid (rows / BR); NT = 32 NW threads.

template <int C>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, float (&v)[CPT]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int e = lane + 32 * k;
        v[k] = e < CD ? to_f(src[C * CD + e]) : 0.f;
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
    for (int k = 0; k < CPT; ++k) {
        const int e = lane + 32 * k;
        if (e < CD) dst[C * CD + e] = from_f<T>(v[k]);
    }
}

extern "C" __global__ void __launch_bounds__(NT)
rmsnorm_fused(const T* __restrict__ x, const T* __restrict__ gm, T* __restrict__ out) {
/*@BUFFERS@*/
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < BR; r += NW) {
        const size_t row = (size_t)blockIdx.x * BR + r;
        const T* xr = x + row * D;
        T* yr = out + row * D;
/*@BODY@*/
    }
}
