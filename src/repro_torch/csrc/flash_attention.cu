// Flash-attention forward for Hopper (sm_90a), fp32 or bf16 in and out.
//
// Replaces: repro/kernels/flash_attention/kernel.py:179 `pallas_attention`
// (body from `make_program`, :38).  Computes the same function as that
// kernel and its oracle repro/kernels/flash_attention/ref.py:15: softmax
// attention over right-aligned rows (query i sits at position i + skv - sq),
// causal and sliding-window masks, GQA (query head h reads kv head
// h / (Hq / Hkv) of the same batch row), finite NEG_INF = -1e30 masking, p
// re-masked after the exp, and the output written as acc / max(l, 1e-30), so
// a fully masked row is 0, never NaN.
//
// What bounds it on the H100: at the prefill shapes of the main path
// (qwen3-1.7b, head_dim 128, Hq 16 / Hkv 8, S up to a few hundred) the
// least time is set by the bytes of q, k, v and o; the FLOPs need tensor
// cores to fall below that line.  This first version does its products with
// fp32 FMAs on the CUDA cores, so its real limit is FMA issue and
// shared-memory bandwidth, far above the bound.  wgmma/TMA are later work.
//
// Design:
// * One block per (batch * query head, 64-row query tile); 256 threads as a
//   16 x 16 grid.  The TPU's sequential kv grid axis becomes a loop inside
//   the block over 64-key tiles staged in shared memory as fp32.
// * Thread (tr, tc) owns query rows tr + 16 i and keys tc + 16 j (i, j < 4)
//   of the score tile, and rows tr + 16 i, columns tc + 16 c (c < D / 16) of
//   the output.  The 16 threads sharing a row are one half warp, so the row
//   max and row sum of the online softmax are half-warp shuffles and the
//   running m, l and acc stay in registers.  Row strides of D + 1 floats
//   keep the key reads free of bank conflicts.
// * Ragged lengths: rows at or past sq and keys at or past skv are masked
//   in the kernel and their tiles zero-filled, so no length has to divide
//   the tile.  kv tiles that lie wholly above the causal diagonal, or wholly
//   before the window, are skipped.
// * One fixed schedule (64 x 64 tiles, 256 threads); making it a SIP search
//   space is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int NT = 256;         // threads per block: 16 x 16
constexpr int PLD = BK + 16;    // row stride of the P tile (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Stage rows [row0, row0 + 64) of a (len, D) row-major matrix into shared
// memory as fp32, dst[r * ld + d], with 16-byte global loads.  Rows at or
// past `len` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0, int len,
                                          float* __restrict__ dst, int ld) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = D / VEC;
    constexpr int TOTAL = BK * VPR;
    static_assert(BQ == BK, "one tile loader serves q and kv tiles");
    for (int idx = threadIdx.x; idx < TOTAL; idx += NT) {
        const int r = idx / VPR;
        const int c = (idx % VPR) * VEC;
        const int g = row0 + r;
        float vals[VEC];
        if (g < len) {
            union { uint4 raw; T e[VEC]; } u;
            u.raw = *reinterpret_cast<const uint4*>(src + (size_t)g * D + c);
#pragma unroll
            for (int e = 0; e < VEC; ++e) vals[e] = to_f32(u.e[e]);
        } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[r * ld + c + e] = vals[e];
    }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
    return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
    return x;
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
                            (size_t)BQ * PLD);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int hq, int hkv, int sq, int skv, int causal, int window,
                 float scale) {
    constexpr int LD = D + 1;
    constexpr int CPT = D / 16;
    extern __shared__ float smem[];
    float* qs = smem;               // [BQ][LD]
    float* ks = qs + BQ * LD;       // [BK][LD]
    float* vs = ks + BK * LD;       // [BK][D]
    float* ps = vs + BK * D;        // [BQ][PLD]

    const int bh = blockIdx.x;
    const int b = bh / hq;
    const int kvh = b * hkv + (bh % hq) / (hq / hkv);
    const int q0 = blockIdx.y * BQ;
    const int off = skv - sq;
    const int tr = threadIdx.x / 16;
    const int tc = threadIdx.x % 16;

    const T* qp = q + (size_t)bh * sq * D;
    const T* kp = k + (size_t)kvh * skv * D;
    const T* vp = v + (size_t)kvh * skv * D;

    load_tile<T, D>(qp, q0, sq, qs, LD);

    float m[4], l[4], acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }

    // keys any row of this tile can see: [kv_begin, kv_end)
    int kv_end = skv;
    if (causal) kv_end = min(skv, q0 + BQ + off);
    int kv_begin = 0;
    if (window > 0) kv_begin = max(0, q0 + off - window + 1);

    for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
        __syncthreads();    // the previous tile's readers are done
        load_tile<T, D>(kp, k0, skv, ks, LD);
        load_tile<T, D>(vp, k0, skv, vs, D);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float a[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qs[(tr + 16 * i) * LD + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = ks[(tc + 16 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = q0 + tr + 16 * i;     // query index in [0, sq)
            const int row = r + off;            // its position among the keys
            bool ok[4];
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = k0 + tc + 16 * j;
                bool valid = r < sq && c < skv;
                if (causal) valid = valid && c <= row;
                if (window > 0) valid = valid && c > row - window;
                ok[j] = valid;
                s[i][j] = valid ? s[i][j] * scale : NEG_INF;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float corr = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
                sum += p;
                ps[(tr + 16 * i) * PLD + tc + 16 * j] = p;
            }
            l[i] = corr * l[i] + half_warp_sum(sum);
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = ps[(tr + 16 * i) * PLD + kk];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float vv = vs[kk * D + tc + 16 * c];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + tr + 16 * i;
        if (r >= sq) continue;
        const float l_safe = fmaxf(l[i], 1e-30f);
        T* orow = o + ((size_t)bh * sq + r) * D;
#pragma unroll
        for (int c = 0; c < CPT; ++c) orow[tc + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                   int sq, int skv, int causal, int window, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    // dynamic shared memory above 48 KB needs this opt-in on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
    const float scale = (float)(1.0 / sqrt((double)D));   // fp32 D**-0.5, as the reference
    flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), hq, hkv, sq, skv, causal, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int b, int hq,
                     int hkv, int sq, int skv, int d, int causal, int window,
                     cudaStream_t stream) {
    switch (d) {
        case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, stream);
        case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, stream);
        case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, skv, d), o like q; all contiguous, 16-byte
// aligned.  dtype 0 = fp32, 1 = bf16.  window <= 0 means no window.  Returns
// the CUDA error of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int hq, int hkv, int sq, int skv, int d, int dtype,
                                   int causal, int window, void* stream) {
    if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
    if (b == 0 || hq == 0 || sq == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_d<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, s);
    if (dtype == 1)
        return (int)launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window,
                                            s);
    return (int)cudaErrorInvalidValue;
}
