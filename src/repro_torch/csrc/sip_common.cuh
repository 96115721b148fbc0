// Helpers shared by the emitted SIP kernels; prepended to every emitted
// source, so a kernel's text (and its cubin hash) includes them.
//
// bf16 travels as its raw 16 bits (bf16_t) so the sources need no header and
// compile fast; to_f widens it exactly, from_f rounds to nearest even (NaN to
// the canonical 0x7fc0), as PyTorch's .to(torch.bfloat16) does.

typedef unsigned short bf16_t;
typedef unsigned short u16_t;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16_t x) { return __uint_as_float(((unsigned)x) << 16); }

template <typename OutT> __device__ __forceinline__ OutT from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16_t from_f<bf16_t>(float x) {
    unsigned u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return (bf16_t)0x7fc0;
    u += 0x7fffu + ((u >> 16) & 1u);
    return (bf16_t)(u >> 16);
}

#define NEG_INF (-1e30f)
