// The UNet feed-forward's GEGLU gate, a * gelu(gate), in one pass, bound to
// Python through ctypes (ops/activations.py:geglu_cuda).
//
// h is the feed-forward projection's output, a contiguous (rows, 2n) tensor
// in float32 or bfloat16: columns [0, n) are a and [n, 2n) the gate, the
// split of h.chunk(2, dim=-1).  out is (rows, n) in h's dtype.  The JAX
// package writes the same function in plain XLA
// (ml_stable_diffusion_tpu/models/unet.py, FeedForward), which XLA fuses
// into one loop; the port's eager path ran it as eight float32 kernels.
//
// Bit-equal to that eager path (ops/activations.py: gelu_erf, quick_gelu,
// then a * gelu): every step is one float32 operation in the eager order,
// written with __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc contracts none
// into an FMA:
//   exact:  g = (0.5 * x) * (1 + erff(x * 0.70710677f))
//   quick:  g = x * (1 / (1 + expf(-(x * 1.702f))))   (torch.sigmoid's order)
// g is rounded to h's dtype (.to(x.dtype)), then a * g is computed in float32
// and rounded once, as PyTorch's elementwise multiply does.
//
// What bounds it on the H100.  A dozen operations per element against 6 bytes
// (bf16: a, the gate, the result) or 12 (float32): bound by bytes, the least
// it can move being h once and out once.  At SDXL's batch-8 shapes h is 84 to
// 168 MB, beyond the 50 MB L2, so the pass streams from HBM.
//
// What the design does about it.
//  * 16-byte vectors (8 bf16 or 4 float32) of a and of the gate, one 16-byte
//    store of out.  With n a multiple of the vector width every vector starts
//    on a 16-byte boundary (the wrapper hands an aligned base), and a row's
//    vectors never straddle a and the gate.
//  * kUnroll vectors of a and of the gate a thread, all loaded before any is
//    used, so that each thread keeps 2 * kUnroll loads in flight; a grid of
//    blocks sized to the SMs (as many as fit at once) strides over the rest.
//    No shared memory: nothing is reused.  The arithmetic costs little: with
//    it replaced by one addition the pass ran 4 % faster at SDXL's shapes.
//  * h is read once, marked last-use (__ldcs); out is stored plainly, so that
//    the next projection, which reads it at once, may find part in L2.
//  * An n that the vector width does not divide (no main path has one) takes
//    an element-wise pass of the same arithmetic.
//
// The C entry returns cudaGetLastError() after the launch; the Python wrapper
// raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// vectors of a and of the gate a thread loads before it computes any: 2
// timed best at SDXL's shapes, 1-2 % ahead of 4 (54 registers) and 6 % of 8
constexpr int kUnroll = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// gelu(x) in float32, in the eager path's order
template <bool kQuick>
__device__ __forceinline__ float gelu(float x) {
  if (kQuick) {
    const float e = expf(-__fmul_rn(x, 1.702f));
    return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, e)));
  }
  const float e = erff(__fmul_rn(x, 0.70710677f));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, e));
}

// a * gelu(gate), gelu rounded to T first, the product rounded once
template <typename T, bool kQuick>
__device__ __forceinline__ float gate(float a, float x) {
  return __fmul_rn(a, to_f32(from_f32<T>(gelu<kQuick>(x))));
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[kN]) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[kN]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ __forceinline__ static void unpack(const Raw& q, float (&v)[kN]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static Raw pack(const float (&v)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// out vector j (of rows * n / kN) is row r = j / nv, column vector c = j % nv;
// its a vector is h's vector j + r * nv, its gate vector nv further on.
// Indices are 64-bit: at SDXL's batch-8 shapes 32-bit ones (a 32-bit division
// a vector) timed the same, within 1 %
template <typename T, bool kQuick>
__global__ void __launch_bounds__(kThreads) geglu_vec_kernel(const T* __restrict__ h,
                                                             T* __restrict__ out,
                                                             long long vectors, long long nv) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  const Raw* hv = reinterpret_cast<const Raw*>(h);
  Raw* ov = reinterpret_cast<Raw*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < vectors; base += stride) {
    Raw qa[kUnroll], qg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads;
      if (j < vectors) {
        const long long src = j + j / nv * nv;
        qa[u] = __ldcs(hv + src);
        qg[u] = __ldcs(hv + src + nv);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * kThreads;
      if (j < vectors) {
        float a[V::kN], x[V::kN];
        V::unpack(qa[u], a);
        V::unpack(qg[u], x);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) a[i] = gate<T, kQuick>(a[i], x[i]);
        ov[j] = V::pack(a);
      }
    }
  }
}

// the same function element by element, for an n the vector width does not
// divide
template <typename T, bool kQuick>
__global__ void __launch_bounds__(kThreads) geglu_scalar_kernel(const T* __restrict__ h,
                                                                T* __restrict__ out,
                                                                long long count, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < count;
       i += stride) {
    const long long src = i + i / n * n;
    out[i] = from_f32<T>(gate<T, kQuick>(to_f32(h[src]), to_f32(h[src + n])));
  }
}

// blocks of the kernel resident at once on the card (SMs x blocks an SM)
template <typename K>
long long resident_blocks(K kernel) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess)
    return 132;
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

template <typename T, bool kQuick>
cudaError_t launch(const void* hv, void* outv, long long rows, long long n, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const T* h = static_cast<const T*>(hv);
  T* out = static_cast<T*>(outv);
  if (n % kN == 0) {
    static const long long cap = resident_blocks(geglu_vec_kernel<T, kQuick>);
    const long long vectors = rows * (n / kN);
    const long long per_block = static_cast<long long>(kThreads) * kUnroll;
    const long long blocks = std::min(cap, (vectors + per_block - 1) / per_block);
    geglu_vec_kernel<T, kQuick><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        h, out, vectors, n / kN);
  } else {
    static const long long cap = resident_blocks(geglu_scalar_kernel<T, kQuick>);
    const long long count = rows * n;
    const long long blocks = std::min(cap, (count + kThreads - 1) / kThreads);
    geglu_scalar_kernel<T, kQuick><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        h, out, count, n);
  }
  return cudaGetLastError();
}

}  // namespace

// h: contiguous (rows, 2n), 16-byte aligned; out: contiguous (rows, n), 16-byte
// aligned.  dtype: 0 float32, 1 bfloat16.  quick: 0 the exact (erf) GELU, 1
// quick_gelu.
extern "C" int geglu_fwd(const void* h, void* out, long long rows, long long n, int dtype,
                         int quick, void* stream) {
  if (rows <= 0 || n <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = quick ? launch<__nv_bfloat16, true>(h, out, rows, n, s)
                : launch<__nv_bfloat16, false>(h, out, rows, n, s);
  else
    err = quick ? launch<float, true>(h, out, rows, n, s) : launch<float, false>(h, out, rows, n, s);
  return static_cast<int>(err);
}
