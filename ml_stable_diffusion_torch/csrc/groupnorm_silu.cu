// GroupNorm(+SiLU) forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/groupnorm.py
// (_gn_silu_kernel, launched by _gn_silu_pallas).  Same function, over the
// port's NCHW layout:
//   per (image b, group g): mean = E[x], var = E[x^2] - mean^2 (f32 sums, no
//   clamp, as the TPU kernel), y = (x - mean) * rsqrt(var + eps) * gamma_c +
//   beta_c, optionally y * sigmoid(y), stored in x's dtype.
// x and y are float32 or bfloat16; gamma and beta float32 or bfloat16 (one
// dtype for both), widened to f32 as the TPU kernel's gamma_ref[:].astype(f32).
// The TPU kernel reduced channels to groups through a {0,1} selector matmul
// over an NHWC image held in VMEM; in NCHW one group of one image is a single
// contiguous run of (C/G)*H*W elements, so the selector becomes index
// arithmetic: the channel of group-local element e is e / (H*W).
//
// What bounds it on the H100.  About 10 operations per element against 2 to 4
// bytes read and as many written: it is bound by bytes, and the least it can
// move is x once and y once.  At SDXL's shapes a group is 20,480 to 589,824
// elements (up to 1.2 MB in bf16), more than the 227 KB of shared memory of
// one SM, and one block per (b, g) would fill only B*G = 64 of the 132 SMs.
//
// What the design does about it.
//  * Several blocks per group: a thread-block cluster of 8 or 16 blocks owns
//    one (b, g) and each block a contiguous slice of its run, so a SDXL call
//    spreads over 512 or 1024 blocks.  Each block sums its slice, writes its
//    two partial sums to its shared memory, and after a cluster barrier every
//    block reads the partials through distributed shared memory, in rank
//    order, so that all blocks of a group compute bitwise the same mean and
//    rstd.  A second cluster barrier keeps each block alive until the others
//    have read it.  One launch, no scratch buffer, no atomics.
//  * x is read from device memory once.  The block's slice is loaded into
//    its shared memory by 1-D bulk TMA copies of 16 KB, each completing on
//    its own mbarrier, all issued at once; the sums run over each chunk as
//    it lands, and the normalisation reads the slice back from shared memory
//    and stores y with 16-byte streaming stores.  The launch plan
//    (ops/groupnorm.py:launch_plan, passed in) takes clusters of 8 or 16 (a
//    non-portable size), whichever needs fewer waves of resident blocks,
//    among those whose slice fits 224 KB.  A larger slice (none on a main
//    path) takes the streaming plan: two passes over device memory, the
//    second marked last-use (__ldcs) and hoped to hit the 50 MB L2.  A
//    group's load, sums, barriers and stores run in sequence, so phases
//    overlap only between blocks; x of the 128^2 SDXL shapes (21-75 MB)
//    exceeds the card's shared memory (~30 MB), hence 2-3 waves there.
//  * 16-byte vectors along the run (8 bf16 or 4 f32).  A group need not
//    start on a 16-byte boundary (C/G*H*W odd, e.g. 3 channels of 7x9): the
//    scalars before the first and after the last whole vector go to rank 0,
//    from device memory.  The wrapper clones an x whose base is not 16-byte
//    aligned; y is freshly allocated.
//  * The channel of a vector's first element takes one 32-bit division; the
//    rest of the vector steps through it, so a vector that crosses a channel
//    boundary (ragged H*W) picks up the next gamma/beta.
//
// The C entry returns cudaGetLastError() after the launch; the Python wrapper
// raises when it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks an SM must be able to hold by registers (48 a thread): with 53,
// four fit, and packed into clusters of 8 they left a 512-block SDXL call
// a second wave
constexpr int kMinBlocks = 5;
constexpr int kChunkBytes = 16384;  // one bulk copy of a resident slice
// the largest resident slice (the launch plan's 224 KB)
constexpr int kMaxSliceBytes = 224 * 1024;
constexpr int kMaxChunks = kMaxSliceBytes / kChunkBytes;

// bytes of the largest block slice of a run of n elements (whole 16-byte
// vectors of V elements) over cs blocks: the launch plan's formula
long long slice_bytes(long long n, int V, int cs) { return (n / V + cs - 1) / cs * 16; }

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

// 16 bytes of T, widened to f32 and back.  kLast: the last read of this data
// (evict first); stores always stream.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  template <bool kLast>
  __device__ __forceinline__ static void load(const float* p, float (&v)[kN]) {
    const float4 q = kLast ? __ldcs(reinterpret_cast<const float4*>(p))
                           : *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[kN]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  template <bool kLast>
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const uint4 q = kLast ? __ldcs(reinterpret_cast<const uint4*>(p))
                          : *reinterpret_cast<const uint4*>(p);
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// (v - mean) * rstd * gamma + beta folded into v * a + b, a = rstd * gamma,
// b = beta - mean * a (per channel), then SiLU by the fast exponential and
// division: a few instructions an element, so that the normalisation keeps
// up with the bytes
template <bool kSilu>
__device__ __forceinline__ float normalize(float v, float a, float b) {
  float t = fmaf(v, a, b);
  if (kSilu) t = __fdividef(t, 1.0f + __expf(-t));
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One cluster of cs blocks per (image, group): blockIdx.x / cs is the flat
// (b, g) index, the block's rank in the cluster its slice.  kResident: the
// slice lives in dynamic shared memory between the two passes.
template <typename T, typename P, bool kSilu, bool kResident>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_silu_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                   const P* __restrict__ beta, T* __restrict__ y, int C, int G, int hw,
                   float eps) {
  constexpr int V = Pack<T>::kN;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x);
  const long long bg = blockIdx.x / cs;
  const int g = static_cast<int>(bg % G);
  const int cpg = C / G;
  const int n = cpg * hw;  // elements of the group (checked < 2^31 by the entry)
  const long long base = bg * n;
  // whole 16-byte vectors [a0, a0 + nv * V) of the run; head scalars before
  // them, tail scalars after, both taken by rank 0
  const long long a0 = min(base + n, (base + V - 1) / V * V);
  const int nv = static_cast<int>((base + n - a0) / V);
  const long long t0 = a0 + static_cast<long long>(nv) * V;
  const int head = static_cast<int>(a0 - base);
  const int tail = static_cast<int>(base + n - t0);
  const int v_lo = static_cast<int>(static_cast<long long>(nv) * rank / cs);
  const int v_hi = static_cast<int>(static_cast<long long>(nv) * (rank + 1) / cs);
  const int nvs = v_hi - v_lo;  // this block's vectors
  const T* xs = x + a0 + static_cast<long long>(v_lo) * V;
  T* ys = y + a0 + static_cast<long long>(v_lo) * V;
  // this thread's scalar, if any: a head element (tid < head) or a tail one
  long long scalar = -1;
  if (rank == 0) {
    if (tid < head) scalar = base + tid;
    else if (tid >= V && tid < V + tail) scalar = t0 + (tid - V);
  }
  extern __shared__ __align__(128) uint8_t slice[];
  __shared__ uint64_t landed[kMaxChunks];

  // pass 1: the slice's sum and sum of squares in f32
  float s1 = 0.0f, s2 = 0.0f;
  auto add = [&](const float (&f)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += f[j];
      s2 += f[j] * f[j];
    }
  };
  if constexpr (kResident) {
    const int bytes = nvs * 16;
    const int chunks = (bytes + kChunkBytes - 1) / kChunkBytes;
    if (tid == 0) {
      for (int k = 0; k < chunks; ++k) mbar_init(&landed[k], 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < chunks; ++k) {
        const int cb = min(kChunkBytes, bytes - k * kChunkBytes);
        mbar_arrive_expect_tx(&landed[k], cb);
        bulk_load(slice + k * kChunkBytes, reinterpret_cast<const uint8_t*>(xs) + k * kChunkBytes,
                  cb, &landed[k]);
      }
    }
    constexpr int kChunkVecs = kChunkBytes / 16;
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(&landed[k], 0);
      const int end = min(nvs, (k + 1) * kChunkVecs);
#pragma unroll 4
      for (int v = k * kChunkVecs + tid; v < end; v += kThreads) {
        float f[V];
        Pack<T>::template load<false>(reinterpret_cast<const T*>(slice) + v * V, f);
        add(f);
      }
    }
  } else {
#pragma unroll 4
    for (int v = tid; v < nvs; v += kThreads) {
      float f[V];
      Pack<T>::template load<false>(xs + static_cast<long long>(v) * V, f);
      add(f);
    }
  }
  if (scalar >= 0) {
    const float f = to_f32(x[scalar]);
    s1 += f;
    s2 += f * f;
  }

  __shared__ float red[2][kWarps];
  __shared__ float2 part;  // this block's sums, read by every block of the cluster
  __shared__ float stats[2];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = s1;
    red[1][tid >> 5] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    part = make_float2(a, b);
  }
  cluster.sync();  // every block's partial sums are in its shared memory
  if (tid == 0) {
    float a = 0.0f, b = 0.0f;
    for (int r = 0; r < cs; ++r) {
      const float2 p = *cluster.map_shared_rank(&part, r);
      a += p.x;
      b += p.y;
    }
    const float mean = a / static_cast<float>(n);
    const float var = b / static_cast<float>(n) - mean * mean;
    stats[0] = mean;
    stats[1] = rsqrtf(var + eps);
  }
  cluster.sync();  // no block exits while another still reads it; stats are visible
  const float mean = stats[0], rstd = stats[1];
  const P* gam = gamma + static_cast<long long>(g) * cpg;
  const P* bet = beta + static_cast<long long>(g) * cpg;

  // pass 2: normalise, scale and shift, SiLU; y by 16-byte streaming stores
  const int e0 = head + v_lo * V;  // group-local index of xs[0]
#pragma unroll 2
  for (int v = tid; v < nvs; v += kThreads) {
    float f[V];
    if constexpr (kResident)
      Pack<T>::template load<false>(reinterpret_cast<const T*>(slice) + v * V, f);
    else
      Pack<T>::template load<true>(xs + static_cast<long long>(v) * V, f);
    const int e = e0 + v * V;
    int c = e / hw;
    int p = e - c * hw;
    float a = rstd * to_f32(gam[c]);
    float b = to_f32(bet[c]) - mean * a;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (p == hw) {  // the vector crosses into the next channel
        p = 0;
        ++c;
        a = rstd * to_f32(gam[c]);
        b = to_f32(bet[c]) - mean * a;
      }
      f[j] = normalize<kSilu>(f[j], a, b);
      ++p;
    }
    Pack<T>::store(ys + static_cast<long long>(v) * V, f);
  }
  if (scalar >= 0) {
    const int c = static_cast<int>((scalar - base) / hw);
    const float a = rstd * to_f32(gam[c]);
    y[scalar] = from_f32<T>(normalize<kSilu>(to_f32(x[scalar]), a, to_f32(bet[c]) - mean * a));
  }
}

template <typename T, typename P, bool kSilu, bool kResident>
cudaError_t launch_plan(const T* x, const P* gamma, const P* beta, T* y, int B, int C, int G,
                        int hw, float eps, int cluster, int smem, cudaStream_t stream) {
  auto kernel = gn_silu_kernel<T, P, kSilu, kResident>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(B) * G * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, gamma, beta, y, C, G, hw, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, int B, int C,
                   int G, int hw, float eps, bool silu, int cluster, bool resident,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const P* gt = static_cast<const P*>(gamma);
  const P* bt = static_cast<const P*>(beta);
  T* yt = static_cast<T*>(y);
  const long long n = static_cast<long long>(C / G) * hw;
  const int smem = resident ? static_cast<int>(slice_bytes(n, Pack<T>::kN, cluster)) : 0;
  if (resident && smem > kMaxSliceBytes) return cudaErrorInvalidValue;
  if (silu)
    return resident ? launch_plan<T, P, true, true>(xt, gt, bt, yt, B, C, G, hw, eps, cluster,
                                                    smem, stream)
                    : launch_plan<T, P, true, false>(xt, gt, bt, yt, B, C, G, hw, eps, cluster,
                                                     smem, stream);
  return resident ? launch_plan<T, P, false, true>(xt, gt, bt, yt, B, C, G, hw, eps, cluster,
                                                   smem, stream)
                  : launch_plan<T, P, false, false>(xt, gt, bt, yt, B, C, G, hw, eps, cluster,
                                                    smem, stream);
}

}  // namespace

// x, y: contiguous (B, C, H, W), 16-byte aligned; gamma, beta: (C,).
// x_dtype / p_dtype: 0 float32, 1 bfloat16.  hw = H * W.  cluster (8 or 16)
// and resident: the launch plan of ops/groupnorm.py:launch_plan; a
// resident slice must fit kMaxSliceBytes.
extern "C" int group_norm_silu_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   int B, int C, int G, int x_dtype, int p_dtype, long long hw,
                                   float eps, int apply_silu, int cluster, int resident,
                                   void* stream) {
  if (B <= 0 || G <= 0 || C <= 0 || C % G != 0 || hw <= 0 || (cluster != 8 && cluster != 16) ||
      static_cast<long long>(C / G) * hw > INT_MAX ||
      static_cast<long long>(B) * G * cluster > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(hw);
  const bool silu = apply_silu != 0, res = resident != 0;
  cudaError_t err;
  if (x_dtype == 1 && p_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, B, C, G, h, eps, silu, cluster,
                                               res, s);
  else if (x_dtype == 1 && p_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, gamma, beta, y, B, C, G, h, eps, silu, cluster, res, s);
  else if (x_dtype == 0 && p_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, gamma, beta, y, B, C, G, h, eps, silu, cluster, res, s);
  else if (x_dtype == 0 && p_dtype == 0)
    err = launch<float, float>(x, gamma, beta, y, B, C, G, h, eps, silu, cluster, res, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
