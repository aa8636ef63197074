// Fused dequantize-matmul for palettized weights on Hopper (sm_90a), bound
// to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/palettized.py
// (_dequant_matmul_kernel, launched by _dequant_matmul, wrapped by
// palettized_dense_fused).  Same function: y = x @ W with
// W[k, n] = lut[idx[k * N + n]] rounded to x's dtype, idx the flat uint8
// indices of the (K, N) Dense layout, the products accumulated in f32 and y
// written in x's dtype.  A bias is added by the caller, as in the JAX op.
//
// What bounds it on the H100.  At the SD-2.1 UNet's linear layers at CFG
// batch 2 (M = 2*4096 ... 2*64 rows, K and N 320 ... 10240) the work is
// 2*M*K*N flops against M*K + M*N bf16 elements and K*N index bytes, so the
// large-M calls are bound by the tensor cores and the small-M ones (the 154
// cross-attention key/value rows, the 2 time-embedding rows) by reading the
// indices.  Either way the dense weight must never reach device memory: the
// point of the kernel is one byte (or less) a weight read, not two.
//
// What the design does about it.
//  * One thread block per (128-row m tile, 128-column n tile), 8 warps as
//    4 x 2, each warp 32 x 64 outputs in f32 registers; a loop over 32-deep
//    k tiles inside the block takes the place of the TPU grid's sequential
//    k axis.  The TPU kernel kept the whole M axis in one block so that each
//    weight tile was expanded once; here every m tile expands its own copy in
//    shared memory, which costs a shared-memory lookup a weight per m tile
//    and no device-memory traffic.
//  * The LUT (at most 256 entries) is converted to bf16 once per block into
//    shared memory.  Each (32, 128) uint8 index tile arrives by 16-byte
//    cp.async loads; each thread then expands one 16-byte chunk through the
//    shared-memory LUT into 16 bf16 weights of the B tile.  The TPU kernel's
//    select-sum over the whole LUT (2^nbits passes a tile) was its answer to
//    slow vector gathers; a shared-memory gather is one access per weight.
//  * x and index tiles are double buffered: the next stage streams in by
//    cp.async while this one is expanded and multiplied.  Products run on
//    mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix operands; the
//    row-major (K, N) B tile is read transposed by ldmatrix.trans, as the
//    flash kernel reads v.
//  * Ragged M, K and N are masked in the kernel: rows and columns past the
//    edge load as zeros and are not stored, and weights of k rows past K are
//    zeroed after the lookup, so K = 320 or the 154 cross-attention rows need
//    no padding copies.  When K is not a multiple of 8 or N of 16 (or a base
//    is unaligned) the tiles load element by element instead of by cp.async.
//  * f32 x: an FMA kernel on the CUDA cores, LUT kept in f32, no TF32 (the
//    port's float32 numerics rule, utils/numerics.py).
//
// Simple first: wgmma, TMA and warp specialisation are later work.  The C
// entry returns cudaGetLastError() after the launch; the Python wrapper
// raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr int kLutMax = 256;

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 128;       // rows of x and y per block
constexpr int kBN = 128;       // columns of W and y per block
constexpr int kBK = 32;        // depth of one k tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kLDA = kBK + 8;  // padded x row in shared memory (bf16): conflict-free ldmatrix
constexpr int kLDB = kBN + 8;  // padded W row in shared memory (bf16)
static_assert(kBK * kBN / 16 == kThreads, "one 16-byte index chunk a thread per k tile");

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_mma_bf16(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ idx,
                 const float* __restrict__ lut, __nv_bfloat16* __restrict__ y, int M, int K,
                 int N, int n_lut) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM * kLDA];
  __shared__ __align__(16) uint8_t sI[2][kBK * kBN];
  __shared__ __align__(16) __nv_bfloat16 sB[kBK * kLDB];
  __shared__ uint16_t sLut[kLutMax];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // mma group id / thread in group
  const int wm = warp & 3, wn = warp >> 2;     // this warp's 32 rows and 64 columns
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // entries past n_lut read 0, as the TPU kernel's select-sum gives them
  for (int i = tid; i < kLutMax; i += kThreads)
    sLut[i] = __bfloat16_as_ushort(__float2bfloat16_rn(i < n_lut ? lut[i] : 0.f));

  // x rows m0.., columns k0..; index rows k0.., columns n0..; zeros past the edges
  auto load_stage = [&](int st, int k0) {
    if constexpr (kVec) {
      for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
        const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
        const bool valid = m0 + r < M && k0 + col < K;
        cp_async_16(sA[st] + r * kLDA + col,
                    valid ? x + (long long)(m0 + r) * K + k0 + col : x, valid);
      }
      for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
        const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
        const bool valid = k0 + r < K && n0 + col < N;
        cp_async_16(sI[st] + r * kBN + col,
                    valid ? idx + (long long)(k0 + r) * N + n0 + col : idx, valid);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        sA[st][r * kLDA + c] = m0 + r < M && k0 + c < K
                                   ? x[(long long)(m0 + r) * K + k0 + c]
                                   : __float2bfloat16_rn(0.f);
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        sI[st][r * kBN + c] =
            k0 + r < K && n0 + c < N ? idx[(long long)(k0 + r) * N + n0 + c] : uint8_t(0);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();

  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {
      load_stage(st ^ 1, (it + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the stage just requested
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, on the first pass, the LUT) is in place

    // expand: one 16-byte chunk of indices -> 16 bf16 weights of the B tile
    {
      const int r = tid / (kBN / 16), col = (tid % (kBN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(sI[st] + r * kBN + col);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      const bool krow = it * kBK + r < K;
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t lo = krow ? sLut[b[2 * j]] : 0u;
        const uint32_t hi = krow ? sLut[b[2 * j + 1]] : 0u;
        w[j] = lo | (hi << 16);
      }
      uint4* dst = reinterpret_cast<uint4*>(sB + r * kLDB + col);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();

    const __nv_bfloat16* tA = sA[st];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], tA + (wm * 32 + mt * 16 + (lane & 15)) * kLDA + kc * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        // b-fragments of n-tiles nt and nt + 1, transposed out of row-major W
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, sB + (kc * 16 + (lane & 15)) * kLDB + wn * 64 + nt * 8 +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
          mma_bf16_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // sA[st] and sB are free for the next fill
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + wn * 64 + nt * 8 + t * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + g + half * 8;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        __nv_bfloat16* out = y + (long long)row * N + col;
        if (N % 2 == 0 && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) out[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) out[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 FMA kernel
// ---------------------------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFThreads)
dequant_fma_f32(const float* __restrict__ x, const uint8_t* __restrict__ idx,
                const float* __restrict__ lut, float* __restrict__ y, int M, int K, int N,
                int n_lut) {
  __shared__ float sLut[kLutMax];
  __shared__ __align__(16) float sA[kFBK][kFBM + 4];  // x tile transposed: [k][m]
  __shared__ __align__(16) float sB[kFBK][kFBN + 4];  // expanded weights: [k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  for (int i = tid; i < kLutMax; i += kFThreads) sLut[i] = i < n_lut ? lut[i] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    __syncthreads();  // the LUT is stored and the previous tiles are consumed
    for (int i = tid; i < kFBM * kFBK; i += kFThreads) {
      const int r = i / kFBK, c = i % kFBK;
      sA[c][r] = m0 + r < M && k0 + c < K ? x[(long long)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < kFBK * kFBN; i += kFThreads) {
      const int r = i / kFBN, c = i % kFBN;
      sB[r][c] = k0 + r < K && n0 + c < N ? sLut[idx[(long long)(k0 + r) * N + n0 + c]] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) y[(long long)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// y (M, N) = x (M, K) @ lut[idx (K, N)], all contiguous; lut float32 with
// n_lut <= 256 entries.  dtype: 0 = float32 x and y, 1 = bfloat16.  Returns a
// cudaError_t; cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int palettized_matmul_fwd(const void* x, const void* idx, const void* lut, void* y,
                                     int M, int K, int N, int n_lut, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_lut < 1 || n_lut > kLutMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* ip = static_cast<const uint8_t*>(idx);
  const float* lp = static_cast<const float*>(lut);
  if (dtype == 1) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
    const bool vec = K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(idx) % 16 == 0;
    if (vec)
      dequant_mma_bf16<true><<<grid, kThreads, 0, s>>>(xp, ip, lp, yp, M, K, N, n_lut);
    else
      dequant_mma_bf16<false><<<grid, kThreads, 0, s>>>(xp, ip, lp, yp, M, K, N, n_lut);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) {
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    dequant_fma_f32<<<grid, kFThreads, 0, s>>>(static_cast<const float*>(x), ip, lp,
                                               static_cast<float*>(y), M, K, N, n_lut);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
