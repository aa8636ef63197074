// Flash attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_bhsd, once per query stream by
// flash_attention_multi_q).  Same function: non-causal multi-head attention,
// softmax(q k^T / sqrt(D)) v, computed blockwise with an online softmax in
// base 2 (log2 e folded into the logit scale, exp2f), the running max and sum
// kept in f32, one division at the end.
//
// Two C entries share one launch path:
//  * flash_attention_fwd: one query stream (the UNet and VAE self-attention);
//  * flash_attention_multi_q_fwd: up to 4 query streams over ONE shared k/v,
//    the MMDiT joint attention (SD3-medium 1024^2: 4096 latent rows and 154
//    context rows over the 4250 concatenated keys).  It is the same as
//    attending the concatenated queries and splitting.  One launch covers
//    every stream: blockIdx.x counts the query tiles of all streams and each
//    block finds its stream in a small table passed by value (QStreams), so
//    the context stream's 3 x B*H tiles fill the tail wave of the latent
//    stream's 64 x B*H instead of a second launch.  The single-stream entry
//    is the one-stream case of the same kernels.
//
// What bounds it on the H100.  At the UNet's shapes (D = 64, 256..4096 tokens)
// the work is 4*S^2*D flops against 4*S*D elements of traffic, so it is bound
// by operations: the products must run on the tensor cores, and the (S, S)
// logits must never reach device memory.  At 256 tokens the whole call moves
// only a few MB and launch and load latency dominate.  The VAE's single head
// (D = 512, f32) is bound by the FP32 cores: f32 inputs get no tensor-core
// path here, because TF32 would change the f32 result.
//
// What the design does about it.
//  * One thread block per (batch*head, query tile); a loop over KV tiles
//    inside the block takes the place of the TPU grid's sequential KV axis.
//  * q, k and v are read in place from their (B, S, H, D) layout through
//    strides: there are no BSHD->BHSD transposes, no pad copies and, for
//    several streams, no q concatenation or output split.
//  * Ragged Sq and Sk edges are masked in the kernel (rows past Sq are not
//    stored, columns past Sk get a -1e30 logit), so the TPU kernel's
//    ones-column normalizer / KV mask is not needed.
//  * bf16, D = 64: mma.sync m16n8k16 (bf16 in, f32 accumulate).  Each warp
//    owns 16 query rows; logits, probabilities and the output accumulator
//    stay in registers, and P is re-packed from the accumulator layout into
//    the A-operand layout without touching shared memory.  Operands come
//    from shared memory by ldmatrix (v transposed on the way); the next k/v
//    tile streams in by cp.async while the current one is computed.
//  * Any other supported case (f32, or D = 512): FMA on the CUDA cores,
//    register-tiled: a warp owns 4 query rows, so its q and P reads are
//    broadcasts, and each lane keeps 4 x D/32 outputs in registers.  q, one
//    k|v tile and P live in dynamic shared memory (201 KB at D = 512, so the
//    launch raises the dynamic shared-memory limit first).
//
// The C entry returns cudaGetLastError() after the launch; the Python wrapper
// raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr float kNegBig = -1e30f;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head axes
};

constexpr int kMaxStreams = 4;

// The query streams of one launch; every stream attends over the same k/v.
// Stream i owns the query tiles [tile0[i], tile0[i + 1]) of blockIdx.x.
struct QStreams {
  const void* q[kMaxStreams];
  void* o[kMaxStreams];
  int sq[kMaxStreams];
  int tile0[kMaxStreams + 1];
  Strides qs[kMaxStreams], os[kMaxStreams];
  int n;
};

struct QTile {
  const void* q;
  void* o;
  int sq, q0;  // the stream's length and this block's first query row
  Strides qs, os;
};

// This block's stream.  Unrolled over the table with constant indices, so the
// table is read from the parameter bank and never copied to local memory.
__device__ __forceinline__ QTile find_tile(const QStreams& t, int bq) {
  const int x = static_cast<int>(blockIdx.x);
  int si = 0;
#pragma unroll
  for (int i = 1; i < kMaxStreams; ++i)
    if (i < t.n && x >= t.tile0[i]) si = i;
  QTile r{};
#pragma unroll
  for (int i = 0; i < kMaxStreams; ++i) {
    if (i == si) {
      r.q = t.q[i];
      r.o = t.o[i];
      r.sq = t.sq[i];
      r.q0 = (x - t.tile0[i]) * bq;
      r.qs = t.qs[i];
      r.os = t.os[i];
    }
  }
  return r;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
flash_mma_bf16(const __grid_constant__ QStreams streams, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, int H, int Sk, Strides ks, Strides vs,
               float scale_log2) {
  constexpr int BQ = 64;       // query rows per block: 4 warps x 16
  constexpr int BK = 64;       // kv rows per tile
  constexpr int LDS = D + 8;   // padded smem row (bf16): conflict-free ldmatrix
  constexpr int KC = D / 16;   // k-steps over the head dim in q k^T
  constexpr int NT = BK / 8;   // n-tiles over kv in the logits
  constexpr int PC = BK / 16;  // k-steps over kv in P v
  constexpr int DT = D / 8;    // n-tiles over the head dim in the output
  constexpr int VPR = D / 8;   // 16-byte vectors per row
  static_assert(BQ == BK, "load_tile moves 64-row tiles of q, k and v alike");

  // q, and two stages of k and v: the next tile loads while this one computes
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[2][BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[2][BK * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const QTile tile = find_tile(streams, BQ);
  const int Sq = tile.sq, q0 = tile.q0;
  const Strides qs = tile.qs, os = tile.os;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(tile.q) + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(tile.o) + b * os.b + h * os.h;

  // rows at or past `limit` load as zeros
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int row0,
                       int limit) {
    for (int idx = tid; idx < BQ * VPR; idx += 128) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const bool valid = row0 + r < limit;
      cp_async_16(dst + r * LDS + c, valid ? src + (long long)(row0 + r) * ss + c : src, valid);
    }
  };

  const int ntiles = (Sk + BK - 1) / BK;
  load_tile(sQ, qb, qs.s, q0, Sq);
  load_tile(sK[0], kb, ks.s, 0, Sk);
  load_tile(sV[0], vb, vs.s, 0, Sk);
  cp_async_commit();

  uint32_t qf[KC][4];
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  // rows g and g + 8 of this warp's 16: running max and (thread-partial) sum
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_tile(sK[st ^ 1], kb, ks.s, (it + 1) * BK, Sk);
      load_tile(sV[st ^ 1], vb, vs.s, (it + 1) * BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just requested
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], sQ + (warp * 16 + (lane & 15)) * LDS + kc * 16 + (lane >> 4) * 8);
    }

    const __nv_bfloat16* tK = sK[st];
    const __nv_bfloat16* tV = sV[st];
    const int kv0 = it * BK;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        // b-fragments of n-tiles nt and nt + 1 (k rows are the B columns)
        uint32_t bf[4];
        ldmatrix_x4(bf, tK + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kc * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[nt], qf[kc], bf[0], bf[1]);
        mma_bf16_16816(s[nt + 1], qf[kc], bf[2], bf[3]);
      }
    }

    float r0 = kNegBig, r1 = kNegBig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = kv0 + nt * 8 + t * 2 + e < Sk;
        s[nt][e] = valid ? s[nt][e] * scale_log2 : kNegBig;
        s[nt][2 + e] = valid ? s[nt][2 + e] * scale_log2 : kNegBig;
        r0 = fmaxf(r0, s[nt][e]);
        r1 = fmaxf(r1, s[nt][2 + e]);
      }
    }
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
    const float mn0 = fmaxf(m0, r0), mn1 = fmaxf(m1, r1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // probabilities, rounded to bf16 once: the P v product and the
    // normalizer sum the same values (as the TPU kernel's ones-column did)
    uint32_t pf[PC][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t top = pack_bf16(exp2f(s[nt][0] - mn0), exp2f(s[nt][1] - mn0));
      const uint32_t bot = pack_bf16(exp2f(s[nt][2] - mn1), exp2f(s[nt][3] - mn1));
      const __nv_bfloat162 tv = *reinterpret_cast<const __nv_bfloat162*>(&top);
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(&bot);
      ps0 += __low2float(tv) + __high2float(tv);
      ps1 += __low2float(bv) + __high2float(bv);
      // accumulator layout of n-tiles 2j, 2j+1 == A-operand layout of k-step j
      pf[nt / 2][(nt & 1) * 2 + 0] = top;
      pf[nt / 2][(nt & 1) * 2 + 1] = bot;
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;

#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= c0;
      acc[dt][1] *= c0;
      acc[dt][2] *= c1;
      acc[dt][3] *= c1;
    }
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
#pragma unroll
      for (int pc = 0; pc < PC; ++pc) {
        // b-fragments of d-tiles dt and dt + 1, transposed out of row-major v
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, tV + (pc * 16 + (lane & 15)) * LDS + dt * 8 + (lane >> 4) * 8);
        mma_bf16_16816(acc[dt], pf[pc], bf[0], bf[1]);
        mma_bf16_16816(acc[dt + 1], pf[pc], bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * os.s + col) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * os.s + col) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// FMA kernel (f32 inputs, and any dtype at D = 512)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;
constexpr int kFmaBQ = 32;  // query rows per block: 8 warps x 4 rows
constexpr int kFmaBK = 64;  // kv rows per tile: 2 columns per lane

template <int D>
constexpr int fma_smem_bytes() {
  // q transposed (D x BQ), one k or v tile (BK x (D + 1)), P transposed
  // (BK x (BQ + 4))
  return (D * kFmaBQ + kFmaBK * (D + 1) + kFmaBK * (kFmaBQ + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_fma(const __grid_constant__ QStreams streams, const T* __restrict__ k,
          const T* __restrict__ v, int H, int Sk, Strides ks, Strides vs, float scale_log2) {
  constexpr int BQ = kFmaBQ, BK = kFmaBK;
  constexpr int LD = D + 1;     // padded k|v rows: column reads hit distinct banks
  constexpr int LDP = BQ + 4;   // P rows stay 16-byte aligned
  constexpr int CPT = D / 32;   // output columns per lane
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;            // [d][r]
  float* sKV = sQt + D * BQ;    // [j][d], holds k, then v, of one tile
  float* sPt = sKV + BK * LD;   // [j][r]

  // a warp owns 4 query rows; its lanes split the kv columns (logits) and
  // the head dim (output), so the 4 rows' q and P values are warp broadcasts
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 4;
  const int lane = tid & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const QTile tile = find_tile(streams, BQ);
  const int Sq = tile.sq, q0 = tile.q0;
  const Strides qs = tile.qs, os = tile.os;

  const T* qb = static_cast<const T*>(tile.q) + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = static_cast<T*>(tile.o) + b * os.b + h * os.h;

  // 4 elements per load (the wrapper aligns rows to 16 bytes), unrolled so
  // that many loads are in flight at once
  auto load_rows = [&](const T* src, long long ss, int row0) {
#pragma unroll 8
    for (int idx = tid; idx < BK * D / 4; idx += kFmaThreads) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      const float4 x = row0 + r < Sk ? load4(src + (long long)(row0 + r) * ss + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      float* dst = sKV + r * LD + c;
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    }
  };

  for (int idx = tid; idx < BQ * D; idx += kFmaThreads) {
    const int r = idx / D, c = idx % D;
    sQt[c * BQ + r] = q0 + r < Sq ? to_float(qb[(long long)(q0 + r) * qs.s + c]) : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  float m[4] = {kNegBig, kNegBig, kNegBig, kNegBig};
  float l[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kv0 = 0; kv0 < Sk; kv0 += BK) {
    __syncthreads();  // previous v tile consumed (and q stored)
    load_rows(kb, ks.s, kv0);
    __syncthreads();

    float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(sQt + d * BQ + r0);
      const float k0 = sKV[lane * LD + d], k1 = sKV[(lane + 32) * LD + d];
      s[0][0] = fmaf(qv.x, k0, s[0][0]);
      s[0][1] = fmaf(qv.x, k1, s[0][1]);
      s[1][0] = fmaf(qv.y, k0, s[1][0]);
      s[1][1] = fmaf(qv.y, k1, s[1][1]);
      s[2][0] = fmaf(qv.z, k0, s[2][0]);
      s[2][1] = fmaf(qv.z, k1, s[2][1]);
      s[3][0] = fmaf(qv.w, k0, s[3][0]);
      s[3][1] = fmaf(qv.w, k1, s[3][1]);
    }

    float corr[4], p[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[i][e] = kv0 + lane + 32 * e < Sk ? s[i][e] * scale_log2 : kNegBig;
      float rmax = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mn = fmaxf(m[i], rmax);
      corr[i] = exp2f(m[i] - mn);
      m[i] = mn;
      p[i][0] = exp2f(s[i][0] - mn);
      p[i][1] = exp2f(s[i][1] - mn);
      float psum = p[i][0] + p[i][1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr[i] + psum;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(sPt + (lane + 32 * e) * LDP + r0) =
          make_float4(p[0][e], p[1][e], p[2][e], p[3][e]);

    __syncthreads();  // k tile consumed, P complete
    load_rows(vb, vs.s, kv0);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr[i];
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(sPt + j * LDP + r0);
      const float* vrow = sKV + j * LD + lane;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vrow[32 * c];
        acc[0][c] = fmaf(pv.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pv.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pv.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pv.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (q0 + r0 + i < Sq) {
      const float inv = 1.f / l[i];
      T* orow = ob + (long long)(q0 + r0 + i) * os.s;
#pragma unroll
      for (int c = 0; c < CPT; ++c) orow[lane + 32 * c] = from_float<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const QStreams& streams, const void* k, const void* v, int B, int H,
                       int Sk, Strides ks, Strides vs, float scale_log2, cudaStream_t stream) {
  constexpr int smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(streams.tile0[streams.n], B * H);
  flash_fma<T, D><<<grid, kFmaThreads, smem, stream>>>(
      streams, static_cast<const T*>(k), static_cast<const T*>(v), H, Sk, ks, vs, scale_log2);
  return cudaGetLastError();
}

// One launch over every stream of the table: fills in the tile offsets for
// the kernel that takes this (dtype, D), then launches it.
int launch(QStreams streams, const void* k, const void* v, int B, int H, int Sk, int D,
           int dtype, Strides ks, Strides vs, cudaStream_t stream) {
  const bool mma = dtype == 1 && D == 64;
  const int bq = mma ? 64 : kFmaBQ;
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + bq - 1) / bq;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if (mma) {
    dim3 grid(streams.tile0[streams.n], B * H);
    flash_mma_bf16<64><<<grid, 128, 0, stream>>>(
        streams, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), H,
        Sk, ks, vs, scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1 && D == 512)
    return static_cast<int>(
        launch_fma<__nv_bfloat16, 512>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 0 && D == 64)
    return static_cast<int>(
        launch_fma<float, 64>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 0 && D == 512)
    return static_cast<int>(
        launch_fma<float, 512>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns a
// cudaError_t; cudaErrorInvalidValue for a (dtype, D) the kernels lack.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Sq, int Sk, int D, int dtype, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh, long long o_sb,
                                   long long o_ss, long long o_sh, void* stream) {
  QStreams streams{};
  streams.n = 1;
  streams.q[0] = q;
  streams.o[0] = o;
  streams.sq[0] = Sq;
  streams.qs[0] = Strides{q_sb, q_ss, q_sh};
  streams.os[0] = Strides{o_sb, o_ss, o_sh};
  return launch(streams, k, v, B, H, Sk, D, dtype, Strides{k_sb, k_ss, k_sh},
                Strides{v_sb, v_ss, v_sh}, static_cast<cudaStream_t>(stream));
}

// n query streams (1..4) over one k/v.  q[i] and o[i] are (B, sq[i], H, D);
// q_strides and o_strides hold each stream's (batch, sequence, head) strides,
// 3 per stream.  Same dtype codes and return value as flash_attention_fwd.
extern "C" int flash_attention_multi_q_fwd(int n, const void* const* q, void* const* o,
                                           const int* sq, const long long* q_strides,
                                           const long long* o_strides, const void* k,
                                           const void* v, int B, int H, int Sk, int D,
                                           int dtype, long long k_sb, long long k_ss,
                                           long long k_sh, long long v_sb, long long v_ss,
                                           long long v_sh, void* stream) {
  if (n < 1 || n > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  QStreams streams{};
  streams.n = n;
  for (int i = 0; i < n; ++i) {
    streams.q[i] = q[i];
    streams.o[i] = o[i];
    streams.sq[i] = sq[i];
    streams.qs[i] = Strides{q_strides[3 * i], q_strides[3 * i + 1], q_strides[3 * i + 2]};
    streams.os[i] = Strides{o_strides[3 * i], o_strides[3 * i + 1], o_strides[3 * i + 2]};
  }
  return launch(streams, k, v, B, H, Sk, D, dtype, Strides{k_sb, k_ss, k_sh},
                Strides{v_sb, v_ss, v_sh}, static_cast<cudaStream_t>(stream));
}
