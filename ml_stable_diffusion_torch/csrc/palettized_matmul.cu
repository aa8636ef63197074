// Fused dequantize-matmul for palettized weights on Hopper (sm_90a), bound
// to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/palettized.py
// (_dequant_matmul_kernel, launched by _dequant_matmul, wrapped by
// palettized_dense_fused).  Same function: y = x @ W with
// W[k, n] = lut[idx[k * N + n]] rounded to x's dtype, idx the flat uint8
// indices of the (K, N) Dense layout, the products accumulated in f32 and y
// written in x's dtype.  Indices past the LUT read 0 (the TPU kernel's
// select-sum gives 0 there).  A bias is added by the caller, as in the JAX op.
//
// What bounds it on the H100.  At the SD-2.1 UNet's linear layers at CFG
// batch 2 (M = 8192 ... 2 rows, K and N 320 ... 10240) the work is 2*M*K*N
// flops against M*K + M*N bf16 elements and K*N index bytes: the M >= 2048
// calls are bound by the tensor cores, the M <= 512 ones by reading the
// indices (one byte a weight) and by how many of the 132 SMs they keep busy.
// The dense weight never reaches device memory.
//
// What the design does about it.
//  * Operands swapped (layout (ii)): each block computes a tile of
//    y^T = W^T x^T with wgmma m64nBMk16, A = W^T from registers, B = x from
//    shared memory (K-major, as x lies in memory).  A tile's 64 rows are 64
//    columns n of W, so the narrow M side becomes the wgmma's N (BM = 32 ...
//    256) and a block expands each weight of its k range once for all its BM
//    rows of x.  (At BM = 256, 128 accumulators a thread, ptxas serialises
//    the wgmma for want of registers; the tile still beats BM = 128 at two
//    of its three shapes.)  Each consumer thread expands its own A fragment: two
//    ldmatrix.trans of the uint8 index tile (read as 16-bit pairs, so one
//    lane gets the bytes of two n columns at two k rows) and one
//    shared-memory LUT lookup per weight.  The fragment's rows are permuted
//    (row g <-> column 2g, row g + 8 <-> 2g + 1) so that those two columns
//    sit in one 16-bit pair; the epilogue undoes it.  No expanded tile is
//    ever stored.  Layout (i), expanding into a swizzled B tile in shared
//    memory, would store and reload every weight and expand it once per
//    m tile of 64-128 rows, with a barrier between the expansion and the
//    product.  With up to 64 entries (6 bits) the bf16 LUT fits the 32 banks
//    once, so the lookups never conflict.
//  * A pipeline with one wait per k tile.  A producer warp keeps a ring of
//    four to eight 64-deep k tiles in flight by TMA (the x tile 128-byte swizzled,
//    the index tile 128- or 64-byte swizzled so the ldmatrix rows hit
//    distinct banks), completion on mbarriers.  One or two consumer
//    warpgroups (BN = 64 or 128 columns of W) wait once per tile, expand it
//    while the tensor cores still run the previous tile's products
//    (wgmma_wait<1>), and release a stage as soon as its products are done.
//    setmaxnreg moves registers from the producer to the consumers.
//  * A launch plan that fills the card (ops/palettized.py:launch_plan,
//    computed in Python and passed in): narrower tiles first (BM down to 64,
//    then BN 64), then K split across blocks.  A split writes f32 partial
//    sums to a workspace the wrapper allocates; a second small pass adds the
//    splits in a fixed order, so the same inputs give the same bits.
//  * Ragged M, K and N need no padding copies: TMA loads zeros past the
//    edges of x and of the indices (zero x rows and columns cancel whatever
//    the padded weights hold), rows and columns past M and N are not stored.
//    Where TMA cannot take a layout (K not a multiple of 8, N of 16, or an
//    unaligned base) the producer warpgroup loads the same swizzled tiles
//    element by element.
//  * f32 x: an FMA kernel on the CUDA cores, LUT kept in f32, no TF32 (the
//    port's float32 numerics rule, utils/numerics.py).
//
// The C entry returns cudaGetLastError() after the launches; the Python
// wrapper raises when it is not 0.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kLutMax = 256;

// ---------------------------------------------------------------------------
// bf16 wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kBK = 64;  // depth of one k tile: one 128-byte row of bf16 x

struct PalParams {
  CUtensorMap tm_x;    // x (M, K) bf16: box (64 k, BM rows), 128-byte swizzle
  CUtensorMap tm_idx;  // idx (K, N) uint8: box (BN n, 64 k), BN-byte swizzle
  const __nv_bfloat16* x;
  const uint8_t* idx;
  const float* lut;
  __nv_bfloat16* y;
  float* ws;  // (splits, M, N) f32 partial sums when splits > 1
  int M, K, N, n_lut;
  int tiles_per_split;
  int splits;
  int use_tma;
};

template <int BM, int BN>
__host__ __device__ constexpr int pal_stage_bytes() {
  return BM * 128 + kBK * BN;
}

// k tiles in flight: as many as fit 100 KB (two blocks an SM at BN = 64) up
// to 8, at least 4 (the BM = 256 tile takes 160 KB)
template <int BM, int BN>
__host__ __device__ constexpr int pal_stages() {
  return pal_stage_bytes<BM, BN>() * 4 > 100 * 1024
             ? 4
             : (100 * 1024 / pal_stage_bytes<BM, BN>() < 8 ? 100 * 1024 / pal_stage_bytes<BM, BN>()
                                                             : 8);
}

template <int BM, int BN>
constexpr int pal_smem_bytes() {
  // 1024 bytes of slack to align the ring, the LUT, two barriers a stage
  return 1024 + pal_stages<BM, BN>() * pal_stage_bytes<BM, BN>() + kLutMax * 2 +
         2 * pal_stages<BM, BN>() * 8;
}

// byte offset of index (k row r, column c) in a swizzled index tile
template <int BN>
__device__ __forceinline__ int idx_swz(int r, int c) {
  if constexpr (BN == 128) return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
  else return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

// two LUT entries (bf16 bits) -> one register, the first in the low half
__device__ __forceinline__ uint32_t lut_pair(const uint16_t* lut, uint32_t i0, uint32_t i1) {
  return static_cast<uint32_t>(lut[i0]) | (static_cast<uint32_t>(lut[i1]) << 16);
}

template <int BM, int BN>
__global__ void __launch_bounds__((BN / 64 + 1) * 128, 1)
dequant_wgmma_bf16(const __grid_constant__ PalParams p) {
  constexpr int NWG = BN / 64;  // consumer warpgroups, 64 columns of W each
  constexpr int kXBytes = BM * 128;
  constexpr int kStage = pal_stage_bytes<BM, BN>();
  constexpr int kStages = pal_stages<BM, BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint16_t* sLut = reinterpret_cast<uint16_t*>(smem + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(sLut + kLutMax);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_tiles = (p.K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int nk = min(kt0 + p.tiles_per_split, k_tiles) - kt0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], p.use_tma ? 1 : 128);
      mbar_init(&empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer warpgroup: keeps the ring of k tiles full ----
    if constexpr (NWG == 2) reg_dealloc<56>();
    const int pt = tid - NWG * 128;
    if (p.use_tma) {
      if (pt == 0) {
        prefetch_tensor_map(&p.tm_x);
        prefetch_tensor_map(&p.tm_idx);
        for (int it = 0; it < nk; ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * kStage;
          mbar_arrive_expect_tx(&full[s], kStage);
          const int k0 = (kt0 + it) * kBK;
          tma_load_2d(st, &p.tm_x, &full[s], k0, m0);
          tma_load_2d(st + kXBytes, &p.tm_idx, &full[s], n0, k0);
        }
      }
    } else {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        const int k0 = (kt0 + it) * kBK;
        __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(st);
        for (int i = pt; i < BM * kBK; i += 128) {
          const int r = i / kBK, c = i % kBK;
          const bool ok = m0 + r < p.M && k0 + c < p.K;
          sx[(r * 128 + ((((c >> 3) ^ r) & 7) << 4)) / 2 + (c & 7)] =
              ok ? p.x[(long long)(m0 + r) * p.K + k0 + c] : __float2bfloat16_rn(0.f);
        }
        for (int i = pt; i < kBK * BN; i += 128) {
          const int r = i / BN, c = i % BN;
          const bool ok = k0 + r < p.K && n0 + c < p.N;
          st[kXBytes + idx_swz<BN>(r, c)] = ok ? p.idx[(long long)(k0 + r) * p.N + n0 + c] : 0;
        }
        fence_proxy_async();  // the x tile is read by wgmma
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumer warpgroups: expand W^T fragments, multiply ----
    if constexpr (NWG == 2) reg_alloc<224>();
    // the LUT loads while the producer's first tiles are in flight: entries
    // past n_lut read 0; rounded to bf16 once, as the TPU kernel's
    // w.astype(x.dtype)
    for (int i = tid; i < kLutMax; i += NWG * 128)
      sLut[i] = __bfloat16_as_ushort(__float2bfloat16_rn(i < p.n_lut ? p.lut[i] : 0.f));
    named_bar_sync(1, NWG * 128);
    const int wg = tid / 128, wi = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;
    // the 16-byte chunk of index columns this warp expands: its 16 columns
    const int chunk = wg * 4 + wi;

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

    uint32_t frag[2][16];
    auto step = [&](uint32_t(&f)[16], int it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint8_t* st = smem + s * kStage;
      const uint8_t* sidx = st + kXBytes;
      // lane L addresses row L % 8 of matrix L / 8: k rows 32h + 8 (L / 8) ..
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * h + lane;  // lanes 0-31 cover k rows 32h .. 32h + 31
        uint32_t q[4];
        ldmatrix_x4_trans(q, sidx + idx_swz<BN>(r, chunk * 16));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          // bytes: (k 2tq, n 2g), (k 2tq, n 2g+1), (k 2tq+1, n 2g), (k 2tq+1, n 2g+1)
          const uint32_t b0 = q[m] & 0xFF, b1 = (q[m] >> 8) & 0xFF;
          const uint32_t b2 = (q[m] >> 16) & 0xFF, b3 = q[m] >> 24;
          const int ks = 2 * h + (m >> 1), hi = (m & 1) * 2;
          f[4 * ks + hi] = lut_pair(sLut, b0, b2);      // row g: column 2g
          f[4 * ks + hi + 1] = lut_pair(sLut, b1, b3);  // row g + 8: column 2g + 1
        }
      }
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t db = desc_sw128(st + 32 * ks, 16, 1024);
        if constexpr (BM == 32) wgmma_rs_m64n32k16<0>(acc, &f[4 * ks], db);
        else if constexpr (BM == 64) wgmma_rs_m64n64k16<0>(acc, &f[4 * ks], db);
        else if constexpr (BM == 128) wgmma_rs_m64n128k16<0>(acc, &f[4 * ks], db);
        else wgmma_rs_m64n256k16<0>(acc, &f[4 * ks], db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) fence_operand(acc[i]);
      if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
    };
    int it = 0;
    for (; it + 1 < nk; it += 2) {
      step(frag[0], it);
      step(frag[1], it + 1);
    }
    if (it < nk) step(frag[0], it);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) fence_operand(acc[i]);

    // acc[4j + e]: A row g (+8 for e >= 2) = column n, n + 1 of W; x row
    // m0 + 8j + 2tq (+1 for odd e)
    const int n = n0 + wg * 64 + wi * 16 + 2 * g;
    const bool pair = n + 1 < p.N && (p.N % 2) == 0;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tq + e;
        if (m >= p.M || n >= p.N) continue;
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        if (p.splits == 1) {
          __nv_bfloat16* out = p.y + (long long)m * p.N + n;
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
          } else {
            out[0] = __float2bfloat16_rn(v0);
            if (n + 1 < p.N) out[1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* out = p.ws + ((long long)blockIdx.z * p.M + m) * p.N + n;
          if (pair) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            out[0] = v0;
            if (n + 1 < p.N) out[1] = v1;
          }
        }
      }
    }
  }
}

// y = bf16(sum over the splits of the f32 partial sums), in split order
__global__ void splitk_reduce(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                              long long mn, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * mn + i];
    y[i] = __float2bfloat16_rn(s);
  }
}

template <int BM, int BN>
cudaError_t launch_wgmma(const PalParams& p, cudaStream_t stream) {
  constexpr int smem = pal_smem_bytes<BM, BN>();
  cudaError_t err = cudaFuncSetAttribute(dequant_wgmma_bf16<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (p.K + kBK - 1) / kBK;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM,
                  (k_tiles + p.tiles_per_split - 1) / p.tiles_per_split);
  dequant_wgmma_bf16<BM, BN><<<grid, (BN / 64 + 1) * 128, smem, stream>>>(p);
  return cudaGetLastError();
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
// n_lut <= 256 entries.  dtype: 0 = float32 x and y (FMA kernel; the plan
// arguments are not read), 1 = bfloat16.  The bf16 launch plan (tile rows
// bm of x, columns bn of W, K split into `splits` ranges of
// `tiles_per_split` 64-deep tiles) comes from ops/palettized.py:launch_plan;
// with splits > 1, ws holds splits * M * N floats.  Returns a cudaError_t;
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int palettized_matmul_fwd(const void* x, const void* idx, const void* lut, void* y,
                                     void* ws, int M, int K, int N, int n_lut, int dtype,
                                     int bm, int bn, int splits, int tiles_per_split,
                                     void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_lut < 1 || n_lut > kLutMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* ip = static_cast<const uint8_t*>(idx);
  const float* lp = static_cast<const float*>(lut);
  if (dtype == 1) {
    const int k_tiles = (K + kBK - 1) / kBK;
    const bool plan_ok = tiles_per_split >= 1 && splits >= 1 &&
                         (splits - 1) * tiles_per_split < k_tiles &&
                         splits * tiles_per_split >= k_tiles && (splits == 1 || ws != nullptr) &&
                         (bn == 128 || (bn == 64 && bm <= 64)) && (M + bm - 1) / bm <= 65535 &&
                         splits <= 65535;
    if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
    PalParams p{};
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.idx = ip;
    p.lut = lp;
    p.y = static_cast<__nv_bfloat16*>(y);
    p.ws = static_cast<float*>(ws);
    p.M = M;
    p.K = K;
    p.N = N;
    p.n_lut = n_lut;
    p.tiles_per_split = tiles_per_split;
    p.splits = splits;
    // TMA wants 16-byte aligned bases and row strides
    p.use_tma = K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(idx) % 16 == 0;
    if (p.use_tma) {
      const uint64_t xd[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
      const uint64_t xs[1] = {static_cast<uint64_t>(K) * 2};
      const uint32_t xb[2] = {static_cast<uint32_t>(kBK), static_cast<uint32_t>(bm)};
      const uint64_t id[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
      const uint64_t is[1] = {static_cast<uint64_t>(N)};
      const uint32_t ib[2] = {static_cast<uint32_t>(bn), static_cast<uint32_t>(kBK)};
      if (!make_tensor_map(&p.tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xd, xs, xb,
                           CU_TENSOR_MAP_SWIZZLE_128B) ||
          !make_tensor_map(&p.tm_idx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, idx, id, is, ib,
                           bn == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
        return static_cast<int>(cudaErrorNotSupported);
    }
    cudaError_t err = cudaErrorInvalidValue;
    if (bn == 128) {
      switch (bm) {
        case 32: err = launch_wgmma<32, 128>(p, s); break;
        case 64: err = launch_wgmma<64, 128>(p, s); break;
        case 128: err = launch_wgmma<128, 128>(p, s); break;
        case 256: err = launch_wgmma<256, 128>(p, s); break;
        default: break;
      }
    } else {
      switch (bm) {
        case 32: err = launch_wgmma<32, 64>(p, s); break;
        case 64: err = launch_wgmma<64, 64>(p, s); break;
        default: break;
      }
    }
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const long long mn = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>(std::min<long long>((mn + 255) / 256, 4 * 132));
    splitk_reduce<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws), p.y, mn, splits);
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
