// Flash attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_bhsd, once per query stream by
// flash_attention_multi_q).  Same function: non-causal multi-head attention,
// softmax(q k^T / sqrt(D)) v, computed blockwise with an online softmax in
// base 2 (log2 e folded into the logit scale, ex2), the running max and sum
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
//    the context stream's 2 x B*H tiles fill the tail wave of the latent
//    stream's 32 x B*H instead of a second launch.  The single-stream entry
//    is the one-stream case of the same kernels.
//
// What bounds it on the H100.  At the UNet's and the MMDiT's shapes (D = 64,
// 256..4250 keys) the work is 4*S^2*D flops against 4*S*D elements of
// traffic, so it is bound by operations: the products must run on the
// tensor cores at their Hopper rate, which only wgmma reaches, and the
// (S, S) logits must never reach device memory.  At D = 64 the softmax
// weighs as much as the products: one exponential a logit on the SFUs (16 a
// clock an SM) takes as long as the logit's 256 flops on the tensor cores,
// so one warpgroup's softmax has to run under another's products, with the
// bare ex2.approx.  At 256 tokens the whole call moves only a few MB and the
// grid's size matters more.  The VAE's single head (D = 512, f32) is bound
// by the FP32 cores: f32 inputs get no tensor-core path here, because TF32
// would change the f32 result.
//
// What the design does about it.
//  * One thread block per (batch*head, query tile); a loop over KV tiles
//    inside the block takes the place of the TPU grid's sequential KV axis.
//  * Ragged Sq and Sk edges are masked in the kernel (rows past Sq are not
//    stored, columns past Sk get a -1e30 logit), so the TPU kernel's
//    ones-column normalizer / KV mask is not needed.
//  * bf16, D = 64 (flash_wgmma_bf16): warp-specialised.  A producer warp
//    loads the block's q tile once and keeps 128-row k and v tiles in flight
//    in a four-stage ring, all by TMA through 4-D tensor maps over the
//    strided (B, S, H, D) views (one map per query stream; rows past the
//    sequence load as zeros), completion on mbarriers; the consumers release
//    a stage when its products are done.  Two consumer warpgroups own 64
//    query rows each (a 128-row tile): S = q k^T is wgmma m64n128k16 with
//    both operands in shared memory, K-major as they lie in memory; P is
//    rounded to bf16 in registers and fed as wgmma's register A operand of
//    O += P v (m64n64k16), v read from shared memory as an MN-major B (the
//    transpose bit; no transposed copy).  Each warpgroup issues S of tile j
//    and P v of tile j - 1 as one batch with one wait, and the two
//    warpgroups' batches take turns on named barriers, so that one's
//    softmax runs under the other's products.  setmaxnreg moves registers
//    from the producer to the consumers.  Where 128-row tiles would leave SMs
//    idle (fewer than 132 blocks: 256 tokens, a lone 154-row stream) the
//    launch takes the 64-row instantiation: one consumer warpgroup, 64-row
//    kv tiles, registers and shared memory for two blocks an SM.
//  * q, k, v and o are read and written in place through strides: there are
//    no BSHD->BHSD transposes, no pad copies and, for several streams, no q
//    concatenation or output split.  TMA needs 16-byte aligned bases and
//    strides; the wrapper hands over views that have them (ops/
//    flash_attention.py:_vector_ready).
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

#include "hopper.cuh"

namespace {

constexpr float kNegBig = -1e30f;
// streaming multiprocessors of the H100 SXM
constexpr int kSms = 132;

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
  int si;      // the stream's index in the table
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
      r.si = i;
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
// bf16 D = 64 wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kHd = 64;       // head width of the wgmma kernel: one 128-byte row
constexpr int kKvStages = 4;  // k/v tiles in flight

struct FlashParams {
  CUtensorMap tq[kMaxStreams];  // each stream's q, box (64, BQ, 1, 1)
  CUtensorMap tk, tv;           // box (64, BK, 1, 1)
  QStreams streams;
  int H, Sk;
  float scale_log2;
};

template <int NWG, int BK>
constexpr int flash_smem_bytes() {
  // 1024 bytes of slack to align the tiles; q, the k and v ring, barriers
  return 1024 + NWG * 64 * kHd * 2 + 2 * kKvStages * BK * kHd * 2 + (1 + 3 * kKvStages) * 8;
}

// NWG consumer warpgroups of 64 query rows each, then one producer
// warpgroup; BK kv rows a tile.  The 64-row instantiation (short sequences)
// takes 64-row kv tiles and fits two blocks on an SM.
template <int NWG, int BK>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_wgmma_bf16(const __grid_constant__ FlashParams p) {
  constexpr int BQ = 64 * NWG;
  constexpr int kKvTile = BK;
  constexpr int kKvBytes = BK * kHd * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + BQ * kHd * 2;
  uint8_t* sV = sK + kKvStages * kKvBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kKvStages * kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kKvStages;
  uint64_t* empty = v_full + kKvStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const QTile tile = find_tile(p.streams, BQ);
  const int ntiles = (p.Sk + kKvTile - 1) / kKvTile;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer: q once, then k and v tiles into the ring ----
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (tid == NWG * 128) {
      const CUtensorMap* tq = &p.tq[0];
#pragma unroll
      for (int i = 1; i < kMaxStreams; ++i)
        if (i == tile.si) tq = &p.tq[i];
      mbar_arrive_expect_tx(q_full, BQ * kHd * 2);
      tma_load_4d(sQ, tq, q_full, 0, tile.q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kKvStages;
        mbar_wait(&empty[s], ((j / kKvStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], kKvBytes);
        tma_load_4d(sK + s * kKvBytes, &p.tk, &k_full[s], 0, j * kKvTile, h, b);
        mbar_arrive_expect_tx(&v_full[s], kKvBytes);
        tma_load_4d(sV + s * kKvBytes, &p.tv, &v_full[s], 0, j * kKvTile, h, b);
      }
    }
  } else {
    // ---- consumers: S = q k^T, online softmax, O += P v.  S of tile j and
    // P v of tile j - 1 go to the tensor cores as one batch with one wait;
    // a warpgroup's softmax overlaps the other warpgroup's products ----
    if constexpr (NWG == 2) reg_alloc<240>();
    const int wg = tid / 128, wi = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint8_t* q_rows = sQ + wg * 64 * kHd * 2;

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sc[BK / 2];
    uint32_t pf[kKvTile / 16][4];  // P of the last softmax, bf16 A fragments
    // rows g and g + 8 of this warp's 16: running max and (thread-partial) sum
    float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
    float c0 = 1.f, c1 = 1.f;  // the last softmax's rescale of O

    // S = q k_j^T into sc, issued (not waited for)
    auto issue_s = [&](int j) {
      const int s = j % kKvStages;
      mbar_wait(&k_full[s], (j / kKvStages) & 1);
      const uint8_t* tK = sK + s * kKvBytes;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const uint64_t da = desc_sw128(q_rows + 32 * kk, 16, 1024);
        const uint64_t db = desc_sw128(tK + 32 * kk, 16, 1024);
        if constexpr (BK == 128) wgmma_ss_m64n128k16(sc, da, db, kk > 0);
        else wgmma_ss_m64n64k16(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P_j v_j, issued (not waited for)
    auto issue_pv = [&](int j) {
      const int s = j % kKvStages;
      mbar_wait(&v_full[s], (j / kKvStages) & 1);
      const uint8_t* tV = sV + s * kKvBytes;
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(o[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk)
        wgmma_rs_m64n64k16<1>(o, pf[kk], desc_sw128(tV + kk * 16 * kHd * 2, kKvBytes, 1024));
      wgmma_commit();
    };
    // the online softmax of tile j's logits (in sc) into P (bf16 A
    // fragments); sets the rescale c0, c1 that O needs before P_j v_j
    auto softmax = [&](int j) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
      // sc[4n + e]: row g (e < 2) or g + 8, kv column 8n + 2t + (e & 1); the
      // logits stay unscaled (the scale rides the exponent's FMA) and only
      // the tile over the end of the keys is masked
      const int kv0 = j * kKvTile;
      if (kv0 + kKvTile > p.Sk) {
#pragma unroll
        for (int n = 0; n < kKvTile / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kv0 + n * 8 + t * 2 + e >= p.Sk) sc[4 * n + e] = sc[4 * n + 2 + e] = kNegBig;
          }
        }
      }
      float r0 = kNegBig, r1 = kNegBig;
#pragma unroll
      for (int n = 0; n < kKvTile / 8; ++n) {
        r0 = fmaxf(r0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        r1 = fmaxf(r1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
      // running maxima in the scaled (base-2) units
      const float mn0 = fmaxf(m0, r0 * p.scale_log2), mn1 = fmaxf(m1, r1 * p.scale_log2);
      c0 = exp2_ftz(m0 - mn0);
      c1 = exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // probabilities, rounded to bf16 once: the P v product and the
      // normalizer sum the same values (as the TPU kernel's ones-column did)
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < kKvTile / 8; ++n) {
        const float sl = p.scale_log2;
        const uint32_t top = pack_bf16(exp2_ftz(fmaf(sc[4 * n], sl, -mn0)),
                                       exp2_ftz(fmaf(sc[4 * n + 1], sl, -mn0)));
        const uint32_t bot = pack_bf16(exp2_ftz(fmaf(sc[4 * n + 2], sl, -mn1)),
                                       exp2_ftz(fmaf(sc[4 * n + 3], sl, -mn1)));
        const __nv_bfloat162 tv = *reinterpret_cast<const __nv_bfloat162*>(&top);
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(&bot);
        ps0 += __low2float(tv) + __high2float(tv);
        ps1 += __low2float(bv) + __high2float(bv);
        // accumulator layout of n-tiles 2i, 2i+1 == A-fragment layout of k-step i
        pf[n / 2][(n & 1) * 2 + 0] = top;
        pf[n / 2][(n & 1) * 2 + 1] = bot;
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int n = 0; n < kHd / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
    };
    // tile j: S_j and P_{j-1} v_{j-1} in one batch; once both are done the
    // stage of tile j - 1 goes back to the producer, the softmax of tile j
    // runs and O takes its rescale.  (Keeping P v in flight through the
    // softmax needs more registers than the consumers have: ptxas then
    // serialises every wgmma.)
    // With two consumers the batches take turns (named barriers 1 and 2:
    // warpgroup 0's turn, warpgroup 1's), so one warpgroup's softmax runs
    // while the other's products hold the tensor cores.  Each warpgroup
    // issues ntiles + 1 batches; warpgroup 1 opens warpgroup 0's first turn
    // and passes on all but its last.
    auto turn_begin = [&]() {
      if constexpr (NWG == 2) named_bar_sync(1 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NWG == 2) {
        if (!(last && wg == 1)) named_bar_arrive(2 - wg, 256);
      }
    };
    if constexpr (NWG == 2) {
      if (wg == 1) named_bar_arrive(1, 256);
    }
    mbar_wait(q_full, 0);
    turn_begin();
    issue_s(0);
    turn_end(false);
    wgmma_wait<0>();
    softmax(0);
    for (int j = 1; j < ntiles; ++j) {
      turn_begin();
      issue_s(j);
      issue_pv(j - 1);
      turn_end(false);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(o[i]);
      mbar_arrive(&empty[(j - 1) % kKvStages]);
      softmax(j);
      rescale_o();
    }
    turn_begin();
    issue_pv(ntiles - 1);
    turn_end(true);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(o[i]);
    mbar_arrive(&empty[(ntiles - 1) % kKvStages]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const Strides os = tile.os;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(tile.o) + b * os.b + h * os.h;
    const int row0 = tile.q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      const int col = n * 8 + t * 2;
      if (row0 < tile.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * os.s + col) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row1 < tile.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * os.s + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// a (B, S, H, 64) bf16 view with element strides st: 4-D tensor map, box
// (64, rows, 1, 1), 128-byte swizzle
bool head_map(CUtensorMap* map, const void* base, int B, int S, int H, Strides st, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(kHd), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st.s) * 2, static_cast<uint64_t>(st.h) * 2,
                               static_cast<uint64_t>(st.b) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(kHd), static_cast<uint32_t>(rows), 1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NWG, int BK>
cudaError_t launch_flash(const FlashParams& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<NWG, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_bf16<NWG, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_bf16<NWG, BK><<<grid, (NWG + 1) * 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// The 128-row tile (two consumer warpgroups, 128-row kv tiles) unless its
// grid leaves SMs idle, then the 64-row one (one consumer warpgroup, 64-row
// kv tiles).  Returns the cudaError_t of the launch.
cudaError_t launch_wgmma(QStreams streams, const void* k, const void* v, int B, int H, int Sk,
                         Strides ks, Strides vs, float scale_log2, cudaStream_t stream) {
  int tiles128 = 0;
  for (int i = 0; i < streams.n; ++i) tiles128 += (streams.sq[i] + 127) / 128;
  const bool wide = static_cast<long long>(tiles128) * B * H >= kSms;
  const int bq = wide ? 128 : 64, bk = wide ? 128 : 64;
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + bq - 1) / bq;
  FlashParams p{};
  p.streams = streams;
  p.H = H;
  p.Sk = Sk;
  p.scale_log2 = scale_log2;
  bool ok = head_map(&p.tk, k, B, Sk, H, ks, bk) && head_map(&p.tv, v, B, Sk, H, vs, bk);
  for (int i = 0; i < streams.n; ++i)
    ok = ok && head_map(&p.tq[i], streams.q[i], B, streams.sq[i], H, streams.qs[i], bq);
  if (!ok) return cudaErrorNotSupported;
  const dim3 grid(streams.tile0[streams.n], B * H);
  return wide ? launch_flash<2, 128>(p, grid, stream) : launch_flash<1, 64>(p, grid, stream);
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

// One launch over every stream of the table: the wgmma kernel for bf16 at
// D = 64, else the FMA kernel for this (dtype, D) with its tile offsets.
int launch(QStreams streams, const void* k, const void* v, int B, int H, int Sk, int D,
           int dtype, Strides ks, Strides vs, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if (dtype == 1 && D == kHd)
    return static_cast<int>(launch_wgmma(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + kFmaBQ - 1) / kFmaBQ;
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
