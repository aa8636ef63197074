// Flash attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernel ml_stable_diffusion_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_bhsd, once per query stream by
// flash_attention_multi_q).  Same function: non-causal multi-head attention,
// softmax(q k^T / sqrt(D)) v, computed blockwise with an online softmax in
// base 2 (log2 e folded into the logit scale, ex2), the running max and sum
// kept in f32, one division at the end.
//
// Two C entries share one launch path (f32 at D = 512 takes two more,
// flash_split_tf32_fwd and flash_attention_wide_f32_fwd, over the same
// stream table; see below):
//  * flash_attention_fwd: one query stream (the UNet's self-attention);
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
// grid's size matters more.  SD-1.5's widths differ (builds of the kernel
// with parts removed, timed on the card, showed what bounds each):
//  * D = 40, 4096 tokens: a logit takes 192 tensor-core flops (q k^T over 48
//    columns, P v over 40, the row sum over 8), less than one exponential's
//    time, so the SFU would bound the softmax; but each 128-row query tile
//    streams its head's whole k and v (80-byte rows 640 bytes apart) through
//    L2 and TMA, 335 MB a call, and without the cluster below that streaming
//    alone took nearly the kernel's whole time; with it, the loads, the
//    products and the softmax each hold a share and none the whole;
//  * D = 80, 1024 tokens: 128-row tiles give 128 blocks, under one wave of
//    132 SMs (64-row tiles gave two waves of one block an SM);
//  * 256-308 keys (long prompts, the multilingual projection): two or three
//    kv tiles a query tile, so a block's start-up (q load, the first S alone)
//    and drain (the last P v alone, the store) are most of its time;
//  * D = 160 (256 tokens, 64 blocks) is bound by latency and stays on the
//    per-tile kernel: the persistent one gained nothing there.
// The VAE's single head (D = 512, f32, 4096 or
// 16384 tokens, one call an image) is bound by operations too, and must stay
// f32-exact: single-pass TF32 (10-bit mantissas) would move the output by
// ~4e-4 rel RMS.  The split-precision form "3xTF32" keeps it at f32's
// order on the tensor cores: x = hi + lo with hi = tf32(x), lo = tf32(x -
// hi), a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the a_lo*b_lo term and lo's
// own rounding are ~2^-22 of a product), f32 accumulation.  Three TF32
// products at 495 TFLOP/s give 165 TFLOP/s of f32-exact work, against 67 on
// the FMA units.  At D = 512 an output row is 2 KB of f32, so a 64-row tile
// of O already fills half the register file, and re-reading the hi and lo
// tiles of q, k and v (8 bytes an element) from L2 is the next limit.

// What the design does about it.
//  * One thread block per (batch*head, query tile); a loop over KV tiles
//    inside the block takes the place of the TPU grid's sequential KV axis.
//  * Ragged Sq and Sk edges are masked in the kernel (rows past Sq are not
//    stored, columns past Sk get a -1e30 logit), so the TPU kernel's
//    ones-column normalizer / KV mask is not needed.
//  * bf16, D = 64 and 160 (flash_wgmma_bf16): warp-specialised.  A producer warp
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
//    kv tiles, registers and shared memory for two blocks an SM.  D = 160
//    takes it always, its head as three zero-padded 64-column chunks.
//  * bf16, D = 40 and 80 (flash_wgmma_persistent): the same producer and
//    consumers, but
//    - persistent: a block an SM walks work units (a query tile of one head,
//      a pair of them at D = 40), its producer loading the next unit's q and
//      first kv tiles while this one runs, so short kv loops do not pay their
//      start-up and drain alone;
//    - at D = 40, clusters of two blocks on adjacent query tiles of one head:
//      one multicasts each k tile into both blocks' rings, the other each v
//      tile, and a stage is free once all eight consumer warps of the pair
//      have released it.  The streaming that bound this width halves;
//    - P v at N = D (m64n40k16, m64n80k16; at 80 the MN-major descriptor's
//      LBO steps from one chunk's swizzle atom to the next), and the row sums
//      on the tensor cores: P times a 16 x 8 tile of ones (m64n8k16) in the
//      same group, so the softmax does no unpacking and adding of P;
//    - the softmax of S_j runs under P_{j-1} v_{j-1}: S_j and P_{j-1} v_{j-1}
//      go out as two groups and wgmma_wait<1> releases S_j alone.  P stays
//      f32 in S's registers until P_{j-1} v_{j-1} is done, then is packed to
//      bf16 straight into P v's A fragments: copying packed P from S's
//      registers into them made ptxas serialise every wgmma (C7511);
//    - at D = 40 one exponential in eight runs on the FMA pipe (exp2_fma in
//      hopper.cuh), beside the SFU;
//    - 128-row query and kv tiles (two consumer warpgroups) where they leave
//      at most half the SMs without one (D = 80 at 1024 tokens: 128 blocks),
//      else 64-row ones; the last kv tile of a unit is masked by selects, not
//      a branch, since P v is in flight.
//  * q, k, v and o are read and written in place through strides: there are
//    no BSHD->BHSD transposes, no pad copies and, for several streams, no q
//    concatenation or output split.  TMA needs 16-byte aligned bases and
//    strides; the wrapper hands over views that have them (ops/
//    flash_attention.py:_vector_ready).
//  * f32, D = 512 (flash_wgmma_3xtf32, its own C entries):
//    - a pre-pass (flash_split_tf32) writes hi and lo of q and k, and of v
//      transposed to (D, keys) (tf32 B operands must be K-major: wgmma's
//      transpose bits exist for 16-bit types only), into a workspace, each
//      stream padded to 64 rows and the keys to 64 with zeros: the main
//      loop does no splitting and no masking of loads;
//    - a block holds 64 query rows.  Its two warpgroups each own 256 of the
//      512 output columns (128 f32 accumulators a thread) and compute S over
//      their 256 columns of q and k; the partial S go through shared memory
//      and both warpgroups add them (a + b is b + a, so both hold the same
//      bits) and run the same online softmax; P is split again and written
//      to shared memory as the A operand of O += P v.  Every product is
//      wgmma m64n64k8 on tf32, both operands in shared memory, the two small
//      terms first;
//    - thread 0 of each warpgroup keeps its ring of hi + lo tile pairs (32
//      columns of 64 rows: one 128-byte swizzled row each) filled by TMA,
//      refilling a stage once the products that read it have completed; no
//      producer warp, so the block has 256 threads and ptxas its
//      255-register budget (168 for a 384-thread block);
//    - the keys are split across blocks when the query tiles alone leave
//      SMs idle, and into ranges of at most 2048 keys in any case (the
//      tensor cores' f32 accumulation drifts with the chain's length); a
//      combine pass merges the splits' (max, sum, O) in split order, no
//      atomics.
//  * f32 at D = 64 and bf16 at D = 512 (no main path): FMA on the CUDA
//    cores, register-tiled: a warp owns 4 query rows, so its q and P reads
//    are broadcasts, and each lane keeps 4 x D/32 outputs in registers.  q,
//    one k|v tile and P live in dynamic shared memory.
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

// The stream of query tile x (this block's: blockIdx.x).  Unrolled over the
// table with constant indices, so the table is read from the parameter bank
// and never copied to local memory.
__device__ __forceinline__ QTile find_tile(const QStreams& t, int bq,
                                           int x = static_cast<int>(blockIdx.x)) {
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
// bf16 wgmma kernel, a block a query tile: D = 64 or 160
// ---------------------------------------------------------------------------

// Head columns of one 128-byte swizzled row in shared memory.  A head of
// width D is held as NC = ceil(D / 64) chunks of 64 columns; the tensor map's
// inner extent is the true D, so TMA fills the columns past D with zeros and
// they add nothing to q k^T; P v computes NC x 64 output columns and the
// store writes the first D.
constexpr int kChunk = 64;

// The shape of one instantiation: NWG consumer warpgroups of 64 query rows,
// head width D.
template <int NWG, int D>
struct FlashShape {
  static constexpr int NC = (D + kChunk - 1) / kChunk;  // 64-column chunks
  static constexpr int KS = (D + 15) / 16;              // 16-column k-steps of q k^T
  static constexpr int BQ = 64 * NWG;                   // query rows a block
  // kv rows a tile: 128 only where one chunk leaves registers for the
  // 64 x 128 logits beside O
  static constexpr int BK = (NWG == 2 && NC == 1) ? 128 : 64;
  static constexpr int STAGES = NC == 3 ? 3 : 4;        // k/v tiles in flight
  static constexpr int Q_CHUNK = BQ * kChunk * 2;       // bytes of a q chunk
  static constexpr int KV_CHUNK = BK * kChunk * 2;      // bytes of a k or v chunk
  static constexpr int KV_TILE = NC * KV_CHUNK;         // bytes of a k or v tile
  // 1024 bytes of slack to align the tiles; q, the k and v ring, barriers
  static constexpr int SMEM = 1024 + NC * Q_CHUNK + 2 * STAGES * KV_TILE + (1 + 3 * STAGES) * 8;
  // two blocks an SM where their registers fit (64-row tiles, one chunk)
  static constexpr int MIN_BLOCKS = (NWG == 1 && NC == 1) ? 2 : 1;
  static_assert(D % 8 == 0 && D <= 3 * kChunk, "head width");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct FlashParams {
  CUtensorMap tq[kMaxStreams];  // each stream's q, box (64, BQ, 1, 1)
  CUtensorMap tk, tv;           // box (64, BK, 1, 1)
  QStreams streams;
  int H, Sk;
  float scale_log2;
};

// NWG consumer warpgroups of 64 query rows each, then one producer
// warpgroup.  The 64-row instantiation (short sequences) takes 64-row kv
// tiles and, at one chunk, fits two blocks on an SM.
template <int NWG, int D>
__global__ void __launch_bounds__((NWG + 1) * 128, FlashShape<NWG, D>::MIN_BLOCKS)
flash_wgmma_bf16(const __grid_constant__ FlashParams p) {
  using F = FlashShape<NWG, D>;
  constexpr int NC = F::NC, BQ = F::BQ, BK = F::BK, STAGES = F::STAGES;
  constexpr int kKvTile = BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = smem;                    // NC chunks of (BQ, 64)
  uint8_t* sK = sQ + NC * F::Q_CHUNK;    // STAGES tiles of NC chunks of (BK, 64)
  uint8_t* sV = sK + STAGES * F::KV_TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * F::KV_TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const QTile tile = find_tile(p.streams, BQ);
  const int ntiles = (p.Sk + kKvTile - 1) / kKvTile;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer: q once, then k and v tiles into the ring, a chunk of
    // 64 columns a load ----
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (tid == NWG * 128) {
      const CUtensorMap* tq = &p.tq[0];
#pragma unroll
      for (int i = 1; i < kMaxStreams; ++i)
        if (i == tile.si) tq = &p.tq[i];
      mbar_arrive_expect_tx(q_full, NC * F::Q_CHUNK);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_4d(sQ + c * F::Q_CHUNK, tq, q_full, c * kChunk, tile.q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], F::KV_TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sK + s * F::KV_TILE + c * F::KV_CHUNK, &p.tk, &k_full[s], c * kChunk,
                      j * kKvTile, h, b);
        mbar_arrive_expect_tx(&v_full[s], F::KV_TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(sV + s * F::KV_TILE + c * F::KV_CHUNK, &p.tv, &v_full[s], c * kChunk,
                      j * kKvTile, h, b);
      }
    }
  } else {
    // ---- consumers: S = q k^T, online softmax, O += P v.  S of tile j and
    // P v of tile j - 1 go to the tensor cores as one batch with one wait;
    // a warpgroup's softmax overlaps the other warpgroup's products ----
    if constexpr (NWG == 2) reg_alloc<240>();
    const int wg = tid / 128, wi = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint8_t* q_rows = sQ + wg * 64 * kChunk * 2;

    float o[NC * 32];  // chunk c's 64 columns: o[32 c .. 32 c + 31]
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) o[i] = 0.f;
    float sc[BK / 2];
    uint32_t pf[kKvTile / 16][4];  // P of the last softmax, bf16 A fragments
    // rows g and g + 8 of this warp's 16: running max and (thread-partial) sum
    float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
    float c0 = 1.f, c1 = 1.f;  // the last softmax's rescale of O

    // S = q k_j^T into sc, issued (not waited for): the k-steps that hold a
    // column below D (past D both operands are zero)
    auto issue_s = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(&k_full[s], (j / STAGES) & 1);
      const uint8_t* tK = sK + s * F::KV_TILE;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::KS; ++kk) {
        const int c = kk / 4, col = 32 * (kk % 4);
        const uint64_t da = desc_sw128(q_rows + c * F::Q_CHUNK + col, 16, 1024);
        const uint64_t db = desc_sw128(tK + c * F::KV_CHUNK + col, 16, 1024);
        if constexpr (BK == 128) wgmma_ss_m64n128k16(sc, da, db, kk > 0);
        else wgmma_ss_m64n64k16(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P_j v_j, issued (not waited for): one m64n64 product a chunk
    auto issue_pv = [&](int j) {
      const int s = j % STAGES;
      mbar_wait(&v_full[s], (j / STAGES) & 1);
      const uint8_t* tV = sV + s * F::KV_TILE;
#pragma unroll
      for (int i = 0; i < NC * 32; ++i) fence_operand(o[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs_m64n64k16<1>(o + 32 * c, pf[kk],
                                desc_sw128(tV + c * F::KV_CHUNK + kk * 16 * kChunk * 2,
                                           F::KV_CHUNK, 1024));
      }
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
      for (int n = 0; n < NC * kChunk / 8; ++n) {
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
      for (int i = 0; i < NC * 32; ++i) fence_operand(o[i]);
      mbar_arrive(&empty[(j - 1) % STAGES]);
      softmax(j);
      rescale_o();
    }
    turn_begin();
    issue_pv(ntiles - 1);
    turn_end(true);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NC * 32; ++i) fence_operand(o[i]);
    mbar_arrive(&empty[(ntiles - 1) % STAGES]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const Strides os = tile.os;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(tile.o) + b * os.b + h * os.h;
    const int row0 = tile.q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
#pragma unroll
    for (int n = 0; n < NC * kChunk / 8; ++n) {
      const int col = n * 8 + t * 2;  // D is a multiple of 8: col + 1 < D too
      if (col >= D) continue;
      if (row0 < tile.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * os.s + col) =
            __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (row1 < tile.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * os.s + col) =
            __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// a (B, S, H, D) bf16 view with element strides st: 4-D tensor map of inner
// extent D, box (64, rows, 1, 1), 128-byte swizzle; a box past D or past the
// sequence loads zeros there
bool head_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, Strides st,
              int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(st.s) * 2, static_cast<uint64_t>(st.h) * 2,
                               static_cast<uint64_t>(st.b) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(kChunk), static_cast<uint32_t>(rows), 1, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NWG, int D>
cudaError_t launch_flash(const FlashParams& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = FlashShape<NWG, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_bf16<NWG, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_bf16<NWG, D><<<grid, (NWG + 1) * 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// The 128-row tile (two consumer warpgroups) unless its grid leaves SMs
// idle or the head takes three chunks, then the 64-row one (one consumer
// warpgroup); kv tile rows and stages as FlashShape sets them for D
// (ops/flash_attention.py:bf16_plan repeats the rule).  Returns the
// cudaError_t of the launch.
template <int D>
cudaError_t launch_wgmma(QStreams streams, const void* k, const void* v, int B, int H, int Sk,
                         Strides ks, Strides vs, float scale_log2, cudaStream_t stream) {
  int tiles128 = 0;
  for (int i = 0; i < streams.n; ++i) tiles128 += (streams.sq[i] + 127) / 128;
  // three chunks take the 64-row tile always: with two consumer warpgroups
  // the 96 accumulators a thread exceed the 168 registers ptxas gives a
  // 384-thread block, and it spilled and serialised every wgmma (C7512)
  const bool wide = FlashShape<2, D>::NC < 3 && static_cast<long long>(tiles128) * B * H >= kSms;
  const int bq = wide ? 128 : 64;
  const int bk = wide ? FlashShape<2, D>::BK : FlashShape<1, D>::BK;
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + bq - 1) / bq;
  FlashParams p{};
  p.streams = streams;
  p.H = H;
  p.Sk = Sk;
  p.scale_log2 = scale_log2;
  bool ok = head_map(&p.tk, k, B, Sk, H, D, ks, bk) && head_map(&p.tv, v, B, Sk, H, D, vs, bk);
  for (int i = 0; i < streams.n; ++i)
    ok = ok && head_map(&p.tq[i], streams.q[i], B, streams.sq[i], H, D, streams.qs[i], bq);
  if (!ok) return cudaErrorNotSupported;
  const dim3 grid(streams.tile0[streams.n], B * H);
  if constexpr (FlashShape<2, D>::NC < 3) {
    if (wide) return launch_flash<2, D>(p, grid, stream);
  }
  return launch_flash<1, D>(p, grid, stream);
}

// ---------------------------------------------------------------------------
// bf16 wgmma kernel at SD-1.5's head widths D = 40 and 80: persistent
// ---------------------------------------------------------------------------

// Where the SFU bounds the kernel, one 8-column group of logits in
// kFmaExpEvery takes its exponentials on the FMA pipe (exp2_fma).
constexpr int kFmaExpEvery = 8;

// The shape of one instantiation: NWG consumer warpgroups of 64 query rows;
// the head held in shared memory as NC chunks of 64 columns (the columns past
// D load as zeros, as above) but P v computed at N = D, its MN-major B
// descriptor stepping from one chunk's swizzle atom to the next (LBO).
template <int NWG, int D>
struct PersistShape {
  static constexpr int NC = (D + kChunk - 1) / kChunk;
  static constexpr int KS = (D + 15) / 16;       // 16-column k-steps of q k^T
  static constexpr int BQ = 64 * NWG;            // query rows a tile
  static constexpr int BK = 64 * NWG;            // kv rows a tile
  // tensor-core flops a logit takes (q k^T over the k-steps, P v at N = D,
  // the row sum at N = 8) against the 256 that one SFU exponential costs in
  // time: fewer (D = 40: 192), and the SFU bounds the softmax, so some
  // exponentials go to the FMA pipe; more (D = 80: 352), and the SFU has
  // room
  static constexpr bool FMA_EXP = 2 * (16 * KS + D + 8) < 256;
  static constexpr int Q_CHUNK = BQ * kChunk * 2;
  static constexpr int Q_TILE = NC * Q_CHUNK;
  static constexpr int KV_CHUNK = BK * kChunk * 2;
  static constexpr int KV_TILE = NC * KV_CHUNK;
  // two blocks an SM at one warpgroup and one chunk (their registers fit)
  static constexpr int MIN_BLOCKS = (NWG == 1 && NC == 1) ? 2 : 1;
  // shared memory a block may take: the SM's 228 KB less 1 KB a block
  static constexpr int LIMIT = MIN_BLOCKS == 2 ? 115712 : 232448;
  // 1024 bytes of slack to align the tiles; q buffers, the k and v ring,
  // the ones of the row sums (16 x 8 bf16), barriers (q full and empty, then
  // k full, v full and empty a stage)
  static constexpr int bytes(int qbufs, int stages) {
    return 1024 + qbufs * Q_TILE + 2 * stages * KV_TILE + 256 + (4 + 3 * stages) * 8;
  }
  // four kv stages where they fit, else three (D = 80 at 128 rows); then a
  // second q buffer (the next unit's q loads under this one) where that
  // fits too
  static constexpr int STAGES = bytes(1, 4) <= LIMIT ? 4 : 3;
  static constexpr int Q_BUFS = bytes(2, STAGES) <= LIMIT ? 2 : 1;
  static constexpr int SMEM = bytes(Q_BUFS, STAGES);
  static_assert(D == 40 || D == 80, "head width");
  static_assert(SMEM <= LIMIT, "shared memory of one block");
};

// a compile-time flag for generic lambdas
template <bool kValue>
struct BoolC {
  static constexpr bool value = kValue;
};

struct PersistParams {
  CUtensorMap tq[kMaxStreams];  // each stream's q, box (64, BQ, 1, 1)
  CUtensorMap tk, tv;           // box (64, BK, 1, 1)
  QStreams streams;
  int H, Sk;
  int units;  // work units: B x H x the query tiles of all streams in runs of CL
  float scale_log2;
};

// d (64 x D, f32) += P (64 x 16, registers) v (16 x D, smem, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t desc_b) {
  if constexpr (D == 40) wgmma_rs_m64n40k16<1>(d, a, desc_b);
  else wgmma_rs_m64n80k16<1>(d, a, desc_b);
}

// One block per SM (two at one warpgroup and one chunk) walks work items
// blockIdx.x, blockIdx.x + gridDim.x, ...: an item is one query tile of one
// (batch, head), items of one head adjacent so that the blocks at work read
// the same k and v from L2.  NWG consumer warpgroups, then one producer
// warpgroup whose first thread keeps q tiles and the k/v ring filled by TMA
// across items: the next item's q and first kv tiles load while this one
// runs, so a short kv loop does not pay its start-up and drain alone.
template <int NWG, int D, int CL>
__global__ void __launch_bounds__((NWG + 1) * 128, PersistShape<NWG, D>::MIN_BLOCKS)
flash_wgmma_persistent(const __grid_constant__ PersistParams p) {
  using F = PersistShape<NWG, D>;
  constexpr int NC = F::NC, BQ = F::BQ, BK = F::BK, STAGES = F::STAGES, QB = F::Q_BUFS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                    // QB tiles of NC chunks of (BQ, 64)
  uint8_t* sK = sQ + QB * F::Q_TILE;     // STAGES tiles of NC chunks of (BK, 64)
  uint8_t* sV = sK + STAGES * F::KV_TILE;
  uint8_t* sOnes = sV + STAGES * F::KV_TILE;  // B of the row sums: 16 x 8 ones
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sOnes + 256);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x;
  const int qtiles = p.streams.tile0[p.streams.n];  // query tiles of one (b, h)
  const int runs = (qtiles + CL - 1) / CL;           // work units of one (b, h)
  const int ntiles = (p.Sk + BK - 1) / BK;
  // the block's rank in its cluster: its query tile of each unit
  const int rank = CL > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int unit0 = static_cast<int>(blockIdx.x) / CL, units_step = gridDim.x / CL;
  // unit -> (b, h) and this block's query tile (past the streams' last tile:
  // rows past the sequence, loaded as zeros and not stored)
  auto unit_tile = [&](int unit, int* b, int* h) {
    const int bh = unit / runs;
    *b = bh / p.H;
    *h = bh % p.H;
    return find_tile(p.streams, BQ, (unit % runs) * CL + rank);
  };

  if (tid == 0) {
    for (int i = 0; i < QB; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], NWG * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      // a stage is free once every consumer warp of the cluster is done with it
      mbar_init(&empty[s], CL * NWG * 4);
    }
    fence_barrier_init();
  }
  if (tid < 64) {
    reinterpret_cast<uint32_t*>(sOnes)[tid] = 0x3F803F80u;  // two bf16 ones
    fence_proxy_async();  // visible to wgmma
  }
  // the other block's barriers are initialised before any multicast or
  // remote arrival reaches them
  if constexpr (CL > 1) cluster_sync();
  else __syncthreads();

  if (tid >= NWG * 128) {
    // ---- producer: per item its q tile into a q buffer, then its k and v
    // tiles into the ring (u counts the tiles across items), a chunk of 64
    // columns a load ----
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (tid == NWG * 128) {
      int u = 0;
      for (int it = 0, unit = unit0; unit < p.units; ++it, unit += units_step) {
        int b, h;
        const QTile tile = unit_tile(unit, &b, &h);
        const CUtensorMap* tq = &p.tq[0];
#pragma unroll
        for (int i = 1; i < kMaxStreams; ++i)
          if (i == tile.si) tq = &p.tq[i];
        const int qb = it % QB;
        uint8_t* dq = sQ + qb * F::Q_TILE;
        mbar_wait(&q_empty[qb], ((it / QB) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], F::Q_TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(dq + c * F::Q_CHUNK, tq, &q_full[qb], c * kChunk, tile.q0, h, b);
        for (int j = 0; j < ntiles; ++j, ++u) {
          const int s = u % STAGES;
          mbar_wait(&empty[s], ((u / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&k_full[s], F::KV_TILE);
          mbar_arrive_expect_tx(&v_full[s], F::KV_TILE);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            uint8_t* dk = sK + s * F::KV_TILE + c * F::KV_CHUNK;
            uint8_t* dv = sV + s * F::KV_TILE + c * F::KV_CHUNK;
            if constexpr (CL == 1) {
              tma_load_4d(dk, &p.tk, &k_full[s], c * kChunk, j * BK, h, b);
              tma_load_4d(dv, &p.tv, &v_full[s], c * kChunk, j * BK, h, b);
            } else if (rank == 0) {  // k for both blocks of the pair
              tma_load_4d_multicast(dk, &p.tk, &k_full[s], c * kChunk, j * BK, h, b, 0x3);
            } else {  // v for both
              tma_load_4d_multicast(dv, &p.tv, &v_full[s], c * kChunk, j * BK, h, b, 0x3);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers.  Per kv tile j: S_j = q k_j^T and O += P_{j-1} v_{j-1}
    // issued as two groups; the softmax of S_j runs once S_j is done, under
    // P_{j-1} v_{j-1} (and, with two warpgroups, under the other's
    // products); then O takes the rescale and P_j its registers ----
    if constexpr (NWG == 2) reg_alloc<240>();
    const int wg = tid / 128, wi = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const float sl = p.scale_log2;
    // the row sums' B: every element 1, any layout (two core matrices along K)
    const uint64_t d_ones = desc_plain(sOnes, 128, 128);

    float o[D / 2];  // O (64 x D) of this warpgroup's rows
    // the row sums of P as the tensor cores add them: P (64 x 16) times ones
    // (16 x 8), each column the same sum; rows g (lsum[0]) and g + 8 (lsum[2])
    float lsum[4];
    float sc[BK / 2];
    uint32_t pf[BK / 16][4];  // P of the last softmax, bf16 A fragments
    float m0, m1;             // rows g and g + 8 of this warp's 16: running max
    float c0 = 1.f, c1 = 1.f;  // the last softmax's rescale of O

    // S = q k_u^T into sc, issued (not waited for): the k-steps that hold a
    // column below D (past D both operands are zero)
    auto issue_s = [&](int u, const uint8_t* q_rows) {
      const int s = u % STAGES;
      mbar_wait(&k_full[s], (u / STAGES) & 1);
      const uint8_t* tK = sK + s * F::KV_TILE;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::KS; ++kk) {
        const int c = kk / 4, col = 32 * (kk % 4);
        const uint64_t da = desc_sw128(q_rows + c * F::Q_CHUNK + col, 16, 1024);
        const uint64_t db = desc_sw128(tK + c * F::KV_CHUNK + col, 16, 1024);
        if constexpr (BK == 128) wgmma_ss_m64n128k16(sc, da, db, kk > 0);
        else wgmma_ss_m64n64k16(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P v_u and the row sums += P ones, issued (not waited for): N = D,
    // one product a k16 slice
    auto issue_pv = [&](int u) {
      const int s = u % STAGES;
      mbar_wait(&v_full[s], (u / STAGES) & 1);
      const uint8_t* tV = sV + s * F::KV_TILE;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_operand(lsum[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_pv<D>(o, pf[kk], desc_sw128(tV + kk * 16 * kChunk * 2, F::KV_CHUNK, 1024));
        wgmma_rs_m64n8k16<0>(lsum, pf[kk], d_ones);
      }
      wgmma_commit();
    };
    // the online softmax of the logits in sc (keys kv0 ..), in place: the
    // rescale c0, c1 that O and the sums need, and P in f32
    auto softmax = [&](int kv0, auto masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_operand(sc[i]);
      // sc[4n + e]: row g (e < 2) or g + 8, kv column 8n + 2t + (e & 1); the
      // logits stay unscaled (the scale rides the exponent's FMA).  Only an
      // item's last tile is masked, by selects: no branch while P v is in
      // flight
      if constexpr (decltype(masked)::value) {
        const int lim = p.Sk - kv0;  // columns of this tile below Sk
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool out = n * 8 + t * 2 + e >= lim;
            sc[4 * n + e] = out ? kNegBig : sc[4 * n + e];
            sc[4 * n + 2 + e] = out ? kNegBig : sc[4 * n + 2 + e];
          }
        }
      }
      float r0 = kNegBig, r1 = kNegBig;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        r0 = fmaxf(r0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        r1 = fmaxf(r1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
      // running maxima in the scaled (base-2) units
      const float mn0 = fmaxf(m0, r0 * sl), mn1 = fmaxf(m1, r1 * sl);
      c0 = exp2_ftz(m0 - mn0);
      c1 = exp2_ftz(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = fmaf(sc[4 * n + i], sl, i < 2 ? -mn0 : -mn1);
          const bool fma = F::FMA_EXP && n % kFmaExpEvery == kFmaExpEvery - 1;
          sc[4 * n + i] = fma ? exp2_fma(x) : exp2_ftz(x);
        }
      }
    };
    // P rounded to bf16 once into the A fragments of P v (the P v product and
    // the row sums take the same values, as the TPU kernel's ones-column
    // did): the accumulator layout of n-tiles 2i, 2i + 1 is the A-fragment
    // layout of k-step i
    auto pack_p = [&]() {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }
      lsum[0] *= c0;
      lsum[1] *= c0;
      lsum[2] *= c1;
      lsum[3] *= c1;
    };
    // tile u's stage is done with in this warp: one arrival on that stage's
    // empty barrier in every block of the cluster (their producers multicast
    // into this block's stage too)
    auto release = [&](int u) {
      if constexpr (CL == 1) {
        mbar_arrive_if(lane == 0, &empty[u % STAGES]);
      } else {
#pragma unroll
        for (int r = 0; r < CL; ++r) mbar_arrive_cluster_if(lane == 0, &empty[u % STAGES], r);
      }
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_operand(lsum[i]);
    };
    // With several consumers their batches of products take turns in order
    // (named barrier 1 + w: warpgroup w's turn), so one warpgroup's softmax
    // runs while the others' products hold the tensor cores.  Each
    // warpgroup issues ntiles + 1 batches an item; the last warpgroup opens
    // warpgroup 0's first turn and passes on all but its last.
    auto turn_begin = [&]() {
      if constexpr (NWG > 1) named_bar_sync(1 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NWG > 1) {
        if (!(last && wg == NWG - 1)) named_bar_arrive(1 + (wg + 1) % NWG, 256);
      }
    };
    if constexpr (NWG > 1) {
      if (wg == NWG - 1) named_bar_arrive(1, 256);
    }
    // kv tile j > 0 of an item whose tiles start at u0: S_j and P_{j-1}
    // v_{j-1} in one turn, as two groups; the softmax of S_j under P_{j-1}
    // v_{j-1}; then the stage of tile j - 1 goes back to the producer, O and
    // the sums take the rescale and P_j its registers
    auto step = [&](int u0, int j, const uint8_t* q_rows, auto masked) {
      turn_begin();
      issue_s(u0 + j, q_rows);
      issue_pv(u0 + j - 1);
      turn_end(false);
      wgmma_wait<1>();
      softmax(j * BK, masked);
      wgmma_wait<0>();
      fence_o();
      release(u0 + j - 1);
      rescale();
      pack_p();
    };
    int u = 0;  // kv tiles consumed, across units
    for (int it = 0, unit = unit0; unit < p.units; ++it, unit += units_step) {
      const bool last_item = unit + units_step >= p.units;
      const int qb = it % QB;
      const uint8_t* q_rows = sQ + qb * F::Q_TILE + wg * 64 * kChunk * 2;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) lsum[i] = 0.f;
      m0 = m1 = kNegBig;
      mbar_wait(&q_full[qb], (it / QB) & 1);
      turn_begin();
      issue_s(u, q_rows);
      turn_end(false);
      wgmma_wait<0>();
      if (ntiles == 1) softmax(0, BoolC<true>());
      else softmax(0, BoolC<false>());
      pack_p();
      for (int j = 1; j + 1 < ntiles; ++j) step(u, j, q_rows, BoolC<false>());
      if (ntiles > 1) step(u, ntiles - 1, q_rows, BoolC<true>());
      turn_begin();
      issue_pv(u + ntiles - 1);
      turn_end(last_item);
      wgmma_wait<0>();
      fence_o();
      release(u + ntiles - 1);
      mbar_arrive(&q_empty[qb]);
      u += ntiles;

      const float inv0 = 1.f / lsum[0], inv1 = 1.f / lsum[2];
      int b, h;
      const QTile tile = unit_tile(unit, &b, &h);
      const Strides os = tile.os;
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(tile.o) + b * os.b + h * os.h;
      const int row0 = tile.q0 + wg * 64 + wi * 16 + g, row1 = row0 + 8;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
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
  // no block exits while the other may still arrive on its barriers
  if constexpr (CL > 1) cluster_sync();
}

// Clusters of CL blocks of the instantiation (blocks, at CL == 1) that the
// card holds at once, as the runtime reckons it.  Returns the cudaError_t.
template <int NWG, int D, int CL>
cudaError_t persistent_fit(int* fit) {
  auto kernel = flash_wgmma_persistent<NWG, D, CL>;
  constexpr int smem = PersistShape<NWG, D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if constexpr (CL == 1) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, (NWG + 1) * 128, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *fit = per_sm * sms;
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PersistShape<NWG, D>::MIN_BLOCKS * kSms);
  cfg.blockDim = dim3((NWG + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
}

// Launches the instantiation: CL == 1 as a plain grid of per_sm blocks an SM
// at most; CL > 1 in clusters, as many as fit on the card at once (both
// blocks of a cluster in one GPC); either way no more than the work units.
// Returns the cudaError_t of the launch.
template <int NWG, int D, int CL>
cudaError_t launch_persistent(const PersistParams& p, cudaStream_t stream) {
  auto kernel = flash_wgmma_persistent<NWG, D, CL>;
  constexpr int smem = PersistShape<NWG, D>::SMEM;
  constexpr int slots = PersistShape<NWG, D>::MIN_BLOCKS * kSms / CL;  // clusters at most
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if constexpr (CL == 1) {
    kernel<<<p.units < slots ? p.units : slots, (NWG + 1) * 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  static int fit = 0;  // a property of the kernel and the card: asked once
  if (fit == 0) {
    err = persistent_fit<NWG, D, CL>(&fit);
    if (err != cudaSuccess) return err;
    fit = fit < slots ? fit : slots;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.units < fit ? p.units : fit) * CL);
  cfg.blockDim = dim3((NWG + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// SD-1.5's widths: two consumer warpgroups (128-row query and kv tiles)
// where 128-row tiles leave at most half the SMs without one, else one
// (64-row tiles).  At D = 40 with two warpgroups, clusters of two blocks
// over adjacent query tiles of one head: one multicasts each k tile to
// both, the other each v tile, which halves what the head's query tiles
// stream through L2 and TMA, the bound of this width (at D = 80 a kv byte
// feeds twice the products, and the pairing's lockstep costs more than the
// streaming it saves).  ops/flash_attention.py:bf16_plan repeats the rule.
// Returns the cudaError_t of the launch.
template <int D>
cudaError_t launch_persistent_plan(QStreams streams, const void* k, const void* v, int B, int H,
                                   int Sk, Strides ks, Strides vs, float scale_log2,
                                   cudaStream_t stream) {
  int tiles128 = 0;
  for (int i = 0; i < streams.n; ++i) tiles128 += (streams.sq[i] + 127) / 128;
  const bool wide = 2LL * tiles128 * B * H >= kSms;
  const int bq = wide ? 128 : 64;
  const int cl = wide && D == 40 ? 2 : 1;
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + bq - 1) / bq;
  PersistParams p{};
  p.streams = streams;
  p.H = H;
  p.Sk = Sk;
  p.units = (streams.tile0[streams.n] + cl - 1) / cl * B * H;
  p.scale_log2 = scale_log2;
  bool ok = head_map(&p.tk, k, B, Sk, H, D, ks, bq) && head_map(&p.tv, v, B, Sk, H, D, vs, bq);
  for (int i = 0; i < streams.n; ++i)
    ok = ok && head_map(&p.tq[i], streams.q[i], B, streams.sq[i], H, D, streams.qs[i], bq);
  if (!ok) return cudaErrorNotSupported;
  if (!wide) return launch_persistent<1, D, 1>(p, stream);
  if constexpr (D == 40) return launch_persistent<2, D, 2>(p, stream);
  else return launch_persistent<2, D, 1>(p, stream);
}

// ---------------------------------------------------------------------------
// FMA kernel (f32 at D = 64, bf16 at D = 512)
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

// ---------------------------------------------------------------------------
// f32 D = 512 kernel: 3xTF32 on wgmma (the VAE's single head)
// ---------------------------------------------------------------------------

constexpr int kWideD = 512;
constexpr int kTfRows = 64;     // query rows a block; kv rows a tile
constexpr int kTfCols = 32;     // f32 columns of one 128-byte smem row
constexpr int kTfUnit = kTfRows * kTfCols * 4;  // 8 KB: one 64 x 32 f32 tile
constexpr int kTfStages = 5;    // hi + lo tile pairs in flight a warpgroup
constexpr int kTfHalf = kWideD / 2;  // output columns of one warpgroup
// kv tiles one block accumulates at most (2048 keys): the tensor cores'
// f32 accumulation drifts with the length of the chain of P v products (one
// block over 16384 keys missed the f32 tolerance on the H100; 2048 keys
// hold it), so longer key ranges are split and merged by the combine pass
// in f32
constexpr int kTfMaxTilesPerSplit = 32;

// The split operands: hi = tf32(x), lo = tf32(x - hi), each an f32 plane of
// the workspace (ops/flash_attention.py:wide_f32_plan sizes it).
//  q: [bh][R][512], the streams' rows padded to 64 each and stacked (R rows);
//  k: [bh][Skp][512], Skp = Sk padded to 64;
//  v: [bh][512][Skp], transposed (K-major for the B operand of P v)
// Rows past a stream's end and keys past Sk are zeros.
struct TfLayout {
  int BH, R, Skp, splits, tiles_per_split;
  long long q_plane, k_plane, v_plane, o_part, ml_part;  // element offsets
  long long total;                                      // elements of the workspace
};

// splits > 1: the partial O (unnormalised) of each split at o_part
// ([split][bh][R][512]) and its running max and sum at ml_part
// ([split][bh][R][2]); a combine pass merges them
inline TfLayout tf_layout(int BH, int R, int Sk, int splits) {
  TfLayout l{};
  l.BH = BH;
  l.R = R;
  l.Skp = (Sk + kTfRows - 1) / kTfRows * kTfRows;
  const int ntiles = l.Skp / kTfRows;
  l.splits = splits;
  l.tiles_per_split = (ntiles + splits - 1) / splits;
  const long long q = static_cast<long long>(BH) * R * kWideD;
  const long long kv = static_cast<long long>(BH) * l.Skp * kWideD;
  l.q_plane = q;
  l.k_plane = kv;
  l.v_plane = kv;
  l.o_part = 2 * q + 4 * kv;
  l.ml_part = l.o_part + (splits > 1 ? splits * q : 0);
  l.total = l.ml_part + (splits > 1 ? static_cast<long long>(splits) * BH * R * 2 : 0);
  return l;
}

struct SplitParams {
  QStreams streams;  // tile0 in 64-row tiles
  const float* k;
  const float* v;
  Strides ks, vs;
  float* ws;
  TfLayout lay;
  int H, Sk;
  int q_blocks, k_blocks;  // block ranges of the q and k rows; v tiles after
};

constexpr int kSplitThreads = 256;

__device__ __forceinline__ void split_store(float* hi, float* lo, float4 x) {
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) =
      make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                  tf32_rna(x.w - h.w));
}

// The pre-pass: q and k split row by row (16 rows a block, 4 rows x 8
// columns a thread, all loads in flight before the stores), v split and
// transposed in 64-key x 32-column tiles through shared memory.  Reads each
// input once and writes each plane once.
__global__ void __launch_bounds__(kSplitThreads)
flash_split_tf32(const __grid_constant__ SplitParams p) {
  const TfLayout& L = p.lay;
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < p.q_blocks + p.k_blocks) {
    const bool is_q = blk < p.q_blocks;
    if (!is_q) blk -= p.q_blocks;
    const int rows = is_q ? L.R : L.Skp;
    const int c = (tid % 64) * 8;
    const long long plane = is_q ? L.q_plane : L.k_plane;
    // 16 rows a block, 4 a thread: all 8 loads in flight before the stores
    float4 xs[4][2];
    long long flats[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long flat = static_cast<long long>(blk) * 16 + tid / 64 + 4 * i;
      flats[i] = flat;
      const int bh = static_cast<int>(flat / rows), r = static_cast<int>(flat % rows);
      const int b = bh / p.H, h = bh % p.H;
      const float* src = nullptr;
      if (is_q) {
        const QTile tile = find_tile(p.streams, kTfRows, r / kTfRows);
        const int row = tile.q0 + r % kTfRows;
        if (row < tile.sq)
          src = static_cast<const float*>(tile.q) + b * tile.qs.b + h * tile.qs.h +
                static_cast<long long>(row) * tile.qs.s;
      } else if (r < p.Sk) {
        src = p.k + b * p.ks.b + h * p.ks.h + static_cast<long long>(r) * p.ks.s;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        xs[i][e] = src ? *reinterpret_cast<const float4*>(src + c + 4 * e)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* hi = p.ws + (is_q ? 0 : 2 * L.q_plane) + flats[i] * kWideD + c;
#pragma unroll
      for (int e = 0; e < 2; ++e) split_store(hi + 4 * e, hi + plane + 4 * e, xs[i][e]);
    }
    return;
  }
  // v: tile (bh, 64 keys, 32 columns) -> vt[bh][d][slot]
  __shared__ float tile[kTfRows][kTfCols + 1];
  blk -= p.q_blocks + p.k_blocks;
  constexpr int kColTiles = kWideD / kTfCols;
  const int ktiles = L.Skp / kTfRows;
  const int bh = blk / (ktiles * kColTiles);
  const int kt = (blk / kColTiles) % ktiles, ct = blk % kColTiles;
  const int b = bh / p.H, h = bh % p.H;
  const float* vb = p.v + b * p.vs.b + h * p.vs.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = tid / 8 + 32 * i, c = (tid % 8) * 4;
    const int key = kt * kTfRows + r;
    const float4 x = key < p.Sk ? *reinterpret_cast<const float4*>(
                                      vb + static_cast<long long>(key) * p.vs.s + ct * kTfCols + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z;
    tile[r][c + 3] = x.w;
  }
  __syncthreads();
  // thread: column d = tid / 8 of the tile, keys 8 grp .. 8 grp + 7
  const int d = tid / 8, grp = tid % 8;
  float x[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = tile[grp * 8 + u][d];
  float* hi = p.ws + 2 * L.q_plane + 2 * L.k_plane +
              (static_cast<long long>(bh) * kWideD + ct * kTfCols + d) * L.Skp + kt * kTfRows +
              grp * 8;
  split_store(hi, hi + L.v_plane, make_float4(x[0], x[1], x[2], x[3]));
  split_store(hi + 4, hi + L.v_plane + 4, make_float4(x[4], x[5], x[6], x[7]));
}

struct TfParams {
  CUtensorMap qh, ql, kh, kl, vh, vl;  // 2-D maps of the planes, box (32, 64)
  QStreams streams;                    // tile0 in 64-row tiles
  TfLayout lay;
  float* ws;
  int H, Sk;
  float scale_log2;
};

constexpr int tf_smem_bytes() {
  // 1024 bytes of slack to align the tiles; two rings of hi + lo tile pairs,
  // the S exchange (32 f32 a thread of each warpgroup), P (hi + lo, two
  // 32-key tiles), the ring barriers
  return 1024 + 2 * kTfStages * 2 * kTfUnit + 2 * 32 * 128 * 4 + 2 * 2 * kTfUnit +
         2 * kTfStages * 8;
}

// Units: the hi + lo tile pairs a warpgroup's ring carries, in the order its
// products take them.  Per kv tile, 24: for S, 8 column chunks of (q, k);
// then 8 tiles of v^T (4 blocks of 64 columns x 2 halves of 32 keys).
constexpr int kTfUnitsPerTile = 24;

// One warpgroup's part of the block: W, its half of the output columns, is
// a constant, so that every operand of its TMA loads is uniform across the
// warp.  (Operands the compiler cannot prove uniform go through a loop over
// the warp's distinct values before each TMA instruction; ptxas then
// serialises every wgmma of the warpgroup around that divergent code.)
template <int W>
__device__ __forceinline__ void tf_warpgroup(const TfParams& p, uint8_t* smem) {
  uint8_t* ring = smem;                                  // [wg][stage][hi | lo]
  uint8_t* sp = ring + 2 * kTfStages * 2 * kTfUnit;      // P: [key half][hi | lo]
  float* xbuf = reinterpret_cast<float*>(sp + 2 * 2 * kTfUnit);  // [wg][32][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + 2 * 32 * 128);  // [wg][stage]

  const TfLayout& L = p.lay;
  const int tid = threadIdx.x;
  const int x = blockIdx.x, split = blockIdx.y, bh = blockIdx.z;
  const int ntiles = L.Skp / kTfRows;
  const int j0 = split * L.tiles_per_split;
  const int j1 = min(ntiles, j0 + L.tiles_per_split);
  constexpr int w = W;
  const int lt = tid % 128, wi = lt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* base = ring + w * kTfStages * 2 * kTfUnit;
  uint64_t* wfull = full + w * kTfStages;
  const int units = (j1 - j0) * kTfUnitsPerTile;

  // unit uu of this warpgroup's sequence into its stage, by thread 0 of the
  // warpgroup through predicated instructions (the other threads compute
  // the same addresses: no divergent branch inside the wgmma pipeline)
  const int qrow = bh * L.R + x * kTfRows;
  auto load = [&](int uu) {
    if (uu >= units) return;  // uniform across the warpgroup
    const int j = j0 + uu / kTfUnitsPerTile, r = uu % kTfUnitsPerTile;
    const CUtensorMap *mh, *ml;
    int c0, c1;
    if (r < 16) {
      c0 = w * kTfHalf + (r / 2) * kTfCols;
      c1 = (r & 1) ? bh * L.Skp + j * kTfRows : qrow;
      mh = (r & 1) ? &p.kh : &p.qh;
      ml = (r & 1) ? &p.kl : &p.ql;
    } else {
      c0 = j * kTfRows + (r & 1) * kTfCols;
      c1 = bh * kWideD + w * kTfHalf + ((r - 16) / 2) * 64;
      mh = &p.vh;
      ml = &p.vl;
    }
    const int s = uu % kTfStages;
    uint8_t* dst = base + s * 2 * kTfUnit;
    mbar_arrive_expect_tx_if(lt == 0, &wfull[s], 2 * kTfUnit);
    tma_load_2d_if(lt == 0, dst, mh, &wfull[s], c0, c1);
    tma_load_2d_if(lt == 0, dst + kTfUnit, ml, &wfull[s], c0, c1);
  };

  for (int i = 0; i < kTfStages; ++i) load(i);

  float o[4][32];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
  float sc[32];
  // rows g and g + 8 of this warp's 16: running max (base-2 units) and sum
  float m0 = kNegBig, m1 = kNegBig, l0 = 0.f, l1 = 0.f;
  int u = 0;
  auto stage = [&](int uu) { return base + (uu % kTfStages) * 2 * kTfUnit; };
  auto wait_full = [&](int uu) {
    mbar_wait_bounded(&wfull[uu % kTfStages], (uu / kTfStages) & 1);
  };
  // the products that read unit uu have completed: its stage takes unit
  // uu + kTfStages
  auto release = [&](int uu) { load(uu + kTfStages); };

  for (int j = j0; j < j1; ++j) {
    // S over this warpgroup's 256 columns: per 32-column chunk, k8 slices,
    // the two small terms first.  No non-wgmma access to sc while its
    // products are in flight (ptxas would serialise every wgmma).
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
    for (int c = 0; c < kTfHalf / kTfCols; ++c) {
      wait_full(u);
      wait_full(u + 1);
      const uint64_t dq = desc_sw128(stage(u), 16, 1024);
      const uint64_t dk = desc_sw128(stage(u + 1), 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kTfCols / 8; ++s) {
        // +32 bytes a k8 slice, +kTfUnit for the lo tile (descriptor units of 16 bytes)
        const uint64_t qh = dq + 2 * s, ql = qh + kTfUnit / 16;
        const uint64_t kh = dk + 2 * s, kl = kh + kTfUnit / 16;
        wgmma_ss_m64n64k8_tf32(sc, ql, kh, c > 0 || s > 0);
        wgmma_ss_m64n64k8_tf32(sc, qh, kl, 1);
        wgmma_ss_m64n64k8_tf32(sc, qh, kh, 1);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        release(u - 2);
        release(u - 1);
      }
      u += 2;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
    release(u - 2);
    release(u - 1);

    // S = the two warpgroups' partial sums, the same bits in both (a + b is
    // b + a), so both run the same softmax.  Barrier 2: the other
    // warpgroup has read the last exchange and finished its P v (so P may
    // be written again); barrier 1: this tile's partials are written.
    named_bar_sync(2, 256);
    float* mine = xbuf + w * 32 * 128;
    const float* other = xbuf + (1 - w) * 32 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + lt] = sc[i];
    named_bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] += other[i * 128 + lt];

    // online softmax; sc[4n + e]: row g (e < 2) or g + 8, key 8n + 2t + (e & 1)
    const int kv0 = j * kTfRows;
    if (kv0 + kTfRows > p.Sk) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (kv0 + n * 8 + t * 2 + e >= p.Sk) sc[4 * n + e] = sc[4 * n + 2 + e] = kNegBig;
    }
    float r0 = kNegBig, r1 = kNegBig;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      r0 = fmaxf(r0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      r1 = fmaxf(r1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
    const float mn0 = fmaxf(m0, r0 * p.scale_log2), mn1 = fmaxf(m1, r1 * p.scale_log2);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * n + e] = exp2f(fmaf(sc[4 * n + e], p.scale_log2, e < 2 ? -mn0 : -mn1));
        if (e < 2) ps0 += sc[4 * n + e];
        else ps1 += sc[4 * n + e];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    // this warpgroup's 32 keys of P, split, into the K-major, 128-byte
    // swizzled A tile of its key half: (row r, key k) at r * 128 +
    // ((k / 4) ^ (r % 8)) * 16 + (k % 4) * 4
    uint8_t* ph = sp + w * 2 * kTfUnit;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int nn = 4 * w + n;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wi * 16 + g + 8 * hr;
        const float a = sc[4 * nn + 2 * hr], b = sc[4 * nn + 2 * hr + 1];
        const float ah = tf32_rna(a), bh2 = tf32_rna(b);
        const int off = r * 128 + (((2 * n + (t >> 1)) ^ (r & 7)) << 4) + (t & 1) * 8;
        *reinterpret_cast<float2*>(ph + off) = make_float2(ah, bh2);
        *reinterpret_cast<float2*>(ph + kTfUnit + off) =
            make_float2(tf32_rna(a - ah), tf32_rna(b - bh2));
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[b][4 * n] *= c0;
        o[b][4 * n + 1] *= c0;
        o[b][4 * n + 2] *= c1;
        o[b][4 * n + 3] *= c1;
      }
    fence_proxy_async();  // the P stores, before wgmma reads them
    named_bar_sync(1, 256);  // both halves of P are written

    // O += P v over this warpgroup's 4 blocks of 64 columns, two 32-key
    // halves each, P and v^T from shared memory
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(o[b][i]);
#pragma unroll
    for (int bl = 0; bl < 4; ++bl) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        wait_full(u);
        const uint64_t dv = desc_sw128(stage(u), 16, 1024);
        const uint64_t dp = desc_sw128(sp + hf * 2 * kTfUnit, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t pa = dp + 2 * s, pl = pa + kTfUnit / 16;
          const uint64_t vh = dv + 2 * s, vl = vh + kTfUnit / 16;
          wgmma_ss_m64n64k8_tf32(o[bl], pl, vh, 1);
          wgmma_ss_m64n64k8_tf32(o[bl], pa, vl, 1);
          wgmma_ss_m64n64k8_tf32(o[bl], pa, vh, 1);
        }
        wgmma_commit();
        if (bl > 0 || hf > 0) {
          wgmma_wait<1>();
          release(u - 1);
        }
        ++u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(o[b][i]);
    release(u - 1);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int b = bh / p.H, h = bh % p.H;
  const QTile tile = find_tile(p.streams, kTfRows, x);
  const int row0 = tile.q0 + wi * 16 + g, row1 = row0 + 8;  // this lane's rows
  if (L.splits == 1) {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    float* ob = static_cast<float*>(tile.o) + b * tile.os.b + h * tile.os.h;
#pragma unroll
    for (int bl = 0; bl < 4; ++bl)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = w * kTfHalf + bl * 64 + n * 8 + t * 2;
        if (row0 < tile.sq)
          *reinterpret_cast<float2*>(ob + static_cast<long long>(row0) * tile.os.s + col) =
              make_float2(o[bl][4 * n] * inv0, o[bl][4 * n + 1] * inv0);
        if (row1 < tile.sq)
          *reinterpret_cast<float2*>(ob + static_cast<long long>(row1) * tile.os.s + col) =
              make_float2(o[bl][4 * n + 2] * inv1, o[bl][4 * n + 3] * inv1);
      }
    return;
  }
  // this split's partial: O unnormalised, the running max and sum
  const long long prow = static_cast<long long>(split * L.BH + bh) * L.R + x * kTfRows +
                         wi * 16 + g;
  float* op = p.ws + L.o_part + prow * kWideD;
#pragma unroll
  for (int bl = 0; bl < 4; ++bl)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = w * kTfHalf + bl * 64 + n * 8 + t * 2;
      *reinterpret_cast<float2*>(op + col) = make_float2(o[bl][4 * n], o[bl][4 * n + 1]);
      *reinterpret_cast<float2*>(op + 8 * kWideD + col) =
          make_float2(o[bl][4 * n + 2], o[bl][4 * n + 3]);
    }
  if (w == 0 && t == 0) {
    float* ml = p.ws + L.ml_part + prow * 2;
    *reinterpret_cast<float2*>(ml) = make_float2(m0, l0);
    *reinterpret_cast<float2*>(ml + 16) = make_float2(m1, l1);
  }
}

// Two warpgroups of the same 64 query rows, each owning half of the 512
// output columns (128 f32 accumulators a thread).  No producer warp: the
// accumulators and the 256-thread block keep ptxas's 255-register budget
// for the consumers (a 384-thread block caps them at 168, and setmaxnreg
// does not raise what ptxas allocates).  Thread 0 of each warpgroup loads
// its ring by TMA, refilling a stage as soon as the products that read it
// have completed.  Block (query tile, kv split, b * H + h).
__global__ void __launch_bounds__(256, 1) flash_wgmma_3xtf32(const __grid_constant__ TfParams p) {
  extern __shared__ uint8_t smem_raw[];
  // aligned by an offset from the shared array (not through an integer
  // cast), so that the compiler keeps shared-memory addressing: generic
  // 64-bit addresses of the exchange and P stores cost ~100 registers
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * kTfStages * 2 * kTfUnit +
                                               2 * 2 * kTfUnit + 2 * 32 * 128 * 4);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kTfStages; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128)
    tf_warpgroup<0>(p, smem);
  else
    tf_warpgroup<1>(p, smem);
}

struct CombineParams {
  QStreams streams;  // tile0 in 64-row tiles
  TfLayout lay;
  const float* ws;
  int H;
};

// splits > 1: each output row from its splits' partials, merged in split
// order (no atomics: the same bits every run).  Block (padded row, b * H + h),
// 4 columns a thread.
__global__ void __launch_bounds__(128) flash_combine(const __grid_constant__ CombineParams p) {
  const TfLayout& L = p.lay;
  const int rr = blockIdx.x, bh = blockIdx.y;
  const QTile tile = find_tile(p.streams, kTfRows, rr / kTfRows);
  const int row = tile.q0 + rr % kTfRows;
  if (row >= tile.sq) return;
  const float* ml = p.ws + L.ml_part;
  float mx = kNegBig;
  for (int s = 0; s < L.splits; ++s)
    mx = fmaxf(mx, ml[((static_cast<long long>(s) * L.BH + bh) * L.R + rr) * 2]);
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < L.splits; ++s) {
    const long long prow = (static_cast<long long>(s) * L.BH + bh) * L.R + rr;
    const float wgt = exp2f(ml[prow * 2] - mx);
    den += wgt * ml[prow * 2 + 1];
    const float4 v = *reinterpret_cast<const float4*>(p.ws + L.o_part + prow * kWideD +
                                                      4 * threadIdx.x);
    acc.x = fmaf(wgt, v.x, acc.x);
    acc.y = fmaf(wgt, v.y, acc.y);
    acc.z = fmaf(wgt, v.z, acc.z);
    acc.w = fmaf(wgt, v.w, acc.w);
  }
  const float inv = 1.f / den;
  const int b = bh / p.H, h = bh % p.H;
  float* ob = static_cast<float*>(tile.o) + b * tile.os.b + h * tile.os.h +
              static_cast<long long>(row) * tile.os.s + 4 * threadIdx.x;
  *reinterpret_cast<float4*>(ob) = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// a (rows, cols) f32 plane: 2-D tensor map, box (32, 64), 128-byte swizzle
bool plane_map(CUtensorMap* map, const float* base, long long rows, int cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 4};
  const uint32_t box[2] = {static_cast<uint32_t>(kTfCols), static_cast<uint32_t>(kTfRows)};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// The streams' 64-row tile offsets and the workspace layout of a call;
// false when the splits or the workspace do not fit it
bool tf_prepare(QStreams& streams, int BH, int Sk, long long ws_bytes, int splits,
                TfLayout* L) {
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + kTfRows - 1) / kTfRows;
  if (splits < 1) return false;
  *L = tf_layout(BH, streams.tile0[streams.n] * kTfRows, Sk, splits);
  const int ntiles = L->Skp / kTfRows;
  return splits <= ntiles && L->tiles_per_split <= kTfMaxTilesPerSplit &&
         (ntiles + L->tiles_per_split - 1) / L->tiles_per_split == splits &&
         ws_bytes >= L->total * 4;
}

// The pre-pass: q, k and v split into the workspace's planes.
cudaError_t launch_split(QStreams streams, const float* k, const float* v, int B, int H, int Sk,
                         Strides ks, Strides vs, float* ws, long long ws_bytes, int splits,
                         cudaStream_t stream) {
  SplitParams sp{};
  if (!tf_prepare(streams, B * H, Sk, ws_bytes, splits, &sp.lay)) return cudaErrorInvalidValue;
  const TfLayout& L = sp.lay;
  sp.streams = streams;
  sp.k = k;
  sp.v = v;
  sp.ks = ks;
  sp.vs = vs;
  sp.ws = ws;
  sp.H = H;
  sp.Sk = Sk;
  sp.q_blocks = L.BH * L.R / 16;
  sp.k_blocks = L.BH * L.Skp / 16;
  const int v_blocks = L.BH * (L.Skp / kTfRows) * (kWideD / kTfCols);
  flash_split_tf32<<<sp.q_blocks + sp.k_blocks + v_blocks, kSplitThreads, 0, stream>>>(sp);
  return cudaGetLastError();
}

// The 3xTF32 kernel over the split planes and, with splits > 1, the combine
// pass, on one stream.
cudaError_t launch_wide(QStreams streams, int B, int H, int Sk, float* ws, long long ws_bytes,
                        int splits, cudaStream_t stream) {
  TfParams tp{};
  if (!tf_prepare(streams, B * H, Sk, ws_bytes, splits, &tp.lay)) return cudaErrorInvalidValue;
  const TfLayout& L = tp.lay;
  tp.streams = streams;
  tp.ws = ws;
  tp.H = H;
  tp.Sk = Sk;
  tp.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(kWideD));
  const long long qrows = static_cast<long long>(L.BH) * L.R;
  const long long krows = static_cast<long long>(L.BH) * L.Skp;
  const long long vrows = static_cast<long long>(L.BH) * kWideD;
  const float* kp = ws + 2 * L.q_plane;
  const float* vp = kp + 2 * L.k_plane;
  const bool ok = plane_map(&tp.qh, ws, qrows, kWideD) &&
                  plane_map(&tp.ql, ws + L.q_plane, qrows, kWideD) &&
                  plane_map(&tp.kh, kp, krows, kWideD) &&
                  plane_map(&tp.kl, kp + L.k_plane, krows, kWideD) &&
                  plane_map(&tp.vh, vp, vrows, L.Skp) &&
                  plane_map(&tp.vl, vp + L.v_plane, vrows, L.Skp);
  if (!ok) return cudaErrorNotSupported;
  constexpr int smem = tf_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_3xtf32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_wgmma_3xtf32<<<dim3(streams.tile0[streams.n], splits, L.BH), 256, smem, stream>>>(tp);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  CombineParams cp{};
  cp.streams = streams;
  cp.lay = L;
  cp.ws = ws;
  cp.H = H;
  flash_combine<<<dim3(L.R, L.BH), kWideD / 4, 0, stream>>>(cp);
  return cudaGetLastError();
}

// One launch over every stream of the table: the persistent wgmma kernel for
// bf16 at D = 40 and 80, the per-tile one at D = 64 and 160, else the FMA
// kernel for this (dtype, D) with its tile offsets.  f32 at D = 512 takes
// flash_attention_wide_f32_fwd instead.
// The logit scale is 1/sqrt(D) of the true D.
int launch(QStreams streams, const void* k, const void* v, int B, int H, int Sk, int D,
           int dtype, Strides ks, Strides vs, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if (dtype == 1 && D == 40)
    return static_cast<int>(
        launch_persistent_plan<40>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 1 && D == 64)
    return static_cast<int>(launch_wgmma<64>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 1 && D == 80)
    return static_cast<int>(
        launch_persistent_plan<80>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 1 && D == 160)
    return static_cast<int>(
        launch_wgmma<160>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  streams.tile0[0] = 0;
  for (int i = 0; i < streams.n; ++i)
    streams.tile0[i + 1] = streams.tile0[i] + (streams.sq[i] + kFmaBQ - 1) / kFmaBQ;
  if (dtype == 1 && D == 512)
    return static_cast<int>(
        launch_fma<__nv_bfloat16, 512>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
  if (dtype == 0 && D == 64)
    return static_cast<int>(
        launch_fma<float, 64>(streams, k, v, B, H, Sk, ks, vs, scale_log2, stream));
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

// f32, D = 512: n query streams (1..4) over one k/v.  Arguments as
// flash_attention_multi_q_fwd, plus the workspace (ws_bytes, at least
// ops/flash_attention.py:wide_f32_plan's) and the kv splits of that plan.
// Both entries take the same arguments: flash_split_tf32_fwd writes the
// split planes into the workspace (o is not read), then
// flash_attention_wide_f32_fwd runs the 3xTF32 kernel and the combine pass
// over them into o.
namespace {

QStreams wide_streams(int n, const void* const* q, void* const* o, const int* sq,
                      const long long* q_strides, const long long* o_strides) {
  QStreams streams{};
  streams.n = n;
  for (int i = 0; i < n; ++i) {
    streams.q[i] = q[i];
    streams.o[i] = o[i];
    streams.sq[i] = sq[i];
    streams.qs[i] = Strides{q_strides[3 * i], q_strides[3 * i + 1], q_strides[3 * i + 2]};
    streams.os[i] = Strides{o_strides[3 * i], o_strides[3 * i + 1], o_strides[3 * i + 2]};
  }
  return streams;
}

}  // namespace

extern "C" int flash_split_tf32_fwd(int n, const void* const* q, void* const* o, const int* sq,
                                    const long long* q_strides, const long long* o_strides,
                                    const void* k, const void* v, int B, int H, int Sk,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, void* ws,
                                    long long ws_bytes, int splits, void* stream) {
  if (n < 1 || n > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_split(
      wide_streams(n, q, o, sq, q_strides, o_strides), static_cast<const float*>(k),
      static_cast<const float*>(v), B, H, Sk, Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      static_cast<float*>(ws), ws_bytes, splits, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_wide_f32_fwd(int n, const void* const* q, void* const* o,
                                            const int* sq, const long long* q_strides,
                                            const long long* o_strides, const void* k,
                                            const void* v, int B, int H, int Sk,
                                            long long k_sb, long long k_ss, long long k_sh,
                                            long long v_sb, long long v_ss, long long v_sh,
                                            void* ws, long long ws_bytes, int splits,
                                            void* stream) {
  if (n < 1 || n > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wide(wide_streams(n, q, o, sq, q_strides, o_strides), B, H, Sk,
                                      static_cast<float*>(ws), ws_bytes, splits,
                                      static_cast<cudaStream_t>(stream)));
}

// Blocks of the persistent bf16 kernel (D = 40 or 80) that the card holds
// at once, as the runtime reckons it, for the instantiation that
// launch_persistent_plan takes with nwg consumer warpgroups (its clusters
// times their blocks): what ops/flash_attention.py:bf16_plan assumes is
// held against it.  Returns a cudaError_t.
extern "C" int flash_persistent_fit(int D, int nwg, int* blocks) {
  int fit = 0, cl = 1;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 40 && nwg == 1) err = persistent_fit<1, 40, 1>(&fit);
  if (D == 40 && nwg == 2) {
    err = persistent_fit<2, 40, 2>(&fit);
    cl = 2;
  }
  if (D == 80 && nwg == 1) err = persistent_fit<1, 80, 1>(&fit);
  if (D == 80 && nwg == 2) err = persistent_fit<2, 80, 1>(&fit);
  *blocks = fit * cl;
  return static_cast<int>(err);
}
