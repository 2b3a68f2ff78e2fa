// Flash attention forward for Hopper (sm_90a): online-softmax attention
// with a segment mask, never materialising the S x S score matrix.
//
//   s[i, j] = (q_i . k_j) * sm_scale + (seg_q[i] == seg_kv[j] ? 0 : -0.7 * FLT_MAX)
//   o_i     = sum_j exp(s[i, j] - m_i) v_j / sum_j exp(s[i, j] - m_i)
//
// for every (batch, head).  q, k, v and o are (B, nh, S, hd) with any
// batch, head and row strides (multiples of 16 bytes) and a unit stride
// along hd; hd is 64 or 128; bf16 or fp32; segment ids are (B, S) int32.
// Keys past S (the ragged last tile) do not enter the softmax at all.
//
// Replaces the forward pallas_call of the JAX library kernel that the JAX
// package's models/cxr_bert.py::_self_attention calls with use_flash=True
// (jax.experimental.pallas.ops.tpu.flash_attention, pallas_call at
// flash_attention.py:758 of jax 0.9.0).  Plain version:
// ops/flash_attention.py::mha_reference.  It rounds where the TPU kernel
// rounds: logits are the fp32 dot, then scaled (never a pre-scaled bf16 q);
// a masked logit is s + mask_value (finite, so a query that matches no key
// averages all of them, as on the TPU); p = exp(s - m) is rounded to v's
// dtype before p.v, which sums in fp32; the row sum l sums the unrounded
// p; a row with l == 0 is left at zero.  Normalisation is deferred to the
// end instead of applied at every key tile (an fp32 rounding difference).
// Given an ``lse`` buffer, both kernels also write each row's log-sum-exp
// m + log(l) in natural units (fp32), the residual from which the backward
// (csrc/flash_attention_bwd.cu) rebuilds P; without it nothing changes.
//
// Bound at BERT-base report length, (B, nh, S, hd) = (32, 12, 512, 64) in
// bf16 with ragged lengths 64-512: the call moves 100.7 MB (q, k, v read
// once, o written once: 0.0301 ms at 3.35 TB/s); the (query, key) pairs
// that share a segment need 16.8 GFLOP (0.0170 ms at 989 TFLOP/s), so
// bytes bound it.  In fp32 the operations bound it (0.250 ms at 67 TFLOP/s
// on the pairs the masks need).
//
// bf16 design (flash_fwd_bf16_kernel), against what held the first version
// (one stage of synchronous loads, mma.sync, a mask per element, every key
// tile computed) back:
// * Both products on wgmma.  A CTA takes 128 queries: two consumer
//   warpgroups of 64 rows each.  S = Q K^T is wgmma m64n64k16 with Q and K
//   in shared memory (K's rows are keys, contiguous along hd: K-major, no
//   transpose).  O += P V takes P from registers as the A operand: the S
//   accumulator fragment is P's A fragment, so P never goes through shared
//   memory; V is read from shared memory MN-major (contiguous along hd,
//   the transpose flag set).
// * TMA and a 2-stage ring.  A producer warp loads Q once per CTA and the
//   K and V tiles of 64 keys into two stages of shared memory, each with a
//   "full" mbarrier (the copy's bytes) and an "empty" mbarrier (the eight
//   consumer warps), so the loads of tile j+1 overlap the math of tile j.
//   The tensor maps (built in the launcher with cuTensorMapEncodeTiled,
//   found through cudaGetDriverEntryPoint: no -lcuda) describe each operand
//   as (hd, S, nh, B) with the view's own strides and 128-byte swizzle; hd
//   128 loads as two 64-column boxes.  TMA fills rows past S with zeros;
//   the mask still gives those keys -inf.
// * Exact skipping of key tiles.  When q and kv carry the same segment
//   array (``self_segments``: BERT's key-padding masks), a consumer
//   warpgroup skips every key tile whose segment ids share no value with
//   its 64 queries' (their [min, max] ranges are disjoint), and the
//   producer loads a tile only if one of the two warpgroups needs it.  This
//   is exact: each query's own key lies in its own segment, so its running
//   max is a real logit once that tile is in; a masked logit (~ -2.4e38)
//   then adds exp2(masked - m) = 0 exactly and leaves m alone, and sums
//   built before it from masked tiles only are multiplied by alpha = 0.
//   With different q and kv arrays nothing is skipped: a query that
//   matches no key averages all of them.  With ``tiles`` set, the producer
//   adds the number of (64-query block, key tile) pairs it handed to the
//   consumers, so a caller reads the skipped share off the card (counted
//   there, not in the consumers, whose registers are the kernel's limit).
// * The mask costs nothing on a tile whose queries and keys all carry one
//   segment value and that lies inside S; elsewhere the key ids come from
//   shared memory (the producer writes them beside each stage).  This
//   branch is kept for the registers, not the time: without it ptxas
//   spills 56-60 bytes a thread at hd 64 under the two-CTA bound.
// * alpha is set to 1 when a row's max does not move, for exactness, not
//   speed: ex2.approx is not relied on to return 1.0 for 0, so a tile of
//   masked logits leaves O and l as they were, bit for bit.
// * exp2 with log2(e) folded into the scale, applied to the logit before
//   the mask is added (-0.7 * FLT_MAX * log2(e) would overflow to -inf).
// * Occupancy: at hd 64 a thread keeps 96 registers, so two CTAs (four
//   consumer warpgroups) share a multiprocessor and one's softmax overlaps
//   another's wgmma (one CTA a multiprocessor was clearly slower on the
//   H100).  hd 128 takes more than 128 registers, one CTA.
//
// fp32 design (flash_fwd_f32_kernel): the CUDA cores, since TF32 is ruled
// out by the parity default (fp32 at HIGHEST), so the FMAs bound it.  Against
// what held the first version back (scalar shared-memory reads, one for
// every two FMAs; one stage of loads behind three barriers a tile; every key
// tile computed):
// * A CTA takes 128 queries in two halves, each half one 64-query block,
//   the skip predicate's unit.  A thread holds 8 query rows (ty + 8 i) of S
//   and O; kTx threads share a row: at hd 64 kTx = 8, so a thread holds an
//   8 x 8 register micro-tile of S (keys tx + 8 j) and 8 columns of O (64
//   threads a half, 128 a CTA); at hd 128 kTx = 16 (8 x 4 of S, 8 columns
//   of O: 256 threads), since 8 x 16 of O beside 8 x 8 of S would spill.
// * Q, K and V sit in shared memory in rows padded to hd + 4 floats and are
//   read as float4, with no bank conflicts.  What bounds the products is the
//   bytes that shared memory returns to the registers, 128 a clock a
//   multiprocessor, the rate of its 128 FMAs: a broadcast float4 costs as
//   much as any other (measured: making any operand's reads warp-uniform
//   changed nothing), so only a larger micro-tile helps.  8 x 4 loads 1.5
//   bytes an FMA (at most 67% of the FMA rate), 8 x 8 loads 1.0.  P goes
//   through shared memory transposed (a key's 64 queries a row, padded to
//   68, a thread's 8 queries in 8 neighbouring floats).
// * cp.async, one buffer of K and one of V, loaded apart: K of the next
//   tile loads under this tile's P V and V under the next tile's S.  Two
//   __syncthreads a tile, each after the wait for the load it publishes and
//   freeing the other buffer, and a named barrier a half between writing P
//   and reading it.  At hd 64 that keeps the CTA at 105 KB of
//   shared memory and at most 255 registers, so two CTAs share a
//   multiprocessor; double-buffered K/V (140 KB, one CTA of four warps) was
//   slower on the H100.  At hd 128 two K/V stages do not fit beside Q and P.
// * Exact skipping of key tiles, by the same argument as the bf16 kernel's:
//   with one id array each half skips a tile whose segment-id range is
//   disjoint from its queries', and the CTA loads a tile that either half
//   needs.  A skipped tile would add expf(mask - m) = 0 to a row whose max
//   is a real logit and leave m alone; sums built before the first real
//   tile are multiplied by alpha = expf(mask - real) = 0.  With ``tiles``
//   set, the CTA adds the (64-query block, key tile) pairs it computed.
// * The arithmetic is the first version's: fp32 FMAs along hd in order,
//   the logit scaled and then the mask value added, keys past S at -inf,
//   expf in natural units, alpha = expf(m - mx), the row sum reduced over
//   the row's threads each tile (at hd 64 over 8 threads of 8 keys, not 16
//   of 4: the one change of summation order), normalisation deferred to the
//   end (a row with l = 0 left at zero), lse = m + logf(l).

#include <limits.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
// DEFAULT_MASK_VALUE of the TPU kernel, rounded to float as it enters the sum
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* seg_q;   // (B, S)
  const int* seg_kv;  // (B, S)
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;  // element strides
  int S;
  float scale;
  int self_segments;  // seg_q and seg_kv are one array: key tiles may be skipped
  int* tiles;         // null, or where the kernel adds the key tiles it computed
  float* lse;         // null, or (B, nh, S) fp32: each row's m + log(l), for the backward
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, two consumer warpgroups and a producer warp
// ---------------------------------------------------------------------------
constexpr int kTileQ = 2 * kBlockQ;       // queries per CTA: one 64-row block per warpgroup
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kBoxBytes = 128;            // a swizzled row: 64 bf16 columns
// flags of a published tile: bit w = warpgroup w computes it, bit 2 + w =
// and needs no mask there (one segment value throughout, all keys < S)
constexpr int kNeed = 1, kPure = 4;

template <int HD>
struct Layout {  // byte offsets in dynamic shared memory (base 1024-aligned)
  static constexpr int kHalves = HD / 64;          // 64-column boxes per row
  static constexpr int kQHalf = kTileQ * kBoxBytes;
  static constexpr int kKHalf = kBlockK * kBoxBytes;
  static constexpr int kStageKV = kHalves * kKHalf;  // one K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kHalves * kQHalf;
  static constexpr int kV = kK + kStages * kStageKV;
  static constexpr int kSeg = kV + kStages * kStageKV;  // int[kStages][kBlockK]
  static constexpr int kInfo = kSeg + kStages * kBlockK * 4;  // int2[kStages]: k0, flags
  static constexpr int kBar = kInfo + kStages * 8;  // u64: full[kStages], empty[kStages], q
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

struct BlockRange {
  int lo, hi;
};

// [min, max] of the segment ids of rows [r0, r0 + 64) below S, over the warp.
__device__ __forceinline__ BlockRange block_range(const int* seg, int r0, int S, int lane) {
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane + 32 * i;
    if (r < S) {
      const int v = seg[r];
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  return {__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi)};
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* sseg = reinterpret_cast<int*>(smem + L::kSeg);
  int2* sinfo = reinterpret_cast<int2*>(smem + L::kInfo);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * kStages, qbar = empty0 + 8 * kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int S = p.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------- producer: Q once, then the K/V tiles that are needed
    const int* segq = p.seg_q + (long long)b * S;
    const int* segkv = p.seg_kv + (long long)b * S;
    BlockRange qr[2];
    bool qvalid[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      qr[w] = block_range(segq, q0 + w * kBlockQ, S, lane);
      qvalid[w] = q0 + w * kBlockQ < S;
    }
    if (lane == 0) {
      mbar_expect_tx(qbar, L::kHalves * L::kQHalf);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load_4d(base + L::kQ + c * L::kQHalf, &map_q, qbar, 64 * c, q0, h, b);
    }
    int stage = 0, handed = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < S; k0 += kBlockK) {
      const BlockRange kr = block_range(segkv, k0, S, lane);
      const bool inside = k0 + kBlockK <= S;
      int flags = 0;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const bool need =
            qvalid[w] && (!p.self_segments || (qr[w].lo <= kr.hi && kr.lo <= qr[w].hi));
        const bool pure = inside && qr[w].lo == qr[w].hi && kr.lo == kr.hi && qr[w].lo == kr.lo;
        flags |= need ? (kNeed << w) | (pure ? kPure << w : 0) : 0;
      }
      if (flags == 0) continue;  // no query of this CTA can see these keys
      handed += __popc(flags & (kNeed | kNeed << 1));
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      int* seg = sseg + stage * kBlockK;
      seg[lane] = k0 + lane < S ? segkv[k0 + lane] : 0;
      seg[lane + 32] = k0 + lane + 32 < S ? segkv[k0 + lane + 32] : 0;
      if (lane == 0) sinfo[stage] = make_int2(k0, flags);
      // every lane releases its own writes; lane 0 adds the copy's bytes
      const uint32_t full = full0 + 8 * stage;
      if (lane != 0) {
        mbar_arrive(full);
      } else {
        mbar_expect_tx(full, 2 * L::kStageKV);
        for (int c = 0; c < L::kHalves; ++c) {
          const int off = stage * L::kStageKV + c * L::kKHalf;
          tma_load_4d(base + L::kK + off, &map_k, full, 64 * c, k0, h, b);
          tma_load_4d(base + L::kV + off, &map_v, full, 64 * c, k0, h, b);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // end of the tiles: a stage with k0 = -1 and no copy
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    if (lane == 0) sinfo[stage] = make_int2(-1, 0);
    mbar_arrive(full0 + 8 * stage);
    if (lane == 0 && p.tiles != nullptr && handed > 0) atomicAdd(p.tiles, handed);
  } else {
    // ---------------- consumers: warpgroup wg owns queries q0 + 64 wg ...
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, tq = lane & 3;  // accumulator row group and column pair
    const int row0 = q0 + wg * kBlockQ + wq * 16 + g;  // this thread's rows: row0, row0 + 8
    const float scale = p.scale * kLog2e;
    int qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      qseg[r] = row < S ? p.seg_q[(long long)b * S + row] : 0;
    }
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float o[HD / 2];          // O accumulator fragment: 64 x HD per warpgroup
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    const uint32_t qtile = base + L::kQ + wg * kBlockQ * kBoxBytes;
    mbar_wait(qbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      const int2 info = sinfo[stage];
      if (info.x < 0) break;
      if (info.y & (kNeed << wg)) {
        const int k0 = info.x;
        const uint32_t ktile = base + L::kK + stage * L::kStageKV;
        const uint32_t vtile = base + L::kV + stage * L::kStageKV;

        // S = Q K^T: 64 queries x 64 keys, k-steps of 16 along hd
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs<32>(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;  // 32 bytes a k-step in a 128-byte row
          wgmma_ss_m64n64k16(s, desc_sw128(qtile + (kk >> 2) * L::kQHalf + off, 16),
                             desc_sw128(ktile + (kk >> 2) * L::kKHalf + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(s);

        // scale (log2 units), mask, and the new row max.  Element i of the
        // fragment: row r = (i >> 1) & 1, key column 8 (i >> 2) + 2 tq + (i & 1)
        float mx[2] = {m[0], m[1]};
        if (info.y & (kPure << wg)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            s[i] *= scale;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
          }
        } else {
          const int* seg = sseg + stage * kBlockK;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const int2 ks = *reinterpret_cast<const int2*>(seg + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int kseg = (e & 1) ? ks.y : ks.x;
              float x = -INFINITY;  // past S: out of the softmax
              if (k0 + col + (e & 1) < S)
                x = s[4 * j + e] * scale + (kseg == qseg[r] ? 0.f : kMaskValue);
              s[4 * j + e] = x;
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = mx[r] == m[r] ? 1.f : ex2(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
          m[r] = mx[r];
        }
        float rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = ex2(s[i] - m[r]);
          rsum[r] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O += P V: P (bf16) from the S fragment, 16 keys a step; V is
        // MN-major, a k-step 16 rows (2048 bytes) on
        fence_regs<HD / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          uint32_t a[4];
          a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          const uint64_t dv = desc_sw128(vtile + kk * 16 * kBoxBytes, L::kKHalf);
          if constexpr (HD == 64)
            wgmma_rs_m64n64k16(o, a, dv);
          else
            wgmma_rs_m64n128k16(o, a, dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HD / 2>(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      if (row >= S) continue;
      // the log-sum-exp in natural units: m is in log2 units, except in a
      // row that shares no key's segment, whose max is the (unscaled) mask
      // value and whose log(l) is below its ulp
      if (p.lse != nullptr && tq == 0)
        p.lse[((long long)b * gridDim.y + h) * S + row] =
            (m[r] < 0.5f * kMaskValue ? m[r] : m[r] * kLn2) + logf(lr);
      const float inv = lr == 0.f ? 1.f : 1.f / lr;
      uint16_t* dst = og + (long long)row * p.o_s + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register micro-tiles, cp.async, exact key-tile skipping
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 8;  // query rows of a thread: ty + 8 i, ty < 8

template <int HD>
struct F32Layout {
  // kTx threads share a query row: a thread holds 64 / kTx keys of S and
  // HD / kTx columns of O.  A half (8 kTx threads) owns one 64-query block.
  static constexpr int kTx = HD == 64 ? 8 : 16;
  static constexpr int kKeys = kBlockK / kTx;  // S columns of a thread: tx + kTx jj
  static constexpr int kCols = HD / kTx;       // O columns of a thread: 4 tx + 4 kTx c + e
  static constexpr int kHalf = 8 * kTx;        // threads of a half
  static constexpr int kThreads = 2 * kHalf;
  static constexpr int kMinBlocks = HD == 64 ? 2 : 1;  // CTAs a multiprocessor
  static constexpr int kLd = HD + 4;        // Q, K, V row stride, floats
  static constexpr int kLdP = kBlockQ + 4;  // P^T row stride: a key's 64 queries
  // float offsets in dynamic shared memory
  static constexpr int kQ = 0;                           // kTileQ x kLd
  static constexpr int kK = kQ + kTileQ * kLd;           // 64 x kLd
  static constexpr int kV = kK + kBlockK * kLd;          // 64 x kLd
  static constexpr int kP = kV + kBlockK * kLd;          // 2 halves x 64 keys x kLdP
  static constexpr int kSegK = kP + 2 * kBlockK * kLdP;  // int: 64
  static constexpr int kSegQ = kSegK + kBlockK;          // int: kTileQ
  static constexpr int kBytes = (kSegQ + kTileQ) * 4;
};

// A half's threads meet at named barrier 1 + half (0 is __syncthreads).
template <int N>
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "n"(N) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(F32Layout<HD>::kThreads, F32Layout<HD>::kMinBlocks)
flash_fwd_f32_kernel(const Params p) {
  using L = F32Layout<HD>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP, R = kF32Rows;
  constexpr int kTx = L::kTx, kKeys = L::kKeys, kCols = L::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem + L::kQ;
  float* sk = smem + L::kK;
  float* sv = smem + L::kV;
  int* ssegk = reinterpret_cast<int*>(smem + L::kSegK);
  int* ssegq = reinterpret_cast<int*>(smem + L::kSegQ);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int half = tid / L::kHalf, ty = (tid % L::kHalf) / kTx, tx = tid % kTx;
  const int S = p.S, nt = (S + kBlockK - 1) / kBlockK;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_b + h * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_b + h * p.v_h;
  const int* segq = p.seg_q + (long long)b * S;
  const int* segkv = p.seg_kv + (long long)b * S;
  float* sp = smem + L::kP + half * kBlockK * kLdP;  // this half's P^T: slot 8 ty + i = row ty + 8 i

  BlockRange qr[2];
  bool qvalid[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    qr[w] = block_range(segq, q0 + w * kBlockQ, S, lane);
    qvalid[w] = q0 + w * kBlockQ < S;
  }
  // The next key tile from j on that a half needs, and which halves need
  // it (bit w); every warp finds the same.  With one id array a half skips
  // a tile whose segment ids share no value with its queries'.
  auto next_tile = [&](int j, int& flags) {
    for (; j < nt; ++j) {
      flags = 0;
      if (p.self_segments) {
        const BlockRange kr = block_range(segkv, j * kBlockK, S, lane);
#pragma unroll
        for (int w = 0; w < 2; ++w)
          if (qvalid[w] && qr[w].lo <= kr.hi && kr.lo <= qr[w].hi) flags |= 1 << w;
      } else {
        flags = (int)qvalid[0] | (int)qvalid[1] << 1;
      }
      if (flags != 0) return j;
    }
    return nt;
  };
  auto load_k = [&](int j) {  // K and the key ids of tile j
    const int k0 = j * kBlockK;
    load_rows<HD, L::kThreads>(sk, kg, p.k_s, k0, kBlockK, S);
    if (tid < kBlockK) {
      const bool in = k0 + tid < S;
      cp_async4(ssegk + tid, segkv + (in ? k0 + tid : 0), in);
    }
  };
  auto load_v = [&](int j) {
    load_rows<HD, L::kThreads>(sv, vg, p.v_s, j * kBlockK, kBlockK, S);
  };

  load_rows<HD, L::kThreads>(sq, qg, p.q_s, q0, kTileQ, S);
  for (int r = tid; r < kTileQ; r += L::kThreads) ssegq[r] = q0 + r < S ? segq[q0 + r] : 0;
  int flags;
  int j = next_tile(0, flags);
  if (j < nt) load_k(j);
  cp_async_commit();  // Q, K and the ids; then V, a group of its own
  if (j < nt) load_v(j);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q, the query ids, K and the key ids of the first tile are in place

  float m[R], l[R], o[R][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }
  const float* qrow = sq + (half * kBlockQ + ty) * kLd;  // this thread's rows, 8 rows apart
  int pairs = 0;

  // Each tile: S and the softmax from K (in place), then V's wait and a
  // barrier after which K is free for the next tile's, loading under P V;
  // then that K's wait and a barrier after which V is free for the next
  // tile's, loading under the next S.
  while (j < nt) {
    int next_flags;
    const int jn = next_tile(j + 1, next_flags);
    pairs += __popc(flags);
    const bool mine = flags & (1 << half);
    float s[R][kKeys];
    if (mine) {
      const int k0 = j * kBlockK;

      // S = Q K^T: rows ty + 8 i, keys tx + kTx jj; the dot products run
      // along hd in order, one fmaf a column, as the plain loop would
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) s[i][jj] = 0.f;
#pragma unroll 1
      for (int d = 0; d < HD; d += 4) {
        float4 kv[kKeys];
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj)
          kv[jj] = *reinterpret_cast<const float4*>(sk + (tx + kTx * jj) * kLd + d);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + 8 * i * kLd + d);
#pragma unroll
          for (int jj = 0; jj < kKeys; ++jj) {
            s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
            s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
            s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
            s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
          }
        }
      }

      // Scale, then mask; keys past S leave the softmax (-inf).  The kTx
      // threads of a row group are neighbouring lanes of one warp; each
      // step runs over all 8 rows at once, so their shuffle chains overlap.
      int kseg[kKeys];
      bool kin[kKeys];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        kseg[jj] = ssegk[tx + kTx * jj];
        kin[jj] = k0 + tx + kTx * jj < S;
      }
      float mx[R], alpha[R], rsum[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qseg = ssegq[half * kBlockQ + ty + 8 * i];
        mx[i] = m[i];
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          float x = -INFINITY;
          if (kin[jj]) {
            x = s[i][jj] * p.scale;
            x = x + (kseg[jj] == qseg ? 0.f : kMaskValue);
          }
          s[i][jj] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        alpha[i] = expf(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
        m[i] = mx[i];
        rsum[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          s[i][jj] = expf(s[i][jj] - mx[i]);
          rsum[i] += s[i][jj];
        }
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i) rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], off);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        l[i] = rsum[i] + alpha[i] * l[i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] *= alpha[i];
      }
    }
    cp_async_wait<0>();  // V of tile j
    __syncthreads();     // V is in place; both halves are done with K and the key ids
    if (jn < nt) load_k(jn);
    cp_async_commit();
    if (mine) {
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        float* dst = sp + (tx + kTx * jj) * kLdP + ty * R;
        *reinterpret_cast<float4*>(dst) = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
      }
      half_sync<L::kHalf>(half);  // the half's P is in place

      // O += P V: rows ty + 8 i, columns 4 tx + 4 kTx c + e, keys in order
      const float* prow = sp + ty * R;
#pragma unroll 2
      for (int t = 0; t < kBlockK; ++t) {
        const float4 p0 = *reinterpret_cast<const float4*>(prow + t * kLdP);
        const float4 p1 = *reinterpret_cast<const float4*>(prow + t * kLdP + 4);
        const float pv[R] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) {
          const float4 f = *reinterpret_cast<const float4*>(sv + t * kLd + 4 * kTx * c + 4 * tx);
          vv[4 * c] = f.x;
          vv[4 * c + 1] = f.y;
          vv[4 * c + 2] = f.z;
          vv[4 * c + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
      }
    }
    cp_async_wait<0>();  // K and the key ids of the next tile
    __syncthreads();     // they are in place; both halves are done with V and P
    if (jn < nt) load_v(jn);
    cp_async_commit();
    j = jn;
    flags = next_flags;
  }
  cp_async_wait<0>();
  if (p.tiles != nullptr && tid == 0 && pairs > 0) atomicAdd(p.tiles, pairs);

  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + half * kBlockQ + ty + 8 * i;
    if (row >= S) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * gridDim.y + h) * S + row] = m[i] + logf(l[i]);
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols / 4; ++c)
      *reinterpret_cast<float4*>(og + (long long)row * p.o_s + 4 * kTx * c + 4 * tx) =
          make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                      o[i][4 * c + 3] * inv);
  }
}

template <int HD>
cudaError_t launch_bf16(const Params& p, int B, int H, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, encode, p.q, B, H, p.S, HD, p.q_s, p.q_h, p.q_b, kTileQ) ||
      !make_map(&mk, encode, p.k, B, H, p.S, HD, p.k_s, p.k_h, p.k_b, kBlockK) ||
      !make_map(&mv, encode, p.v, B, H, p.S, HD, p.v_s, p.v_h, p.v_b, kBlockK))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<HD>::kAlloc;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t err = allow_smem((const void*)flash_fwd_bf16_kernel<HD>, smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kTileQ - 1) / kTileQ, H, B);
  flash_fwd_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, int B, int H, cudaStream_t stream) {
  constexpr int smem = F32Layout<HD>::kBytes;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t err = allow_smem((const void*)flash_fwd_f32_kernel<HD>, smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kTileQ - 1) / kTileQ, H, B);
  flash_fwd_f32_kernel<HD><<<grid, F32Layout<HD>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in turn.
// self_segments: seg_q and seg_kv are the same array, so the kernels skip
// the key tiles that no query of a 64-row block can see.  tiles: null, or a
// device int to which the kernel adds the (64-query block, 64-key tile)
// pairs it computed.  lse: null, or a contiguous (B, H, S) fp32
// tensor that receives each row's log-sum-exp, the residual of the backward
// (csrc/flash_attention_bwd.cu); o is the same with or without it.  Returns
// the CUDA error of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* seg_q, const void* seg_kv,
                                      const long long* strides, int B, int H, int S, int hd,
                                      int bf16, float scale, int self_segments, void* tiles,
                                      void* lse, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.seg_q = (const int*)seg_q;
  p.seg_kv = (const int*)seg_kv;
  p.q_b = strides[0]; p.q_h = strides[1]; p.q_s = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_s = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_s = strides[8];
  p.o_b = strides[9]; p.o_h = strides[10]; p.o_s = strides[11];
  p.S = S;
  p.scale = scale;
  p.self_segments = self_segments;
  p.tiles = (int*)tiles;
  p.lse = (float*)lse;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return (int)(hd == 64 ? launch_bf16<64>(p, B, H, st) : launch_bf16<128>(p, B, H, st));
  return (int)(hd == 64 ? launch_f32<64>(p, B, H, st) : launch_f32<128>(p, B, H, st));
}
