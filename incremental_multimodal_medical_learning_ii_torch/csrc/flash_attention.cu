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
// fp32 (flash_fwd_f32_kernel, unchanged): 16 x 16 threads, each a 4 x 4
// tile of S and a 4 x hd/16 tile of O, fp32 FMA on the CUDA cores (no
// TF32: the parity default is fp32 at HIGHEST); Q, K, V and P in shared
// memory; one stage.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
// DEFAULT_MASK_VALUE of the TPU kernel, rounded to float as it enters the sum
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

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
  int* tiles;         // null, or where the bf16 kernel adds the key tiles it computed
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity ``parity`` has completed.  A
// wait that never ends (a fault in the pipeline) traps after ~4e9 cycles
// (about two seconds), so the launch fails with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 4000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory; completes on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a tile written by TMA with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// next 64-column group ``lbo`` bytes on (used by MN-major operands only).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma instructions that read and write them.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, fp32) = A (64 x 16, shared, K-major) . B (64 x 16, shared, K-major)^T, plus
// D if ``accumulate``
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
        wgmma_wait_all();
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
        wgmma_wait_all();
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
// fp32: CUDA cores
// ---------------------------------------------------------------------------
template <int HD>
constexpr int f32_smem_bytes() {
  return (2 * kBlockQ * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1)) * 4 + kBlockK * 4;
}

template <int HD>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const Params p) {
  constexpr int kLd = HD + 1;        // odd stride: 16 rows read at one column hit 16 banks
  constexpr int kLdP = kBlockK + 1;
  constexpr int kDj = HD / 16;       // O columns per thread
  constexpr int kVec = HD / 4;       // float4 chunks in a row
  extern __shared__ float smem[];
  float* sq = smem;                  // kBlockQ x kLd
  float* sk = sq + kBlockQ * kLd;    // kBlockK x kLd
  float* sv = sk + kBlockK * kLd;    // kBlockK x HD
  float* sp = sv + kBlockK * HD;     // kBlockQ x kLdP
  int* sseg = reinterpret_cast<int*>(sp + kBlockQ * kLdP);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;  // rows ty*4+i, columns tx+16j
  const int S = p.S;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_b + h * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_b + h * p.v_h;
  const int* segkv = p.seg_kv + (long long)b * S;

  for (int i = tid; i < kBlockQ * kVec; i += 256) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = *reinterpret_cast<const float4*>(qg + (long long)(q0 + r) * p.q_s + c);
    float* d = sq + r * kLd + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    qseg[i] = row < S ? p.seg_q[(long long)b * S + row] : 0;
  }

  float m[4], l[4], acc[4][kDj];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // the previous tile's P V is done (and Q is in place)
    for (int i = tid; i < kBlockK * kVec; i += 256) {
      const int r = i / kVec, c = (i % kVec) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kg + (long long)(k0 + r) * p.k_s + c);
        vv = *reinterpret_cast<const float4*>(vg + (long long)(k0 + r) * p.v_s + c);
      }
      float* d = sk + r * kLd + c;
      d[0] = kv.x; d[1] = kv.y; d[2] = kv.z; d[3] = kv.w;
      *reinterpret_cast<float4*>(sv + r * HD + c) = vv;
    }
    if (tid < kBlockK) sseg[tid] = k0 + tid < S ? segkv[k0 + tid] : 0;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sk[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // The 16 threads of a row group are lanes 0-15 or 16-31 of one warp.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        float x = -INFINITY;  // past S: out of the softmax
        if (k0 + col < S) {
          x = s[i][j] * p.scale;
          x = x + (sseg[col] == qseg[i] ? 0.f : kMaskValue);
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);  // 0 on the first tile (m = -inf)
      m[i] = mx;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - mx);
        rsum += pv;
        sp[(ty * 4 + i) * kLdP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = rsum + alpha * l[i];
#pragma unroll
      for (int j = 0; j < kDj; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty * 4 + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) vv[j] = sv[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kDj; ++j) og[(long long)row * p.o_s + tx + 16 * j] = acc[i][j] * inv;
  }
}

// The dynamic shared-memory attribute is a property of the kernel on one
// device: set it once on each card the process launches on (a bit per
// device ordinal in ``done``; ordinals past 63 set it on every launch).
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)sym;
  }
  return fn;
}

// A bf16 (B, nh, S, hd) view as the tensor (hd, S, nh, B), element strides
// (row, head, batch); boxes of 64 columns x ``rows`` rows, 128-byte swizzle.
bool make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int B, int H, int S,
              int hd, long long s_row, long long s_head, long long s_batch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  // a stride of a size-1 dimension is never stepped; TMA still wants it nonzero
  const long long st[3] = {s_row, s_head, s_batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)(st[i] > 0 ? st[i] * 2 : 16);
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<HD>();
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t err = allow_smem((const void*)flash_fwd_f32_kernel<HD>, smem, raised);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<HD><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in turn.
// self_segments: seg_q and seg_kv are the same array, so the bf16 kernel
// may skip key tiles that no query of a block can see.  tiles: null, or a
// device int to which the bf16 kernel adds the (64-query block, 64-key
// tile) pairs it computed.  Returns the CUDA error of the launch (0 =
// launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* seg_q, const void* seg_kv,
                                      const long long* strides, int B, int H, int S, int hd,
                                      int bf16, float scale, int self_segments, void* tiles,
                                      void* stream) {
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return (int)(hd == 64 ? launch_bf16<64>(p, B, H, st) : launch_bf16<128>(p, B, H, st));
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  return (int)(hd == 64 ? launch_f32<64>(p, grid, st) : launch_f32<128>(p, grid, st));
}
