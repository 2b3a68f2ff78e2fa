// Flash attention backward for Hopper (sm_90a): the gradients of
// csrc/flash_attention.cu's forward with respect to q, k and v, never
// materialising the S x S matrices.  For every (batch, head), with
// s[i, j] = (q_i . k_j) * scale + (seg_q[i] == seg_kv[j] ? 0 : -0.7 * FLT_MAX)
// and the forward's per-row log-sum-exp lse_i:
//
//   p[i, j]  = exp(s[i, j] - lse_i)              (keys past S: 0)
//   di_i     = sum_c o[i, c] do[i, c]
//   dv_j     = sum_i p[i, j] do_i
//   ds[i, j] = p[i, j] (do_i . v_j - di_i) * scale
//   dk_j     = sum_i ds[i, j] q_i
//   dq_i     = sum_j ds[i, j] k_j
//
// Replaces the two backward pallas_calls of the JAX library kernel that the
// JAX package's models/cxr_bert.py::_self_attention calls with use_flash=True
// (jax.experimental.pallas.ops.tpu.flash_attention of jax 0.9.0, reached
// through its custom_vjp, _flash_attention_bwd at flash_attention.py:254):
// the dK/dV kernel (_flash_attention_dkv_kernel, pallas_call at :1121) and
// the dQ kernel (_flash_attention_dq_kernel, pallas_call at :1456).  Plain
// version: ops/flash_attention.py::flash_attention_bwd_reference.  It rounds
// where the library does: p is rounded to do's type before dv's product, ds
// (scale included) to q's type before dk's and dq's; every sum is fp32.
//
// The library keeps the forward's row max m and row sum l; this port keeps
// one number, lse = m + log(l).  The two agree except in a row whose
// segment no key shares: there every logit is q.k * scale + mask value,
// which rounds to the mask value itself in fp32 (|q.k * scale| < 2^103),
// so m is the mask value, l = S, log(l) is lost below m's ulp and
// exp(s - lse) = 1.  Such a row (lse below half the mask value; no row that
// shares a segment comes near it) takes p = 1/S, the uniform softmax the
// library and the plain version give it.
//
// Three kernels a launch, on the caller's stream:
// * flash_bwd_prologue_kernel: di into a (B, H, S) fp32 scratch (16 bytes
//   of o and do a lane), and the [min, max] segment id of every 64-row
//   block of seg_q and seg_kv (the skip predicate's input);
// * a dK/dV kernel: a CTA owns key tiles and walks the query blocks;
// * bf16: a dQ kernel, a CTA owning query blocks and walking the key
//   tiles (it recomputes S = Q K^T and dP = dO V^T, as the library does);
//   fp32: the dK/dV kernel also writes each CTA's share of dQ (ds k over
//   its keys) and flash_bwd_dq_reduce_f32_kernel sums the shares.
// No gradient is summed across CTAs with atomics: two launches on the same
// inputs give the same bits.
//
// Bound at BERT-base report length, (B, nh, S, hd) = (32, 12, 512, 64) in
// bf16 with ragged lengths 64-512: the call reads q, k, v, o and do and
// writes dq, dk and dv once, 201 MB (0.060 ms at 3.35 TB/s); the (query,
// key) pairs that share a segment need 2.5x the forward's operations,
// 42 GFLOP (0.042 ms at 989 TFLOP/s), so bytes bound it; in fp32 the
// operations do (0.63 ms at 67 TFLOP/s).  The seven products of the two
// passes on the 76% of the 64 x 64 tile pairs the masks keep are 68.7
// GFLOP (the bf16 kernels' work; fp32 forms dQ from the dK/dV pass's dS:
// five products, 49.1 GFLOP).
//
// Exact tile skipping, both types, both passes.  When q and kv carry one
// segment array (``self_segments``: BERT's key-padding masks), a (64-query
// block, 64-key tile) pair whose segment-id [min, max] ranges are disjoint
// is not computed (ops/flash_attention.py::key_tiles_needed is the
// predicate).  This is exact: with one array every query shares its own
// key's segment, so no row is fully masked and every skipped pair has
// p = exp(mask - lse) = 0 and ds = 0 exactly; the gradients with skipping
// are bit-equal to the same kernels with skipping off (different id
// arrays, every pair computed).  With ``tiles`` set, each pass adds the
// pairs it computed, on the card: tiles[0] the dK/dV pass, tiles[1] dQ.
//
// bf16 (flash_bwd_{dkv,dq}_bf16_kernel): every product on wgmma, after K3's
// forward.  Two consumer warpgroups and a producer warp a CTA; TMA loads
// (128-byte swizzle, tensor maps of each operand's own strides) into a
// 2-stage ring with full/empty mbarriers, the producer also writing each
// stage's lse, di and segment ids beside it.
// * dK/dV: at hd 64 a warpgroup owns 64 keys (128 a CTA); at hd 128 both
//   own the same 64 keys and each 64 of the 128 gradient columns (S and dP
//   are computed by both: 2 x 128 accumulators a thread would spill).
//   S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in shared
//   memory, K-major (keys are the M rows); P^T and dS^T are formed in the
//   accumulator registers (lse and di per column from shared memory) and
//   fed back as the register A operand of dV += P^T dO and dK += dS^T Q,
//   dO and Q read MN-major (transpose flag), as K3 reads V.  P and dS
//   never touch shared memory.
// * dQ: a warpgroup owns 64 queries (128 a CTA); S = Q K^T, dP = dO V^T,
//   dQ += dS K with dS from registers and K read MN-major.
// * exp2 with log2(e) folded into the scale; on a tile with one segment
//   value throughout and every row inside S no mask is applied; elsewhere
//   the mask is a select on the segment ids, with no test of S (a row past
//   S is zeros in shared memory and adds 0); only a tile holding a query
//   that shares no key's segment takes the general path (p = 1/S there).
//
// fp32 (flash_bwd_dkv_f32_kernel, flash_bwd_dq_reduce_f32_kernel): TF32
// is ruled out by the parity bar (fp32 at HIGHEST), so the CUDA cores, and
// the FMAs bound it.  256 threads a CTA, each a register micro-tile of
// 8 x 4 (hd 64; 4 x 4 at hd 128) of the score tile and 8 x 4 (4 x 8) of its
// gradient rows: 128 keys (64) a CTA.  Shared-memory rows are padded to
// hd + 4 floats so that a thread reads its rows and columns as float4
// without bank conflicts: 2.67 FMAs for every word loaded.  The next Q/dO
// block is loaded by cp.async into the second buffer while the current one
// is computed (at hd 128 one buffer: two do not fit in 227 KB beside K, V,
// P and dS).  P and dS go through shared
// memory (a thread holds 4 queries of a key; the products need all 64).
// dQ has no pass of its own: recomputing S and dP there would cost two of
// the three products, while the CTA's dS is already in shared memory, so
// the CTA adds its keys' ds k for the block's queries (a fifth product,
// 4 x 4 a thread) and stores that share (fp32, 16 KB a block); the third
// kernel sums a row's shares in CTA order, reading only those whose CTA
// computed the row's block (the predicate again).  A CTA tile that does not
// need a block its partner needs writes ds = 0 into the share's product.

#include <limits.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlock = 64;  // queries of a block, keys of a tile: the skip predicate's unit
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kFullyMasked = 0.5f * kMaskValue;  // an lse below: no key shares the row's segment
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* di;         // (B, H, S), written by the prologue
  int2* qrange;      // (B, nb): [min, max] of seg_q over each 64-row block, written by the prologue
  int2* krange;      // the same of seg_kv (qrange itself when self_segments)
  void* dq;
  void* dk;
  void* dv;
  const int* seg_q;   // (B, S)
  const int* seg_kv;  // (B, S)
  // element strides (batch, head, row) of q, k, v, o, do, dq, dk, dv
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s, do_b, do_h, do_s, dq_b,
      dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int B, H, S, hd, nb;
  float scale;
  int self_segments;  // seg_q and seg_kv are one array: disjoint tile pairs are skipped
  int* tiles;         // null, or [2]: the pairs each pass computed are added there
  float* dqp;         // fp32: (B, H, CTAs, S, hd), each dK/dV CTA's share of dQ
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool overlap(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// a pair of 64-row blocks is computed unless the ids are one array and the
// two blocks' [min, max] ranges are disjoint
__device__ __forceinline__ bool pair_needed(const BwdParams& p, int2 qr, int2 kr) {
  return !p.self_segments || overlap(qr, kr);
}

// p of one (query, key) pair from its raw dot product, as the forward
// built it: scaled, then the mask added; 0 for a query or key past S.
__device__ __forceinline__ float prob(float dot, float scale, bool inside, bool same_segment,
                                      float lse, float inv_s) {
  if (!inside) return 0.f;
  const float x = dot * scale + (same_segment ? 0.f : kMaskValue);
  const float pr = expf(x - lse);
  return lse < kFullyMasked ? pr * inv_s : pr;
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4 raw, float* x, float) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4 raw, float* x, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// ---------------------------------------------------------------------------
// prologue: di = rowsum(o * do), a row per hd * sizeof(T) / 16 lanes (16
// bytes of o and of do a lane); then a warp for each 64-row block of seg_q
// (and of seg_kv when it is another array)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_prologue_kernel(const BwdParams p, int rows,
                                                                 int di_warps) {
  constexpr int kVec = 16 / sizeof(T);
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);  // B H S <= 2^30: 32-bit index math
  const int lane = threadIdx.x & 31;
  if (w < di_warps) {
    const int lanes = p.hd / kVec;  // 8, 16 or 32: a power of two
    const int row = w * (32 / lanes) + lane / lanes;
    const int c = (lane % lanes) * kVec;
    float acc = 0.f;
    if (row < rows) {
      const int s = row % p.S, bh = row / p.S, h = bh % p.H, b = bh / p.H;
      const T* o = static_cast<const T*>(p.o) + b * p.o_b + h * p.o_h + (long long)s * p.o_s;
      const T* d = static_cast<const T*>(p.dout) + b * p.do_b + h * p.do_h + (long long)s * p.do_s;
      float x[kVec], y[kVec];
      unpack(*reinterpret_cast<const uint4*>(o + c), x, T());
      unpack(*reinterpret_cast<const uint4*>(d + c), y, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = fmaf(x[e], y[e], acc);
    }
    for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (row < rows && lane % lanes == 0) p.di[row] = acc;
    return;
  }
  const int blocks = p.B * p.nb;
  const int r = w - di_warps;
  if (r >= (p.self_segments ? 1 : 2) * blocks) return;
  const bool kv = r >= blocks;
  const int rb = kv ? r - blocks : r, b = rb / p.nb, blk = rb % p.nb;
  const int* seg = (kv ? p.seg_kv : p.seg_q) + (long long)b * p.S;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = blk * kBlock + lane + 32 * i;
    if (t < p.S) {
      lo = min(lo, seg[t]);
      hi = max(hi, seg[t]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) (kv ? p.krange : p.qrange)[rb] = make_int2(lo, hi);
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, two consumer warpgroups and a producer warp
// ---------------------------------------------------------------------------
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;
constexpr int kTcThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kBoxBytes = 128;                        // a swizzled row: 64 bf16 columns
// flags of a published stage: bit w = warpgroup w computes it, bit 2 + w =
// and needs no mask there (one segment value throughout, every row < S);
// kLonely: a query of the block shares no key's segment (its p is 1/S)
constexpr int kNeed = 1, kPure = 4, kLonely = 16;

// The two SS products of a tile: acc_a = A1 B1^T and acc_b = A2 B2^T over
// hd (k-steps of 16 columns: 32 bytes of a 128-byte swizzled row, the next
// 64 columns a box on), both operands K-major in shared memory.
template <int HD>
__device__ __forceinline__ void ss_pair(float* acc_a, float* acc_b, uint32_t a1, uint32_t b1,
                                        uint32_t a2, uint32_t b2, int a_box, int b_box) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_a[i] = acc_b[i] = 0.f;
  fence_regs<32>(acc_a);
  fence_regs<32>(acc_b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_m64n64k16(acc_a, desc_sw128(a1 + (kk >> 2) * a_box + off, 16),
                       desc_sw128(b1 + (kk >> 2) * b_box + off, 16), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_m64n64k16(acc_b, desc_sw128(a2 + (kk >> 2) * a_box + off, 16),
                       desc_sw128(b2 + (kk >> 2) * b_box + off, 16), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(acc_a);
  fence_regs<32>(acc_b);
}

// The A fragments of a 64 x 64 accumulator fed back as the A operand of a
// product over its 64 columns: k-step kk is a[4 kk .. 4 kk + 3] (the
// accumulator's columns 16 kk .. 16 kk + 15 are the k-step's A columns).
__device__ __forceinline__ void pack_fragments(uint32_t* a, const float* acc) {
#pragma unroll
  for (int t = 0; t < 16; ++t) a[t] = pack_bf16(acc[2 * t], acc[2 * t + 1]);
}

// Barriers of the ring: full[kStages], empty[kStages], then the once-loaded tiles'.
__device__ __forceinline__ void init_ring(uint32_t bars) {
  for (int s = 0; s < kStages; ++s) {
    mbar_init(bars + 8 * s, 32);                         // full: the producer warp's lanes
    mbar_init(bars + 8 * (kStages + s), kConsumerWarps);  // empty: the consumer warps
  }
  mbar_init(bars + 8 * 2 * kStages, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

template <int HD>
struct DkvLayout {  // byte offsets in dynamic shared memory (base 1024-aligned)
  static constexpr int kHalves = HD / 64;               // 64-column boxes of a row
  static constexpr int kKeys = HD == 64 ? 128 : 64;     // keys of a CTA
  static constexpr int kKBox = kKeys * kBoxBytes;       // one box of K (or V)
  static constexpr int kQBox = kBlock * kBoxBytes;      // one box of a Q (or dO) block
  static constexpr int kStageQ = kHalves * kQBox;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kHalves * kKBox;
  static constexpr int kQ = kV + kHalves * kKBox;
  static constexpr int kDO = kQ + kStages * kStageQ;
  static constexpr int kRow = kDO + kStages * kStageQ;  // per stage: lse[64], di[64], seg_q[64]
  static constexpr int kInfo = kRow + kStages * 3 * kBlock * 4;  // int2[kStages]: q0, flags
  static constexpr int kBar = kInfo + kStages * 8;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, const BwdParams p) {
  using L = DkvLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* srow = reinterpret_cast<float*>(smem + L::kRow);
  int2* sinfo = reinterpret_cast<int2*>(smem + L::kInfo);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * kStages, kvbar = empty0 + 8 * kStages;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * L::kKeys;
  const int S = p.S, nb = p.nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) init_ring(full0);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------- producer: K and V once, then the query blocks that are needed
    const int2* qrange = p.qrange + (long long)b * nb;
    const int2* krange = p.krange + (long long)b * nb;
    const int* segq = p.seg_q + (long long)b * S;
    const long long row0 = ((long long)b * p.H + h) * S;
    int2 kr[2];
    bool kvalid[2], kin[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {  // warpgroup w's 64-key tile (at hd 128 both own the CTA's)
      const int kt = HD == 64 ? 2 * blockIdx.x + w : blockIdx.x;
      kvalid[w] = kt * kBlock < S;
      kr[w] = kvalid[w] ? krange[kt] : make_int2(0, 0);
      kin[w] = (kt + 1) * kBlock <= S;
    }
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::kHalves * L::kKBox);
      for (int c = 0; c < L::kHalves; ++c) {
        tma_load_4d(base + L::kK + c * L::kKBox, &map_k, kvbar, 64 * c, k0, h, b);
        tma_load_4d(base + L::kV + c * L::kKBox, &map_v, kvbar, 64 * c, k0, h, b);
      }
    }
    int stage = 0, handed = 0;
    uint32_t phase = 0;
    for (int i = 0; i < nb; ++i) {
      const int2 qr = qrange[i];
      const bool qin = (i + 1) * kBlock <= S;
      int flags = 0;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const bool need = kvalid[w] && pair_needed(p, qr, kr[w]);
        const bool pure = qin && kin[w] && qr.x == qr.y && kr[w].x == kr[w].y && qr.x == kr[w].x;
        flags |= need ? (kNeed << w) | (pure ? kPure << w : 0) : 0;
      }
      if (flags == 0) continue;  // no key of this CTA shares a segment with these queries
      handed += HD == 64 ? __popc(flags & 3) : 1;
      float lse[2], di[2];
      int seg[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // read before the wait: the loads overlap it
        const int q = i * kBlock + lane + 32 * e;
        const bool in = q < S;
        lse[e] = in ? p.lse[row0 + q] : 0.f;
        di[e] = in ? p.di[row0 + q] : 0.f;
        seg[e] = in ? segq[q] : 0;
      }
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      float* row = srow + stage * 3 * kBlock;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        row[lane + 32 * e] = lse[e];
        row[kBlock + lane + 32 * e] = di[e];
        reinterpret_cast<int*>(row + 2 * kBlock)[lane + 32 * e] = seg[e];
      }
      if (__any_sync(0xffffffffu, lse[0] < kFullyMasked || lse[1] < kFullyMasked)) flags |= kLonely;
      if (lane == 0) sinfo[stage] = make_int2(i * kBlock, flags);
      // every lane releases its own writes; lane 0 adds the copy's bytes
      const uint32_t full = full0 + 8 * stage;
      if (lane != 0) {
        mbar_arrive(full);
      } else {
        mbar_expect_tx(full, 2 * L::kStageQ);
        for (int c = 0; c < L::kHalves; ++c) {
          const int off = stage * L::kStageQ + c * L::kQBox;
          tma_load_4d(base + L::kQ + off, &map_q, full, 64 * c, i * kBlock, h, b);
          tma_load_4d(base + L::kDO + off, &map_do, full, 64 * c, i * kBlock, h, b);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // end of the blocks: a stage with q0 = -1 and no copy
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    if (lane == 0) sinfo[stage] = make_int2(-1, 0);
    mbar_arrive(full0 + 8 * stage);
    if (lane == 0 && p.tiles != nullptr && handed > 0) atomicAdd(p.tiles, handed);
  } else {
    // ---------------- consumers: warpgroup wg owns keys k0 + krow, krow + 8 (per thread)
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, tq = lane & 3;  // accumulator row group and column pair
    const int krow = (HD == 64 ? wg * kBlock : 0) + wq * 16 + g;
    const int chalf = HD == 64 ? 0 : wg;  // the 64 gradient columns of this warpgroup
    const float scale = p.scale, scale2 = p.scale * kLog2e, inv_s = 1.f / (float)S;
    int kseg[2];
    bool kin[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + krow + 8 * r;
      kin[r] = key < S;
      kseg[r] = kin[r] ? p.seg_kv[(long long)b * S + key] : 0;
    }
    float dk[32], dv[32];  // 64 keys x 64 columns a warpgroup
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t krows = (HD == 64 ? wg * kBlock * kBoxBytes : 0);
    const uint32_t ktile = base + L::kK + krows, vtile = base + L::kV + krows;
    mbar_wait(kvbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      const int2 info = sinfo[stage];
      if (info.x < 0) break;
      if (info.y & (kNeed << wg)) {
        const uint32_t qtile = base + L::kQ + stage * L::kStageQ;
        const uint32_t dotile = base + L::kDO + stage * L::kStageQ;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float s[32], dp[32];
        ss_pair<HD>(s, dp, ktile, qtile, vtile, dotile, L::kKBox, L::kQBox);

        // P^T and dS^T in place.  Element i of a fragment: key row
        // krow + 8 ((i >> 1) & 1), query column 8 (i >> 2) + 2 tq + (i & 1)
        const float* lse_s = srow + stage * 3 * kBlock;
        const float* di_s = lse_s + kBlock;
        if (info.y & (kPure << wg)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 d = *reinterpret_cast<const float2*>(di_s + col);
            const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
            const float nd[2] = {-d.x * scale, -d.y * scale};
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int i = 4 * j + e4, e = e4 & 1;
              const float pr = ex2(fmaf(s[i], scale2, nl[e]));
              dp[i] = pr * fmaf(dp[i], scale, nd[e]);
              s[i] = pr;
            }
          }
        } else if (!(info.y & kLonely)) {
          // no row fully masked (always so with one id array): a query or
          // key past S needs no mask (its Q, dO, K or V row is zeros: it adds
          // 0 to every kept row, and its own rows are not stored)
          const int* seg_s = reinterpret_cast<const int*>(lse_s + 2 * kBlock);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 d = *reinterpret_cast<const float2*>(di_s + col);
            const int2 qs = *reinterpret_cast<const int2*>(seg_s + col);
            const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
            const float nd[2] = {-d.x * scale, -d.y * scale};
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int i = 4 * j + e4, e = e4 & 1;
              const float pr = (e ? qs.y : qs.x) == kseg[e4 >> 1] ? ex2(fmaf(s[i], scale2, nl[e])) : 0.f;
              dp[i] = pr * fmaf(dp[i], scale, nd[e]);
              s[i] = pr;
            }
          }
        } else {
          const int* seg_s = reinterpret_cast<const int*>(lse_s + 2 * kBlock);
          const int q0 = info.x;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 d = *reinterpret_cast<const float2*>(di_s + col);
            const int2 qs = *reinterpret_cast<const int2*>(seg_s + col);
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int i = 4 * j + e4, e = e4 & 1, r = e4 >> 1;
              const float lse = e ? l.y : l.x;
              const bool same = (e ? qs.y : qs.x) == kseg[r];
              float pr = 0.f;
              if (q0 + col + e < S && kin[r]) {
                if (lse < kFullyMasked)  // a query no key shares a segment with: uniform
                  pr = expf(s[i] * scale + (same ? 0.f : kMaskValue) - lse) * inv_s;
                else if (same)
                  pr = ex2(fmaf(s[i], scale2, -lse * kLog2e));
              }
              dp[i] = pr * fmaf(dp[i], scale, -(e ? d.y : d.x) * scale);
              s[i] = pr;
            }
          }
        }
        uint32_t pa[16], da[16];
        pack_fragments(pa, s);
        pack_fragments(da, dp);

        // dV += P^T dO and dK += dS^T Q over the block's 64 queries; dO and
        // Q are MN-major, a k-step 16 rows (2048 bytes) on
        fence_regs<32>(dv);
        fence_regs<32>(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk)
          wgmma_rs_m64n64k16(dv, pa + 4 * kk,
                             desc_sw128(dotile + chalf * L::kQBox + kk * 16 * kBoxBytes, L::kQBox));
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk)
          wgmma_rs_m64n64k16(dk, da + 4 * kk,
                             desc_sw128(qtile + chalf * L::kQBox + kk * 16 * kBoxBytes, L::kQBox));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(dv);
        fence_regs<32>(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    uint16_t* dkg = static_cast<uint16_t*>(p.dk) + b * p.dk_b + h * p.dk_h + chalf * 64 + 2 * tq;
    uint16_t* dvg = static_cast<uint16_t*>(p.dv) + b * p.dv_b + h * p.dv_h + chalf * 64 + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!kin[r]) continue;
      const long long key = k0 + krow + 8 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkg + key * p.dk_s + 8 * j) =
            pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + key * p.dv_s + 8 * j) =
            pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int HD>
struct DqLayout {  // byte offsets in dynamic shared memory (base 1024-aligned)
  static constexpr int kHalves = HD / 64;
  static constexpr int kQueries = 2 * kBlock;            // queries of a CTA: 64 a warpgroup
  static constexpr int kQBox = kQueries * kBoxBytes;     // one box of Q (or dO)
  static constexpr int kKBox = kBlock * kBoxBytes;       // one box of a K (or V) tile
  static constexpr int kStageK = kHalves * kKBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kHalves * kQBox;
  static constexpr int kK = kDO + kHalves * kQBox;
  static constexpr int kV = kK + kStages * kStageK;
  static constexpr int kSeg = kV + kStages * kStageK;    // int[kStages][64]: the tile's seg_kv
  static constexpr int kInfo = kSeg + kStages * kBlock * 4;  // int2[kStages]: k0, flags
  static constexpr int kBar = kInfo + kStages * 8;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, const BwdParams p) {
  using L = DqLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  int* sseg = reinterpret_cast<int*>(smem + L::kSeg);
  int2* sinfo = reinterpret_cast<int2*>(smem + L::kInfo);
  const uint32_t full0 = base + L::kBar, empty0 = full0 + 8 * kStages, qbar = empty0 + 8 * kStages;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * L::kQueries;
  const int S = p.S, nb = p.nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) init_ring(full0);
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---------------- producer: Q and dO once, then the key tiles that are needed
    const int2* qrange = p.qrange + (long long)b * nb;
    const int2* krange = p.krange + (long long)b * nb;
    const int* segkv = p.seg_kv + (long long)b * S;
    int2 qr[2];
    bool qvalid[2], qin[2];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int qt = 2 * blockIdx.x + w;
      qvalid[w] = qt * kBlock < S;
      qr[w] = qvalid[w] ? qrange[qt] : make_int2(0, 0);
      qin[w] = (qt + 1) * kBlock <= S;
    }
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * L::kHalves * L::kQBox);
      for (int c = 0; c < L::kHalves; ++c) {
        tma_load_4d(base + L::kQ + c * L::kQBox, &map_q, qbar, 64 * c, q0, h, b);
        tma_load_4d(base + L::kDO + c * L::kQBox, &map_do, qbar, 64 * c, q0, h, b);
      }
    }
    int stage = 0, handed = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nb; ++j) {
      const int2 kr = krange[j];
      const bool kin = (j + 1) * kBlock <= S;
      int flags = 0;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const bool need = qvalid[w] && pair_needed(p, qr[w], kr);
        const bool pure = qin[w] && kin && qr[w].x == qr[w].y && kr.x == kr.y && qr[w].x == kr.x;
        flags |= need ? (kNeed << w) | (pure ? kPure << w : 0) : 0;
      }
      if (flags == 0) continue;  // no query of this CTA shares a segment with these keys
      handed += __popc(flags & 3);
      int seg[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kBlock + lane + 32 * e;
        seg[e] = key < S ? segkv[key] : 0;
      }
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      sseg[stage * kBlock + lane] = seg[0];
      sseg[stage * kBlock + lane + 32] = seg[1];
      if (lane == 0) sinfo[stage] = make_int2(j * kBlock, flags);
      const uint32_t full = full0 + 8 * stage;
      if (lane != 0) {
        mbar_arrive(full);
      } else {
        mbar_expect_tx(full, 2 * L::kStageK);
        for (int c = 0; c < L::kHalves; ++c) {
          const int off = stage * L::kStageK + c * L::kKBox;
          tma_load_4d(base + L::kK + off, &map_k, full, 64 * c, j * kBlock, h, b);
          tma_load_4d(base + L::kV + off, &map_v, full, 64 * c, j * kBlock, h, b);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    if (lane == 0) sinfo[stage] = make_int2(-1, 0);
    mbar_arrive(full0 + 8 * stage);
    if (lane == 0 && p.tiles != nullptr && handed > 0) atomicAdd(p.tiles + 1, handed);
  } else {
    // ---------------- consumers: warpgroup wg owns queries q0 + 64 wg ...
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int qrow = wg * kBlock + wq * 16 + g;  // this thread's rows: q0 + qrow, + 8
    const float scale = p.scale, scale2 = p.scale * kLog2e, inv_s = 1.f / (float)S;
    const long long row0 = ((long long)b * p.H + h) * S;
    float lse[2], nl[2], nd[2];
    int qseg[2];
    bool qin[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + qrow + 8 * r;
      qin[r] = q < S;
      lse[r] = qin[r] ? p.lse[row0 + q] : 0.f;
      nl[r] = -lse[r] * kLog2e;
      nd[r] = -(qin[r] ? p.di[row0 + q] : 0.f) * scale;
      qseg[r] = qin[r] ? p.seg_q[(long long)b * S + q] : 0;
    }
    // a row of the warp shares no key's segment: its tiles take the general path
    const bool lonely_rows =
        __any_sync(0xffffffffu, lse[0] < kFullyMasked || lse[1] < kFullyMasked);
    float dq[HD / 2];  // 64 queries x HD a warpgroup
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint32_t qtile = base + L::kQ + wg * kBlock * kBoxBytes;
    const uint32_t dotile = base + L::kDO + wg * kBlock * kBoxBytes;
    mbar_wait(qbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);
      const int2 info = sinfo[stage];
      if (info.x < 0) break;
      if (info.y & (kNeed << wg)) {
        const uint32_t ktile = base + L::kK + stage * L::kStageK;
        const uint32_t vtile = base + L::kV + stage * L::kStageK;
        // S = Q K^T and dP = dO V^T: 64 queries x 64 keys
        float s[32], dp[32];
        ss_pair<HD>(s, dp, qtile, ktile, dotile, vtile, L::kQBox, L::kKBox);

        // dS in place of S.  Element i: query row qrow + 8 ((i >> 1) & 1),
        // key column 8 (i >> 2) + 2 tq + (i & 1)
        if (info.y & (kPure << wg)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            s[i] = ex2(fmaf(s[i], scale2, nl[r])) * fmaf(dp[i], scale, nd[r]);
          }
        } else if (!lonely_rows) {  // no mask past S (as in the dK/dV pass)
          const int* seg = sseg + stage * kBlock;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int2 ks = *reinterpret_cast<const int2*>(seg + 8 * j + 2 * tq);
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int i = 4 * j + e4, r = e4 >> 1;
              const float pr = ((e4 & 1) ? ks.y : ks.x) == qseg[r] ? ex2(fmaf(s[i], scale2, nl[r])) : 0.f;
              s[i] = pr * fmaf(dp[i], scale, nd[r]);
            }
          }
        } else {
          const int* seg = sseg + stage * kBlock;
          const int k0 = info.x;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * tq;
            const int2 ks = *reinterpret_cast<const int2*>(seg + col);
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int i = 4 * j + e4, e = e4 & 1, r = e4 >> 1;
              const bool same = (e ? ks.y : ks.x) == qseg[r];
              float pr = 0.f;
              if (qin[r] && k0 + col + e < S) {
                if (lse[r] < kFullyMasked)  // a query no key shares a segment with: uniform
                  pr = expf(s[i] * scale + (same ? 0.f : kMaskValue) - lse[r]) * inv_s;
                else if (same)
                  pr = ex2(fmaf(s[i], scale2, nl[r]));
              }
              s[i] = pr * fmaf(dp[i], scale, nd[r]);
            }
          }
        }
        uint32_t da[16];
        pack_fragments(da, s);

        // dQ += dS K over the tile's 64 keys; K is MN-major, a k-step 16
        // rows (2048 bytes) on, the next 64 columns a box on
        fence_regs<HD / 2>(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk) {
          const uint64_t dkd = desc_sw128(ktile + kk * 16 * kBoxBytes, L::kKBox);
          if constexpr (HD == 64)
            wgmma_rs_m64n64k16(dq, da + 4 * kk, dkd);
          else
            wgmma_rs_m64n128k16(dq, da + 4 * kk, dkd);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HD / 2>(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    uint16_t* dqg = static_cast<uint16_t*>(p.dq) + b * p.dq_b + h * p.dq_h + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!qin[r]) continue;
      const long long q = q0 + qrow + 8 * r;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqg + q * p.dq_s + 8 * j) =
            pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, register micro-tiles, cp.async double buffering, dQ
// summed from the dK/dV CTAs' shares
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;  // 16 (ty) x 16 (tx)

template <int HD>
struct F32Tile {
  static constexpr int kR = HD == 64 ? 8 : 4;      // rows (keys or queries) of a thread
  static constexpr int kRows = 16 * kR;            // rows of a CTA
  static constexpr int kTiles = kRows / kBlock;    // 64-row tiles of a CTA (the predicate's unit)
  static constexpr int kLd = HD + 4;               // operand row stride, floats
  static constexpr int kLdP = kRows + 4;           // P, dS row stride, floats
  static constexpr int kC = HD / 16;               // gradient columns of a thread: 4 tx + 64 c4 + e
  static constexpr int kDkvStages = HD == 64 ? 2 : 1;
  static constexpr int kDkvFloats = 2 * kRows * kLd + 2 * kDkvStages * kBlock * kLd +
                                    2 * kBlock * kLdP + 3 * kDkvStages * kBlock + kRows;
};

// acc[i][j] = sum_d a[i][d] bm[tx + 16 j][d]: the thread's R rows of ``a``
// (row stride HD + 4) against rows tx + 16 j of ``bm``, 4 columns of d a step
template <int R, int HD>
__device__ __forceinline__ void rows_by_cols(float (&acc)[R][4], const float* a, const float* bm,
                                             int tx) {
  constexpr int kLd = HD + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(bm + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + i * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_t x[t][i] y[t][cols c]: x (rows t, the thread's R
// columns contiguous, row stride ldx) by y's columns 4 tx + 64 c4 + e
// (row stride HD + 4), over ``n`` rows t
template <int R, int HD>
__device__ __forceinline__ void rank1_sum(float (&acc)[R][HD / 16], const float* x, int ldx,
                                          const float* y, int tx, int n) {
  constexpr int kLd = HD + 4, kC4 = HD / 64;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    float xv[R], yv[4 * kC4];
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(x + t * ldx + i);
      xv[i] = f.x; xv[i + 1] = f.y; xv[i + 2] = f.z; xv[i + 3] = f.w;
    }
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4) {
      const float4 f = *reinterpret_cast<const float4*>(y + t * kLd + 64 * c4 + 4 * tx);
      yv[4 * c4] = f.x; yv[4 * c4 + 1] = f.y; yv[4 * c4 + 2] = f.z; yv[4 * c4 + 3] = f.w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kC4; ++c) acc[i][c] = fmaf(xv[i], yv[c], acc[i][c]);
  }
}

// The thread's R rows x HD/16 columns of a gradient into global memory
template <int R, int HD>
__device__ __forceinline__ void store_rows(float* g, long long ld, const float (&acc)[R][HD / 16],
                                           int r0, int tx, int S) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i >= S) continue;
#pragma unroll
    for (int c4 = 0; c4 < HD / 64; ++c4)
      *reinterpret_cast<float4*>(g + (long long)(r0 + i) * ld + 64 * c4 + 4 * tx) =
          make_float4(acc[i][4 * c4], acc[i][4 * c4 + 1], acc[i][4 * c4 + 2], acc[i][4 * c4 + 3]);
  }
}

// The CTA's share of dQ for a block's 64 queries: share[q][c] = sum over
// the CTA's keys of ds[q][key] k[key][c] (keys in order), a thread's 4
// queries (ty 4 + i) x HD/16 columns (4 tx + 64 c4 + e), 4 keys a step;
// rows at or past ``rows_left`` are not stored.
template <int HD, int KEYS>
__device__ __forceinline__ void dq_share(float* share, const float* sds, const float* sk, int tx,
                                         int ty, int rows_left) {
  constexpr int kLd = HD + 4, kLdP = KEYS + 4, kC4 = HD / 64;
  float acc[4][4 * kC4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kC4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
  for (int key = 0; key < KEYS; key += 4) {
    float4 dsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dsv[i] = *reinterpret_cast<const float4*>(sds + (ty * 4 + i) * kLdP + key);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) {
        const float4 kv = *reinterpret_cast<const float4*>(sk + (key + kk) * kLd + 64 * c4 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = kk == 0 ? dsv[i].x : kk == 1 ? dsv[i].y : kk == 2 ? dsv[i].z : dsv[i].w;
          acc[i][4 * c4] = fmaf(a, kv.x, acc[i][4 * c4]);
          acc[i][4 * c4 + 1] = fmaf(a, kv.y, acc[i][4 * c4 + 1]);
          acc[i][4 * c4 + 2] = fmaf(a, kv.z, acc[i][4 * c4 + 2]);
          acc[i][4 * c4 + 3] = fmaf(a, kv.w, acc[i][4 * c4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ty * 4 + i >= rows_left) continue;
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4)
      *reinterpret_cast<float4*>(share + (ty * 4 + i) * HD + 64 * c4 + 4 * tx) =
          make_float4(acc[i][4 * c4], acc[i][4 * c4 + 1], acc[i][4 * c4 + 2], acc[i][4 * c4 + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1) flash_bwd_dkv_f32_kernel(const BwdParams p) {
  using F = F32Tile<HD>;
  constexpr int R = F::kR, kLd = F::kLd, kLdP = F::kLdP, kSt = F::kDkvStages;
  extern __shared__ float smem[];
  float* sk = smem;                       // kRows x kLd
  float* sv = sk + F::kRows * kLd;        // kRows x kLd
  float* sq = sv + F::kRows * kLd;        // kSt x 64 x kLd
  float* sdo = sq + kSt * kBlock * kLd;   // kSt x 64 x kLd
  float* sp = sdo + kSt * kBlock * kLd;   // 64 queries x kLdP: p (columns keys)
  float* sds = sp + kBlock * kLdP;        // 64 queries x kLdP: ds
  float* slse = sds + kBlock * kLdP;      // kSt x 64
  float* sdi = slse + kSt * kBlock;       // kSt x 64
  int* ssegq = reinterpret_cast<int*>(sdi + kSt * kBlock);  // kSt x 64
  int* ssegk = ssegq + kSt * kBlock;      // kRows

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * F::kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = p.S, nb = p.nb;
  const float scale = p.scale, inv_s = 1.f / (float)S;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_b + h * p.q_h;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_b + h * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_b + h * p.v_h;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_b + h * p.do_h;
  const long long row0 = ((long long)b * p.H + h) * S;
  const int2* qrange = p.qrange + (long long)b * nb;
  const int* segq = p.seg_q + (long long)b * S;
  float* dqp = p.dqp + (((long long)b * p.H + h) * gridDim.x + blockIdx.x) * S * HD;

  int2 kr[F::kTiles];
  bool kvalid[F::kTiles];
#pragma unroll
  for (int t = 0; t < F::kTiles; ++t) {
    const int kt = blockIdx.x * F::kTiles + t;
    kvalid[t] = kt * kBlock < S;
    kr[t] = kvalid[t] ? p.krange[(long long)b * nb + kt] : make_int2(0, 0);
  }
  const int mytile = ty / (16 / F::kTiles);  // the 64-key tile of this thread's keys
  auto needs = [&](int i, int t) { return kvalid[t] && pair_needed(p, qrange[i], kr[t]); };
  auto next_block = [&](int i) {
    for (; i < nb; ++i)
#pragma unroll
      for (int t = 0; t < F::kTiles; ++t)
        if (needs(i, t)) return i;
    return nb;
  };
  auto load_block = [&](int i, int st) {
    const int q0 = i * kBlock;
    load_rows<HD, kF32Threads>(sq + st * kBlock * kLd, qg, p.q_s, q0, kBlock, S);
    load_rows<HD, kF32Threads>(sdo + st * kBlock * kLd, dog, p.do_s, q0, kBlock, S);
    if (tid < kBlock) {
      const bool in = q0 + tid < S;
      const int q = in ? q0 + tid : 0;
      cp_async4(slse + st * kBlock + tid, p.lse + row0 + q, in);
      cp_async4(sdi + st * kBlock + tid, p.di + row0 + q, in);
      cp_async4(ssegq + st * kBlock + tid, segq + q, in);
    }
  };

  load_rows<HD, kF32Threads>(sk, kg, p.k_s, k0, F::kRows, S);
  load_rows<HD, kF32Threads>(sv, vg, p.v_s, k0, F::kRows, S);
  if (tid < F::kRows) ssegk[tid] = k0 + tid < S ? p.seg_kv[(long long)b * S + k0 + tid] : 0;
  int i = next_block(0);
  if (i < nb) load_block(i, 0);
  cp_async_commit();

  float dk[R][F::kC], dv[R][F::kC];  // keys ty R + r, columns 4 tx + 64 c4 + e
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < F::kC; ++c) dk[r][c] = dv[r][c] = 0.f;
  int computed = 0;

  for (int it = 0; i < nb; ++it) {
    const int st = kSt == 2 ? (it & 1) : 0;
    const int inext = next_block(i + 1);
    if (kSt == 2) {
      if (inext < nb) load_block(inext, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block i's Q, dO, lse, di, ids are in place
    const bool mine = needs(i, mytile);
    const float* q_s = sq + st * kBlock * kLd;
    const float* do_s = sdo + st * kBlock * kLd;
    if (mine) {
      ++computed;
      const int q0 = i * kBlock;
      float s[R][4], dp[R][4];  // keys ty R + r, queries tx + 16 j
      rows_by_cols<R, HD>(s, sk + ty * R * kLd, q_s, tx);
      rows_by_cols<R, HD>(dp, sv + ty * R * kLd, do_s, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tx + 16 * j;
        const float lse = slse[st * kBlock + ql], di = sdi[st * kBlock + ql];
        const int seg = ssegq[st * kBlock + ql];
        const bool qin = q0 + ql < S;
        float pr[R], ds[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int kl = ty * R + r;
          pr[r] = prob(s[r][j], scale, qin && k0 + kl < S, ssegk[kl] == seg, lse, inv_s);
          ds[r] = (dp[r][j] - di) * pr[r] * scale;
        }
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          *reinterpret_cast<float4*>(sp + ql * kLdP + ty * R + r) =
              make_float4(pr[r], pr[r + 1], pr[r + 2], pr[r + 3]);
          *reinterpret_cast<float4*>(sds + ql * kLdP + ty * R + r) =
              make_float4(ds[r], ds[r + 1], ds[r + 2], ds[r + 3]);
        }
      }
    } else {  // the other tile of the CTA needs the block: this one adds no dS to dQ
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < R; r += 4)
          *reinterpret_cast<float4*>(sds + (tx + 16 * j) * kLdP + ty * R + r) =
              make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // p and ds of the block are in place
    if (mine) {  // dV += P^T dO, dK += dS^T Q over the block's 64 queries
      rank1_sum<R, HD>(dv, sp + ty * R, kLdP, do_s, tx, kBlock);
      rank1_sum<R, HD>(dk, sds + ty * R, kLdP, q_s, tx, kBlock);
    }
    dq_share<HD, F::kRows>(dqp + (long long)i * kBlock * HD, sds, sk, tx, ty, S - i * kBlock);
    __syncthreads();  // the stage, p and ds are free
    if (kSt == 1 && inext < nb) {
      load_block(inext, 0);
      cp_async_commit();
    }
    i = inext;
  }
  cp_async_wait<0>();
  if (p.tiles != nullptr && tid % (kF32Threads / F::kTiles) == 0 && computed > 0) {
    atomicAdd(p.tiles, computed);  // the dQ products of the same pairs are formed here too
    atomicAdd(p.tiles + 1, computed);
  }
  store_rows<R, HD>(static_cast<float*>(p.dk) + b * p.dk_b + h * p.dk_h, p.dk_s, dk,
                    k0 + ty * R, tx, S);
  store_rows<R, HD>(static_cast<float*>(p.dv) + b * p.dv_b + h * p.dv_h, p.dv_s, dv,
                    k0 + ty * R, tx, S);
}

// dQ = the dK/dV CTAs' shares of a query's row summed in CTA order (a
// fixed order: the same bits every launch), each share read only where its
// CTA computed the row's block, as the predicate says.  A thread a row's 4
// columns.
template <int HD>
__global__ void __launch_bounds__(256) flash_bwd_dq_reduce_f32_kernel(const BwdParams p) {
  using F = F32Tile<HD>;
  constexpr int kC4 = HD / 4;
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long rows = (long long)p.B * p.H * p.S;
  if (t >= rows * kC4) return;
  const long long row = t / kC4;
  const int c = (int)(t % kC4) * 4;
  const int s = (int)(row % p.S), bh = (int)(row / p.S), h = bh % p.H, b = bh / p.H;
  const int nc = (p.S + F::kRows - 1) / F::kRows;
  const int2 qr = p.qrange[(long long)b * p.nb + s / kBlock];
  const int2* krange = p.krange + (long long)b * p.nb;
  const float* share = p.dqp + (long long)bh * nc * p.S * HD + (long long)s * HD + c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cta = 0; cta < nc; ++cta) {
    bool computed = false;
#pragma unroll
    for (int u = 0; u < F::kTiles; ++u) {
      const int kt = cta * F::kTiles + u;
      computed |= kt * kBlock < p.S && pair_needed(p, qr, krange[kt]);
    }
    if (!computed) continue;
    const float4 x = *reinterpret_cast<const float4*>(share + (long long)cta * p.S * HD);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<float4*>(static_cast<float*>(p.dq) + b * p.dq_b + h * p.dq_h +
                             (long long)s * p.dq_s + c) = acc;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int HD>
cudaError_t launch_bf16(const BwdParams& p, cudaStream_t stream) {
  using LK = DkvLayout<HD>;
  using LQ = DqLayout<HD>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int B = p.B, H = p.H, S = p.S;
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;  // the dK/dV pass's maps, then the dQ pass's
  if (!make_map(&kq, encode, p.q, B, H, S, HD, p.q_s, p.q_h, p.q_b, kBlock) ||
      !make_map(&kk, encode, p.k, B, H, S, HD, p.k_s, p.k_h, p.k_b, LK::kKeys) ||
      !make_map(&kv, encode, p.v, B, H, S, HD, p.v_s, p.v_h, p.v_b, LK::kKeys) ||
      !make_map(&kdo, encode, p.dout, B, H, S, HD, p.do_s, p.do_h, p.do_b, kBlock) ||
      !make_map(&qq, encode, p.q, B, H, S, HD, p.q_s, p.q_h, p.q_b, LQ::kQueries) ||
      !make_map(&qk, encode, p.k, B, H, S, HD, p.k_s, p.k_h, p.k_b, kBlock) ||
      !make_map(&qv, encode, p.v, B, H, S, HD, p.v_s, p.v_h, p.v_b, kBlock) ||
      !make_map(&qdo, encode, p.dout, B, H, S, HD, p.do_s, p.do_h, p.do_b, LQ::kQueries))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> raised_dkv{0}, raised_dq{0};
  cudaError_t err = allow_smem((const void*)flash_bwd_dkv_bf16_kernel<HD>, LK::kAlloc, raised_dkv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16_kernel<HD><<<dim3((S + LK::kKeys - 1) / LK::kKeys, H, B), kTcThreads,
                                  LK::kAlloc, stream>>>(kq, kk, kv, kdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem((const void*)flash_bwd_dq_bf16_kernel<HD>, LQ::kAlloc, raised_dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<HD><<<dim3((S + LQ::kQueries - 1) / LQ::kQueries, H, B), kTcThreads,
                                 LQ::kAlloc, stream>>>(qq, qk, qv, qdo, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const BwdParams& p, cudaStream_t stream) {
  using F = F32Tile<HD>;
  constexpr int smem = F::kDkvFloats * 4;
  static std::atomic<unsigned long long> raised{0};
  cudaError_t err = allow_smem((const void*)flash_bwd_dkv_f32_kernel<HD>, smem, raised);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_f32_kernel<HD>
      <<<dim3((p.S + F::kRows - 1) / F::kRows, p.H, p.B), kF32Threads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long threads = (long long)p.B * p.H * p.S * (HD / 4);
  flash_bwd_dq_reduce_f32_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prologue(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.S;
  const long long di_warps = (rows * (p.hd * (long long)sizeof(T) / 16) + 31) / 32;
  const long long warps = di_warps + (p.self_segments ? 1 : 2) * (long long)p.B * p.nb;
  flash_bwd_prologue_kernel<T>
      <<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(p, (int)rows, (int)di_warps);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 element strides, (batch, head, row) of q, k, v, o, do, dq, dk
// and dv in turn, each with a unit stride along hd and 16-byte aligned rows.
// lse: the forward's (B, H, S) fp32 log-sum-exp.  scratch: fp32, the di
// prologue's (B, H, S) rows rounded up to even, then 4 ints for each
// 64-row block of every batch row (the segment-id ranges of seg_q and
// seg_kv), rounded up to a multiple of 4; in fp32 then the dK/dV CTAs'
// shares of dQ, (B, H, ceil(S / 128) (hd 64) or ceil(S / 64) (hd 128), S,
// hd).  self_segments: seg_q and seg_kv are the same array, so tile
// pairs no query and key of which share a segment are skipped.  tiles:
// null, or two device ints to which the dK/dV and the dQ pass add the
// (64-query block, 64-key tile) pairs they computed, summed over heads.
// Launches the prologue, then the dK/dV and the dQ kernels on ``stream``.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* scratch, void* dq, void* dk, void* dv,
                                          const void* seg_q, const void* seg_kv,
                                          const long long* strides, int B, int H, int S, int hd,
                                          int bf16, float scale, int self_segments, void* tiles,
                                          void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 || (hd != 64 && hd != 128) ||
      (long long)B * H * S > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = (const float*)lse;
  p.di = (float*)scratch;
  p.nb = (S + kBlock - 1) / kBlock;
  const long long ranges = ((long long)B * H * S + 1) & ~1ll;  // 8-byte aligned
  p.qrange = reinterpret_cast<int2*>(p.di + ranges);
  p.krange = self_segments ? p.qrange : p.qrange + (long long)B * p.nb;
  p.dqp = p.di + ((ranges + 4ll * B * p.nb + 3) & ~3ll);  // 16-byte aligned
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.seg_q = (const int*)seg_q;
  p.seg_kv = (const int*)seg_kv;
  long long* st[24] = {&p.q_b,  &p.q_h,  &p.q_s,  &p.k_b,  &p.k_h,  &p.k_s,  &p.v_b,  &p.v_h,
                       &p.v_s,  &p.o_b,  &p.o_h,  &p.o_s,  &p.do_b, &p.do_h, &p.do_s, &p.dq_b,
                       &p.dq_h, &p.dq_s, &p.dk_b, &p.dk_h, &p.dk_s, &p.dv_b, &p.dv_h, &p.dv_s};
  for (int i = 0; i < 24; ++i) *st[i] = strides[i];
  p.B = B;
  p.H = H;
  p.S = S;
  p.hd = hd;
  p.scale = scale;
  p.self_segments = self_segments;
  p.tiles = (int*)tiles;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    err = launch_prologue<__nv_bfloat16>(p, s);
    if (err == cudaSuccess) err = hd == 64 ? launch_bf16<64>(p, s) : launch_bf16<128>(p, s);
  } else {
    err = launch_prologue<float>(p, s);
    if (err == cudaSuccess) err = hd == 64 ? launch_f32<64>(p, s) : launch_f32<128>(p, s);
  }
  return (int)err;
}
