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
// (jax.experimental.pallas.ops.tpu.flash_attention).  Plain version:
// ops/flash_attention.py::mha_reference.  It rounds where the TPU kernel
// rounds: logits are the fp32 dot, then scaled (never a pre-scaled bf16 q);
// a masked logit is s + mask_value (finite, so a query that matches no key
// averages all of them, as on the TPU); p = exp(s - m) is rounded to v's
// dtype before p.v, which sums in fp32; the row sum l sums the unrounded
// p; a row with l == 0 is left at zero.  Normalisation is deferred to the
// end instead of applied at every key tile (an fp32 rounding difference).
//
// Bound: at BERT-base report length (B, nh, S, hd) = (32, 12, 512, 64) the
// call moves 100.7 MB in bf16 (0.030 ms at 3.35 TB/s) and does
// 4*B*nh*S^2*hd = 25.8 GFLOP (0.026 ms at 989 TFLOP/s): bytes and
// operations meet near the card's ridge.  In fp32 the operations bound it
// (0.385 ms at 67 TFLOP/s).
//
// Design (a simple first version): one block per (64-query tile, head,
// batch), looping over 64-key tiles that it copies into shared memory.
// bf16: 4 warps of 16 query rows; Q stays in registers as mma.sync
// m16n8k16 A fragments, S = Q K^T and O += P V run on the tensor cores
// with fp32 accumulators, the S accumulators become P's A fragments
// without a trip through shared memory, and the row max and sum live in
// registers (a quad of lanes shares a row).  Shared rows are padded by 16
// bytes so the fragment loads are free of bank conflicts.  fp32: 16 x 16
// threads, each a 4 x 4 tile of S and a 4 x hd/16 tile of O, fp32 FMA on
// the CUDA cores (no TF32: the parity default is fp32 at HIGHEST); Q, K,
// V and P in shared memory.  Neither overlaps its loads with its math
// (one stage); a cp.async/TMA pipeline and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
// DEFAULT_MASK_VALUE of the TPU kernel, rounded to float as it enters the sum
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

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
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(lo);
  v.y = __float2bfloat16_rn(hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(const Params p) {
  constexpr int kLd = HD + 8;        // shared row stride in bf16 (16 bytes of padding)
  constexpr int kSteps = HD / 16;    // k-steps of Q K^T over hd
  constexpr int kDTiles = HD / 8;    // n-tiles of P V over hd
  constexpr int kChunks = HD / 8;    // 16-byte chunks in a row
  __shared__ __align__(16) uint16_t sk[kBlockK * kLd];
  __shared__ __align__(16) uint16_t sv[kBlockK * kLd];
  __shared__ int sseg[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma group and thread in group
  const int S = p.S;
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const uint16_t* qg = static_cast<const uint16_t*>(p.q) + b * p.q_b + h * p.q_h;
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) + b * p.k_b + h * p.k_h;
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) + b * p.v_b + h * p.v_h;
  const int* segkv = p.seg_kv + (long long)b * S;

  // Q as A fragments: a0 (row g, cols 2tq..), a1 (row g+8), a2 / a3 the same 8 columns on.
  uint32_t qa[kSteps][4];
  int qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < S;
    qseg[r] = ok ? p.seg_q[(long long)b * S + row] : 0;
    const uint16_t* src = qg + (long long)(ok ? row : 0) * p.q_s + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      qa[ks][r] = ok ? *reinterpret_cast<const uint32_t*>(src + ks * 16) : 0u;
      qa[ks][2 + r] = ok ? *reinterpret_cast<const uint32_t*>(src + ks * 16 + 8) : 0u;
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * kChunks; i += 128) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kg + (long long)(k0 + r) * p.k_s + c);
        vv = *reinterpret_cast<const uint4*>(vg + (long long)(k0 + r) * p.v_s + c);
      }
      *reinterpret_cast<uint4*>(sk + r * kLd + c) = kv;
      *reinterpret_cast<uint4*>(sv + r * kLd + c) = vv;
    }
    if (tid < kBlockK) sseg[tid] = k0 + tid < S ? segkv[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const uint16_t* kr = sk + (nt * 8 + g) * kLd + 2 * tq;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        mma_bf16(s[nt], qa[ks], b0, b1);
      }
    }

    // Scale, mask, and the new row max (c0, c1 are row g; c2, c3 row g + 8).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = nt * 8 + 2 * tq + (e & 1);
        float x = -INFINITY;  // past S: out of the softmax
        if (k0 + col < S) {
          x = s[nt][e] * p.scale;
          x = x + (sseg[col] == qseg[r] ? 0.f : kMaskValue);
        }
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
      m[r] = mx[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pv;
        rsum[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = rsum[r] + alpha[r] * l[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];

    // O += P V: P (bf16) from the S accumulators, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vr = sv + (kk * 16 + 2 * tq) * kLd + g;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const uint16_t* c = vr + dt * 8;
        const uint32_t b0 = (uint32_t)c[0] | ((uint32_t)c[kLd] << 16);
        const uint32_t b1 = (uint32_t)c[8 * kLd] | ((uint32_t)c[9 * kLd] << 16);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

  uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = l[r] == 0.f ? 1.f : 1.f / l[r];
    uint16_t* dst = og + (long long)row * p.o_s + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
  }
}

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

template <int HD>
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<HD><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) of q, k, v and o in turn.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* seg_q, const void* seg_kv,
                                      const long long* strides, int B, int H, int S, int hd,
                                      int bf16, float scale, void* stream) {
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
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    if (hd == 64)
      flash_fwd_bf16_kernel<64><<<grid, 128, 0, st>>>(p);
    else
      flash_fwd_bf16_kernel<128><<<grid, 128, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  return (int)(hd == 64 ? launch_f32<64>(p, grid, st) : launch_f32<128>(p, grid, st));
}
