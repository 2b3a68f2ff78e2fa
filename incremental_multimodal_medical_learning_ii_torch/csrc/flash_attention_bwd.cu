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
// Three kernels in one launch, on the caller's stream:
// * flash_bwd_di_kernel: di, one warp a row, into a (B, H, S) fp32 scratch;
// * flash_bwd_dkv_kernel: a CTA a 64-key tile, its K and V in shared
//   memory, walks every 64-query block (Q, dO, lse, di in shared memory),
//   rebuilds P and dS and accumulates dK and dV in registers;
// * flash_bwd_dq_kernel: a CTA a 64-query block walks every key tile and
//   accumulates dQ.
// Both recompute S = Q K^T and dP = dO V^T (the library does the same).
//
// Bound at BERT-base report length, (B, nh, S, hd) = (32, 12, 512, 64) in
// bf16 with ragged lengths 64-512: the call reads q, k, v, o and do and
// writes dq, dk and dv once, 201 MB (0.060 ms at 3.35 TB/s); the (query,
// key) pairs that share a segment need 2.5x the forward's operations,
// 42 GFLOP (0.042 ms at 989 TFLOP/s), so bytes bound it; in fp32 the
// operations do (0.63 ms at 67 TFLOP/s).
//
// Design: simple and right first.  Both types run on the CUDA cores in
// fp32 FMA (no TF32, no tensor cores): tiles are converted to fp32 as they
// land in shared memory, 256 threads (16 x 16) each own a 4 x 4 block of a
// 64 x 64 score tile and a 4 x hd/16 block of a gradient, as the fp32
// forward kernel does.  Every tile pair is computed: no key-tile skipping.
// Odd row strides (hd + 1, 65) keep each product's shared-memory reads free
// of bank conflicts.  The time is in the shared-memory reads of the four
// (dK/dV) and three (dQ) products: two loads for every four FMAs.
// wgmma, TMA and exact tile skipping are later work.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlock = 64;    // queries of a block, keys of a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kFullyMasked = 0.5f * kMaskValue;  // an lse below: no key shares the row's segment

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S)
  float* di;         // (B, H, S), written by the prologue
  void* dq;
  void* dk;
  void* dv;
  const int* seg_q;   // (B, S)
  const int* seg_kv;  // (B, S)
  // element strides (batch, head, row) of q, k, v, o, do, dq, dk, dv
  long long q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s, do_b, do_h, do_s, dq_b,
      dq_h, dq_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int H, S, hd;
  float scale;
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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the operand type of the library's products
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
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

// Rows [r0, r0 + 64) of a (S, HD) operand with row stride ``ld`` into
// shared memory as fp32, row stride HD + 1; rows past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int r0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    float x[kVec];
    if (r0 + r < S) {
      unpack(*reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld + c), x, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
    float* d = dst + r * (HD + 1) + c;
#pragma unroll
    for (int e = 0; e < kVec; ++e) d[e] = x[e];
  }
}

// s[i][j] = sum_d a[ty * 4 + i][d] * b[tx + 16 j][d], both with row stride HD + 1
template <int HD>
__device__ __forceinline__ void tile_product(float (&s)[4][4], const float* a, const float* b,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
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

// ---------------------------------------------------------------------------
// di = rowsum(o * do): one warp a row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_di_kernel(const BwdParams p, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = row % p.S, bh = row / p.S, h = bh % p.H, b = bh / p.H;
  const T* o = static_cast<const T*>(p.o) + b * p.o_b + h * p.o_h + (long long)s * p.o_s;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_b + h * p.do_h + (long long)s * p.do_s;
  float acc = 0.f;
  for (int c = lane; c < p.hd; c += 32) acc = fmaf(to_f<T>(o[c]), to_f<T>(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[row] = acc;
}

// ---------------------------------------------------------------------------
// dK, dV: a CTA a key tile, over every query block
// ---------------------------------------------------------------------------
template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kBlock * (HD + 1) + 2 * kBlock * (kBlock + 1) + 2 * kBlock) * 4 + 2 * kBlock * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int kLd = HD + 1, kLdP = kBlock + 1, kDj = HD / 16;
  extern __shared__ float smem[];
  float* sk = smem;                 // kBlock x kLd
  float* sv = sk + kBlock * kLd;    // kBlock x kLd
  float* sq = sv + kBlock * kLd;    // kBlock x kLd
  float* sdo = sq + kBlock * kLd;   // kBlock x kLd
  float* sp = sdo + kBlock * kLd;   // kBlock x kLdP: p (rows queries, columns keys)
  float* sds = sp + kBlock * kLdP;  // kBlock x kLdP: ds
  float* slse = sds + kBlock * kLdP;
  float* sdi = slse + kBlock;
  int* ssegq = reinterpret_cast<int*>(sdi + kBlock);
  int* ssegk = ssegq + kBlock;

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = p.S;
  const float inv_s = 1.f / (float)S;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_b + h * p.do_h;
  const long long row0 = ((long long)b * p.H + h) * S;

  load_tile<T, HD>(sk, kg, p.k_s, k0, S);
  load_tile<T, HD>(sv, vg, p.v_s, k0, S);
  if (tid < kBlock) ssegk[tid] = k0 + tid < S ? p.seg_kv[(long long)b * S + k0 + tid] : 0;

  float dk[4][kDj], dv[4][kDj];  // keys ty * 4 + i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kBlock) {
    __syncthreads();  // the previous block's products are done with sq, sdo, sp, sds
    load_tile<T, HD>(sq, qg, p.q_s, q0, S);
    load_tile<T, HD>(sdo, dog, p.do_s, q0, S);
    if (tid < kBlock) {
      const bool in = q0 + tid < S;
      slse[tid] = in ? p.lse[row0 + q0 + tid] : 0.f;
      sdi[tid] = in ? p.di[row0 + q0 + tid] : 0.f;
      ssegq[tid] = in ? p.seg_q[(long long)b * S + q0 + tid] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // queries ty * 4 + i, keys tx + 16 j
    tile_product<HD>(s, sq, sk, ty, tx);
    tile_product<HD>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float lse = slse[r], di = sdi[r];
      const int seg = ssegq[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pr = prob(s[i][j], p.scale, q0 + r < S && k0 + c < S, ssegk[c] == seg, lse,
                              inv_s);
        const float ds = (dp[i][j] - di) * pr * p.scale;
        sp[r * kLdP + c] = round_to<T>(pr);
        sds[r * kLdP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this block's 64 queries
#pragma unroll 4
    for (int r = 0; r < kBlock; ++r) {
      float pv[4], dsv[4], dov[kDj], qv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sp[r * kLdP + ty * 4 + i];
        dsv[i] = sds[r * kLdP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < kDj; ++j) {
        dov[j] = sdo[r * kLd + tx + 16 * j];
        qv[j] = sq[r * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_b + h * p.dk_h;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_b + h * p.dv_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < kDj; ++j) {
      dkg[(long long)key * p.dk_s + tx + 16 * j] = from_f<T>(dk[i][j]);
      dvg[(long long)key * p.dv_s + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a CTA a query block, over every key tile
// ---------------------------------------------------------------------------
template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kBlock * (HD + 1) + kBlock * (kBlock + 1) + 2 * kBlock) * 4 + 2 * kBlock * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kLd = HD + 1, kLdP = kBlock + 1, kDj = HD / 16;
  extern __shared__ float smem[];
  float* sq = smem;                 // kBlock x kLd
  float* sdo = sq + kBlock * kLd;   // kBlock x kLd
  float* sk = sdo + kBlock * kLd;   // kBlock x kLd
  float* sv = sk + kBlock * kLd;    // kBlock x kLd
  float* sds = sv + kBlock * kLd;   // kBlock x kLdP
  float* slse = sds + kBlock * kLdP;
  float* sdi = slse + kBlock;
  int* ssegq = reinterpret_cast<int*>(sdi + kBlock);
  int* ssegk = ssegq + kBlock;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlock;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = p.S;
  const float inv_s = 1.f / (float)S;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_b + h * p.do_h;
  const long long row0 = ((long long)b * p.H + h) * S;

  load_tile<T, HD>(sq, qg, p.q_s, q0, S);
  load_tile<T, HD>(sdo, dog, p.do_s, q0, S);
  if (tid < kBlock) {
    const bool in = q0 + tid < S;
    slse[tid] = in ? p.lse[row0 + q0 + tid] : 0.f;
    sdi[tid] = in ? p.di[row0 + q0 + tid] : 0.f;
    ssegq[tid] = in ? p.seg_q[(long long)b * S + q0 + tid] : 0;
  }

  float dq[4][kDj];  // queries ty * 4 + i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDj; ++j) dq[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBlock) {
    __syncthreads();  // the previous tile's product is done with sk, sds
    load_tile<T, HD>(sk, kg, p.k_s, k0, S);
    load_tile<T, HD>(sv, vg, p.v_s, k0, S);
    if (tid < kBlock) ssegk[tid] = k0 + tid < S ? p.seg_kv[(long long)b * S + k0 + tid] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];  // queries ty * 4 + i, keys tx + 16 j
    tile_product<HD>(s, sq, sk, ty, tx);
    tile_product<HD>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float lse = slse[r], di = sdi[r];
      const int seg = ssegq[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pr = prob(s[i][j], p.scale, q0 + r < S && k0 + c < S, ssegk[c] == seg, lse,
                              inv_s);
        sds[r * kLdP + c] = round_to<T>((dp[i][j] - di) * pr * p.scale);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float dsv[4], kv[kDj];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty * 4 + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDj; ++j) kv[j] = sk[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDj; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_b + h * p.dq_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kDj; ++j) dqg[(long long)row * p.dq_s + tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

template <typename T, int HD>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  const int rows = B * p.H * p.S;
  flash_bwd_di_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kBlock - 1) / kBlock, p.H, B);
  static std::atomic<unsigned long long> raised_dkv{0}, raised_dq{0};
  constexpr int smem_dkv = dkv_smem_bytes<HD>(), smem_dq = dq_smem_bytes<HD>();
  err = allow_smem((const void*)flash_bwd_dkv_kernel<T, HD>, smem_dkv, raised_dkv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, smem_dkv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem((const void*)flash_bwd_dq_kernel<T, HD>, smem_dq, raised_dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem_dq, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 element strides, (batch, head, row) of q, k, v, o, do, dq, dk
// and dv in turn, each with a unit stride along hd and 16-byte aligned rows.
// lse: the forward's (B, H, S) fp32 log-sum-exp; di: a (B, H, S) fp32
// scratch.  Launches the di prologue, then the dK/dV and the dQ kernels on
// ``stream``.  Returns the CUDA error of the launches (0 = launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* di, void* dq, void* dk, void* dv,
                                          const void* seg_q, const void* seg_kv,
                                          const long long* strides, int B, int H, int S, int hd,
                                          int bf16, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 || (hd != 64 && hd != 128) ||
      (long long)B * H * S > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = (const float*)lse;
  p.di = (float*)di;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.seg_q = (const int*)seg_q;
  p.seg_kv = (const int*)seg_kv;
  long long* st[24] = {&p.q_b,  &p.q_h,  &p.q_s,  &p.k_b,  &p.k_h,  &p.k_s,  &p.v_b,  &p.v_h,
                       &p.v_s,  &p.o_b,  &p.o_h,  &p.o_s,  &p.do_b, &p.do_h, &p.do_s, &p.dq_b,
                       &p.dq_h, &p.dq_s, &p.dk_b, &p.dk_h, &p.dk_s, &p.dv_b, &p.dv_h, &p.dv_s};
  for (int i = 0; i < 24; ++i) *st[i] = strides[i];
  p.H = H;
  p.S = S;
  p.hd = hd;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16)
    err = hd == 64 ? launch<__nv_bfloat16, 64>(p, B, s) : launch<__nv_bfloat16, 128>(p, B, s);
  else
    err = hd == 64 ? launch<float, 64>(p, B, s) : launch<float, 128>(p, B, s);
  return (int)err;
}
