// Fused L2-normalise + cosine similarity for Hopper (sm_90a).
//
//   out[b, r] = <x_b / max(|x_b|, 1e-8), t_r / max(|t_r|, 1e-8)>
//   x: (B, 128) float32, t: (T, 128) float32, out: (B, T) float32.
//
// Replaces the JAX package's ops/pallas_cosine.py::_cosine_kernel (the
// prompt scorer's no-grad contraction).  Plain version:
// ops/cosine.py::pairwise_cosine.
//
// Bound: bytes.  It reads B*512 + T*512 bytes and writes B*T*4; the dot
// products (2*B*T*128 flops) are far below the fp32 rate.  At the serving
// batch (B = 16, T = 10 or 20) a call moves ~10-20 KB (4e-6 ms at
// 3.35 TB/s), so the chain of dependent steps inside one block, and the
// host's launch path, are the whole cost; in the eval passes (B in the
// thousands) the blocks must fill the card.
//
// Design, latency first:
// * One warp per row of X (16 rows, 16 warps a block): the warp issues its
//   row's load before anything else, normalises it once (shuffle sum,
//   sqrt + IEEE divide, as the plain version: x / max(sqrt(sum x^2), eps),
//   not rsqrt) and keeps it in shared memory.
// * The bank is normalised once per block, one row per warp in parallel,
//   into shared memory (T <= 256 rows, up to 128 KB; the wrapper launches a
//   larger bank in chunks of 256 rows, each writing its column slice of an
//   output of row stride ldo).  Row r's 16-byte chunk c sits at chunk
//   c ^ (r & 7): the 8 lanes of one shared-memory phase read chunk c of 8
//   consecutive rows from 8 distinct bank groups, free of conflicts.
// * One lane per bank row: each lane forms its whole dot product against
//   the normalised X row (a broadcast read) with four independent partial
//   sums, then stores; no shuffle reduction per output, and the 32 lanes'
//   stores to one output row coalesce.
// * B = 16 is one block; B = 6144 is 384 blocks, about three a multiprocessor.
// * The launcher sets the shared-memory attribute only for a bank that
//   does not fit in 48 KB, once on each card.
// No tensor cores: TF32 would break the reference's full-fp32
// (Precision.HIGHEST) contraction.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kDim = 128;          // embedding width: one float4 per lane
constexpr int kChunks = kDim / 4;  // float4 chunks in a row
constexpr int kWarps = 16;         // one X row per warp
constexpr int kMaxRows = 256;      // bank rows in shared memory (MAX_BANK_ROWS in ops/fused_cosine.py)
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 normalise(float4 v) {
  float ss = v.x * v.x;
  ss = fmaf(v.y, v.y, ss);
  ss = fmaf(v.z, v.z, ss);
  ss = fmaf(v.w, v.w, ss);
  const float n = fmaxf(sqrtf(warp_sum(ss)), kEps);
  return make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
}

__global__ void __launch_bounds__(kWarps * 32)
fused_cosine_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    float* __restrict__ out, int B, int T, int ldo) {
  extern __shared__ float4 smem[];
  float4* xs = smem;                    // kWarps rows x kChunks
  float4* bank = smem + kWarps * kChunks;  // T rows x kChunks, swizzled
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;

  float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < B) xv = reinterpret_cast<const float4*>(x + (size_t)row * kDim)[lane];
  for (int r = warp; r < T; r += kWarps) {
    const float4 v = reinterpret_cast<const float4*>(t + (size_t)r * kDim)[lane];
    bank[r * kChunks + (lane ^ (r & 7))] = normalise(v);
  }
  if (row < B) xs[warp * kChunks + lane] = normalise(xv);  // warp-uniform branch
  __syncthreads();
  if (row >= B) return;

  const float4* xr = xs + warp * kChunks;
  float* orow = out + (size_t)row * ldo;
  for (int r = lane; r < T; r += 32) {
    const float4* br = bank + r * kChunks;
    const int sw = r & 7;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < kChunks; ++c) {
      const float4 a = xr[c];
      const float4 b = br[c ^ sw];
      acc.x = fmaf(a.x, b.x, acc.x);
      acc.y = fmaf(a.y, b.y, acc.y);
      acc.z = fmaf(a.z, b.z, acc.z);
      acc.w = fmaf(a.w, b.w, acc.w);
    }
    orow[r] = (acc.x + acc.y) + (acc.z + acc.w);
  }
}

}  // namespace

// out[b * ldo + r] for r < T (ldo >= T).  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int fused_cosine_launch(const void* x, const void* t, void* out,
                                   int B, int T, int ldo, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxRows || ldo < T) return (int)cudaErrorInvalidValue;
  const int smem = (kWarps + T) * kDim * (int)sizeof(float);
  if (smem > kDefaultSmem) {
    // the attribute is per device: set once on each card (a bit per device
    // ordinal; ordinals past 63 set it on every launch), to the largest bank
    static std::atomic<unsigned long long> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (bit == 0 || !(raised.load(std::memory_order_acquire) & bit)) {
      err = cudaFuncSetAttribute(fused_cosine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (kWarps + kMaxRows) * kDim * (int)sizeof(float));
      if (err != cudaSuccess) return (int)err;
      raised.fetch_or(bit, std::memory_order_release);
    }
  }
  const int grid = (B + kWarps - 1) / kWarps;
  fused_cosine_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (float*)out, B, T, ldo);
  return (int)cudaGetLastError();
}
