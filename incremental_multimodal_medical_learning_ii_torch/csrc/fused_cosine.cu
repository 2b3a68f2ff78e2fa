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
// batch (B = 16, T = 10 or 20) a call moves ~10-20 KB, so launch latency
// is the whole cost.
//
// Design: one block per tile of 64 rows of X.  The block copies the bank
// into shared memory (T <= 256 rows, up to 128 KB; the wrapper launches a
// larger bank in chunks of 256 rows, each writing its column slice of an
// output of row stride ldo) and normalises it
// there; each warp then takes 8 rows of X, holds one row as 4 floats a
// lane, takes its norm with shuffles, and forms one fp32 FMA dot per bank
// row, reduced with shuffles.  No normalised value is written to global
// memory.  No tensor cores: TF32 would break the reference's full-fp32
// (Precision.HIGHEST) contraction.  The norm is sqrt + IEEE division, as
// the plain version computes it (x / max(sqrt(sum x^2), eps)), not rsqrt.

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 128;          // embedding width: one float4 per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxRows = 256;      // bank rows in shared memory: 128 KB (MAX_BANK_ROWS in ops/fused_cosine.py)
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
  extern __shared__ float4 bank[];  // T rows x 32 float4
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int r = warp; r < T; r += kWarps) {
    const float4 v = reinterpret_cast<const float4*>(t + (size_t)r * kDim)[lane];
    bank[r * 32 + lane] = normalise(v);
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row >= B) break;  // warp-uniform
    const float4 xn = normalise(reinterpret_cast<const float4*>(x + (size_t)row * kDim)[lane]);
    float* orow = out + (size_t)row * ldo;
    for (int r = 0; r < T; ++r) {
      const float4 b = bank[r * 32 + lane];
      float p = xn.x * b.x;
      p = fmaf(xn.y, b.y, p);
      p = fmaf(xn.z, b.z, p);
      p = fmaf(xn.w, b.w, p);
      p = warp_sum(p);
      if (lane == (r & 31)) orow[r] = p;
    }
  }
}

}  // namespace

// out[b * ldo + r] for r < T (ldo >= T).  Returns the CUDA error of the
// launch (0 = launched).
extern "C" int fused_cosine_launch(const void* x, const void* t, void* out,
                                   int B, int T, int ldo, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxRows || ldo < T) return (int)cudaErrorInvalidValue;
  const int smem = T * kDim * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cosine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_cosine_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)t, (float*)out, B, T, ldo);
  return (int)cudaGetLastError();
}
