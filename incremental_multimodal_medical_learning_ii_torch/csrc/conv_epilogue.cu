// One pass over a convolution's output for Hopper (sm_90a): frozen batch
// norm, an optional residual and an optional ReLU, in place.
//
//   a[p, c] = act(a[p, c] * sa[c] + b[c] (+ r[p, c] | + r[p, c] * sr[c]))
//   a, r: (P, C) bf16, the rows of channels_last (N, C, H, W) tensors;
//   sa, sr, b: (C,) float32.  act is ReLU or the identity.
//
// Replaces no TPU kernel: XLA fuses a conv's batch norm, residual add and
// ReLU into the conv on the TPU, while PyTorch runs them after cuDNN's
// conv as 3 to 5 separate passes over device memory.  This is the port's
// own epilogue for the ResNet trunk (models/resnet.py::bn_epilogue).  Plain
// version: ops/conv_epilogue.py::conv_epilogue_reference, which it equals
// bit for bit: each product and sum is one float32 rounding in the same
// order (__fmul_rn / __fadd_rn, never contracted into an fma), and the
// result is rounded once to bf16, to nearest even.
//
// Bound: bytes.  It reads a (and r) and writes a, 2 bytes a value each way;
// 2 or 4 flops a value are far below any rate of the card.  At batch 512
// and 512^2 the stem's and layer1's outputs are 2.1 G values (4.3 GB):
// 2.6 ms (3.9 ms with a residual) at 3.35 TB/s.
//
// Design:
// * 16-byte accesses, 8 bf16 channels a thread (every C in the trunk,
//   64-2048, is a multiple of 8).  A block of 256 threads covers
//   256 / (C / 8) whole rows a step, each thread at a fixed group of 8
//   channels, so a step's loads are one contiguous run of memory and each
//   thread keeps its channels' scale, shift (and residual scale) in
//   registers for the whole launch: C <= 2048.
// * A persistent grid: 3 blocks a multiprocessor at most (85 registers a
//   thread, none spilled), each striding over the rows; 4 steps' loads (2
//   with a residual, whose values and scales take twice the registers) are
//   issued before any store, so each thread keeps 64 bytes in flight.
// * Written in place: a's memory is read and rewritten by the same thread,
//   nothing else touches it during the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                        // bf16 values in a 16-byte access
constexpr int kMaxChannels = kThreads * kVec;  // MAX_CHANNELS in ops/conv_epilogue.py
constexpr int kBlocksPerSm = 3;

enum Residual { kNone = 0, kIdentity = 1, kScaled = 2 };

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

template <int kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
conv_epilogue_kernel(__nv_bfloat16* a, const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ sa, const float* __restrict__ sr,
                     const float* __restrict__ b, long long rows, int c) {
  constexpr int kUnroll = kRes == kNone ? 4 : 2;  // steps whose loads are in flight together
  const int vpr = c / kVec;         // 16-byte groups in a row
  const int rpi = kThreads / vpr;   // rows a block covers in one step
  const int tr = threadIdx.x / vpr;
  if (tr >= rpi) return;            // the last threads when vpr does not divide 256
  const int c0 = (threadIdx.x - tr * vpr) * kVec;

  float scale[kVec], shift[kVec], rscale[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    scale[j] = sa[c0 + j];
    shift[j] = b[c0 + j];
    rscale[j] = kRes == kScaled ? sr[c0 + j] : 1.f;
  }

  const long long step = (long long)gridDim.x * rpi;
  for (long long row = (long long)blockIdx.x * rpi + tr; row < rows; row += kUnroll * step) {
    uint4 va[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = row + u * step;
      if (ru < rows) {
        const size_t off = (size_t)ru * c + c0;
        va[u] = *reinterpret_cast<const uint4*>(a + off);
        if (kRes != kNone) vr[u] = __ldg(reinterpret_cast<const uint4*>(r + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = row + u * step;
      if (ru >= rows) continue;
      float x[kVec], y[kVec];
      unpack(va[u], x);
      if (kRes != kNone) unpack(vr[u], y);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = __fadd_rn(__fmul_rn(x[j], scale[j]), shift[j]);
        if (kRes == kIdentity) v = __fadd_rn(v, y[j]);
        if (kRes == kScaled) v = __fadd_rn(v, __fmul_rn(y[j], rscale[j]));
        if (kRelu) v = v < 0.f ? 0.f : v;  // a NaN passes, as torch.relu's does
        x[j] = v;
      }
      *reinterpret_cast<uint4*>(a + (size_t)ru * c + c0) = pack(x);
    }
  }
}

template <int kRes>
void launch(int grid, cudaStream_t stream, bool relu, __nv_bfloat16* a, const __nv_bfloat16* r,
            const float* sa, const float* sr, const float* b, long long rows, int c) {
  if (relu) {
    conv_epilogue_kernel<kRes, true><<<grid, kThreads, 0, stream>>>(a, r, sa, sr, b, rows, c);
  } else {
    conv_epilogue_kernel<kRes, false><<<grid, kThreads, 0, stream>>>(a, r, sa, sr, b, rows, c);
  }
}

}  // namespace

// a: (rows, c) bf16, rewritten in place; r: (rows, c) bf16 or null; sr
// null for an identity residual (and when r is null); sa, b: (c,) float32.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int conv_epilogue_launch(void* a, const void* r, const void* sa, const void* sr,
                                    const void* b, long long rows, int c, int relu,
                                    void* stream) {
  if (rows < 0 || c <= 0 || c % kVec != 0 || c > kMaxChannels || (sr != nullptr && r == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int rpi = kThreads / (c / kVec);
  const long long groups = (rows + rpi - 1) / rpi;
  const long long cap = (long long)sms * kBlocksPerSm;
  const int grid = (int)(groups < cap ? groups : cap);
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* pa = (__nv_bfloat16*)a;
  const __nv_bfloat16* pr = (const __nv_bfloat16*)r;
  const float *psa = (const float*)sa, *psr = (const float*)sr, *pb = (const float*)b;
  if (r == nullptr) {
    launch<kNone>(grid, s, relu != 0, pa, pr, psa, psr, pb, rows, c);
  } else if (sr == nullptr) {
    launch<kIdentity>(grid, s, relu != 0, pa, pr, psa, psr, pb, rows, c);
  } else {
    launch<kScaled>(grid, s, relu != 0, pa, pr, psa, psr, pb, rows, c);
  }
  return (int)cudaGetLastError();
}
