// Convolution as implicit GEMM on bf16 tensor cores, for Hopper (sm_90a):
// the building block of the stride-1 ResNet-50 layer1 (three bottleneck
// blocks, 64 -> 256 channels, BN folded into the weights on the host).
//
// Replaces the JAX package's ops/pallas_bottleneck.py::_layer_kernel.
// Plain version: ops/fused_bottleneck.py::fused_bottleneck_layer_reference.
//
// One launch computes, for every pixel m of an NHWC bf16 tensor and every
// output channel n,
//
//   out[m, n] = bf16(act((sum_k A0[m, k] * W0[n, k]
//                         + sum_c A1[m, c] * W1[n, c]) + bias[n] + R[m, n]))
//
// where A0 is the input seen through a 1x1 or a 3x3 window (zero padding
// at the image border, k = (dy*3 + dx)*C0 + c), the A1 term is the
// optional second 1x1 operand (block 0's downsample), R the optional bf16
// residual and act an optional ReLU.  The wrapper chains three launches
// per block: 1x1 + bias + ReLU; 3x3 + bias + ReLU; 1x1 + bias + identity
// (or + downsample) + ReLU.  This rounds where the TPU kernel rounds:
// every intermediate is bf16, every sum fp32.
//
// Bound: operations.  Layer1 is 212,992 MACs a pixel (7.0 GFLOP per 512^2
// image) against ~640 bytes a pixel of input and output, far above the
// card's ~295 flops/byte balance point.  This first version runs the
// products on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with a 2-stage
// cp.async pipeline; the intermediates go through device memory (L2 holds
// much of them).  Keeping the chain in shared memory in one launch, with
// wgmma and TMA, is later work.
//
// Tiling: a block of 4 warps computes a 128-pixel x 64-channel tile; each
// warp a 64 x 32 sub-tile (4 x 4 mma tiles).  K steps by 32.  Requires
// C0 % 32 == 0, C1 % 32 == 0 and Cout % 64 == 0; any pixel count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLds = kBK + 8;  // shared row stride in bf16 (80 B): conflict-free fragment loads
constexpr int kThreads = 128;

struct Args {
  const __nv_bfloat16* a0;  // (M, C0) NHWC
  const __nv_bfloat16* w0;  // (Cout, taps*C0)
  const __nv_bfloat16* a1;  // (M, C1) or null
  const __nv_bfloat16* w1;  // (Cout, C1) or null
  const float* bias;        // (Cout)
  const __nv_bfloat16* resid;  // (M, Cout) or null
  __nv_bfloat16* out;       // (M, Cout)
  int n, h, w, c0, c1, cout, relu;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kTaps>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const Args p) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM][kLds];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBN][kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int tq = lane & 3;  // thread in group
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;

  const int hw = p.h * p.w;
  const int M = p.n * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k0_total = kTaps * p.c0;
  const int steps0 = k0_total / kBK;
  const int steps = steps0 + (p.a1 ? p.c1 / kBK : 0);

  // This thread's A rows (4 of the tile's 128) and 16-byte chunk.
  const int a_chunk = tid & 3;
  int a_img[4], a_y[4], a_x[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_img[i] = mm / hw;
    const int rem = mm - a_img[i] * hw;
    a_y[i] = rem / p.w;
    a_x[i] = rem - a_y[i] * p.w;
  }

  auto load_stage = [&](int stage, int s) {
    if (s < steps0) {
      const int k0 = s * kBK;
      const int tap = k0 / p.c0;
      const int c = k0 - tap * p.c0 + a_chunk * 8;
      const int dy = kTaps == 9 ? tap / 3 - 1 : 0;
      const int dx = kTaps == 9 ? tap % 3 - 1 : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int yy = a_y[i] + dy, xx = a_x[i] + dx;
        const bool ok = a_ok[i] && yy >= 0 && yy < p.h && xx >= 0 && xx < p.w;
        const __nv_bfloat16* src =
            ok ? p.a0 + (((size_t)a_img[i] * p.h + yy) * p.w + xx) * p.c0 + c : p.a0;
        cp_async16(&As[stage][(tid >> 2) + 32 * i][a_chunk * 8], src, ok);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + kThreads * i;
        const int nrow = q >> 2, ch = q & 3;
        cp_async16(&Bs[stage][nrow][ch * 8],
                   p.w0 + (size_t)(n0 + nrow) * k0_total + k0 + ch * 8, true);
      }
    } else {
      const int k1 = (s - steps0) * kBK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + (tid >> 2) + 32 * i;
        const __nv_bfloat16* src = a_ok[i] ? p.a1 + (size_t)m * p.c1 + k1 + a_chunk * 8 : p.a1;
        cp_async16(&As[stage][(tid >> 2) + 32 * i][a_chunk * 8], src, a_ok[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + kThreads * i;
        const int nrow = q >> 2, ch = q & 3;
        cp_async16(&Bs[stage][nrow][ch * 8],
                   p.w1 + (size_t)(n0 + nrow) * p.c1 + k1 + ch * 8, true);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1;
    if (s + 1 < steps) {
      load_stage(stage ^ 1, s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[stage][r][kk + 2 * tq]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[stage][r + 8][kk + 2 * tq]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[stage][r][kk + 2 * tq + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[stage][r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cidx = warp_n * 32 + nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[stage][cidx][kk + 2 * tq]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[stage][cidx][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

  // Epilogue: (acc + bias) + residual, ReLU, round to bf16.
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + 2 * tq;
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + warp_m * 64 + mt * 16 + g + 8 * half;
        if (m >= M) continue;
        float v0 = acc[mt][nt][2 * half] + b0;
        float v1 = acc[mt][nt][2 * half + 1] + b1;
        const size_t off = (size_t)m * p.cout + col;
        if (p.resid) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(p.resid + off);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        __nv_bfloat162 o;
        o.x = __float2bfloat16_rn(v0);
        o.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(p.out + off) = o;
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched).  taps is 1 or 9.
extern "C" int conv_gemm_bf16_launch(const void* a0, const void* w0, int taps, int c0,
                                     const void* a1, const void* w1, int c1,
                                     const void* bias, const void* resid, void* out,
                                     int n, int h, int w, int cout, int relu, void* stream) {
  if ((taps != 1 && taps != 9) || c0 <= 0 || c0 % kBK || cout <= 0 || cout % kBN ||
      (a1 && (c1 <= 0 || c1 % kBK)) || n <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a0 = (const __nv_bfloat16*)a0;
  p.w0 = (const __nv_bfloat16*)w0;
  p.a1 = (const __nv_bfloat16*)a1;
  p.w1 = (const __nv_bfloat16*)w1;
  p.bias = (const float*)bias;
  p.resid = (const __nv_bfloat16*)resid;
  p.out = (__nv_bfloat16*)out;
  p.n = n; p.h = h; p.w = w; p.c0 = c0; p.c1 = a1 ? c1 : 0; p.cout = cout; p.relu = relu;
  const long long M = (long long)n * h * w;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)(cout / kBN));
  if (taps == 9)
    conv_gemm_kernel<9><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    conv_gemm_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
