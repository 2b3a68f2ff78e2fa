// ResNet bottleneck block for Hopper (sm_90a): the stride-1 layer1 of
// ResNet-50 (three blocks, 64 -> 256 channels, BN folded into the weights
// on the host) in one launch per block.
//
// Replaces the JAX package's ops/pallas_bottleneck.py::_layer_kernel.
// Plain version: ops/fused_bottleneck.py::fused_bottleneck_layer_reference.
//
// One launch computes, for every pixel of an NHWC bf16 image batch,
//
//   a   = bf16(relu(x . w1 + b1))                   1x1, Cin -> 64
//   hid = bf16(relu(sum_taps a[shifted] . w2 + b2)) 3x3, zero padding
//   out = bf16(relu(hid . w3 + x . wd + b3))        block 0 (Cin = 64)
//   out = bf16(relu(hid . w3 + b3 + x))             blocks 1, 2 (Cin = 256)
//
// with fp32 sums and bf16 between the convs, where the TPU kernel rounds
// (b3 already holds the downsample's bias).  The wrapper launches it
// three times a layer.
//
// Bound.  Per block at (16, 128, 128, 64) the card must at least read the
// block's input and write its 256-channel output: 33.5 + 134 MB for block
// 0, 2 x 134 MB for blocks 1 and 2, 0.70 GB a layer (0.21 ms at 3.35
// TB/s), against 0.113 ms of bf16 tensor-core work (0.132 ms with conv1
// computed on the two 64-row tiles that hold an 8 x 8 tile's halo).  So with the intermediates `a` and
// `hid` kept on chip the design is bound by bytes.  The layer in one
// launch (the TPU kernel's way) would cut the floor to the layer's own
// input and output (0.05 ms), but the 256-channel stream of a 3-block halo
// does not fit in 227 KB of shared memory at a tile that keeps the
// recompute small.
//
// Design:
// * Persistent CTAs, one per multiprocessor.  The block's weights (136 KB,
//   or 144 KB with the downsample) come into shared memory once per CTA by
//   bulk copy, from an image the host lays out in the shared-memory order
//   (128-byte swizzle).
// * Two consumer warpgroups share the weights and nothing else: each walks
//   its own output tiles of 8 x 8 pixels with its own 2-stage input ring
//   and its own `a` buffer, and syncs only with itself.  So the two drift
//   apart, and one's epilogue (the device-memory traffic) overlaps the
//   other's products.  (Two warpgroups sharing one 8 x 16 tile, synced
//   three times a tile, ran slower on the H100, despite their smaller halo
//   re-read and conv1 recompute.)
// * A producer warp per consumer warpgroup loads each tile's input with its
//   1-pixel halo, 10 x 10 pixels, by TMA in boxes of 64 channels into that
//   warpgroup's mbarrier ring.  TMA fills the part outside the image with
//   zeros, which covers the border and ragged tiles.
// * All four products run on wgmma with fp32 accumulators.  conv1 takes
//   the 100 halo pixels as two 64-row tiles straight from the TMA boxes
//   (shared A and B; the rows past 100 are dropped).  Pixels outside the
//   image are set to zero in `a` (TMA's zeros would give relu(b1) there,
//   while conv2 pads its input with zeros: the TPU kernel's mask).
// * conv2's A operand is a shifted window of `a` (rows 10 pixels apart
//   against 8 in the output), which a wgmma descriptor cannot express:
//   each warp owns two output rows of 8 pixels and gathers its rows with
//   ldmatrix (per-lane addresses) into registers for the register-A form
//   of wgmma; the next tap's fragments load while the current tap's
//   products run.  The downsample's A (the tile's centre) is read the same
//   way.  `a` and `hid` never leave shared memory (hid reuses a's space).
// * conv3 runs its N = 256 as two 128-column products in flight together;
//   the first half's epilogue overlaps the second half's products.  The
//   epilogue moves 16 bytes a lane (a quad transpose of the accumulator
//   fragment): stores to device memory and, for blocks 1 and 2, loads of
//   the residual (L2: the tile was loaded moments before), issued before
//   the products are waited for.
// * mbarrier waits trap after ~2 s instead of hanging the card.

#include "sm90.cuh"

namespace {

constexpr int kTile = 8;                                 // output pixels of a tile: 8 x 8
constexpr int kHalo = kTile + 2;                         // 10
constexpr int kHaloPix = kHalo * kHalo;                  // 100
constexpr int kCm = 64;                                  // bottleneck width
constexpr int kCout = 256;
constexpr int kRow = 128;                                // bytes: 64 bf16 channels
constexpr int kOpTile = 64 * kRow;                       // a 64-row operand tile, 8 KB
// A halo chunk: 100 rows of 128 bytes, rounded up to the 1 KB the swizzle
// repeats at.  conv1's second 64-row product reads 28 rows past the 100
// (into whatever follows); their results are dropped.
constexpr int kChunk = 13 * 1024;
constexpr int kBoxBytes = kHaloPix * kRow;               // what TMA writes of a chunk
constexpr int kStages = 2;
constexpr int kGroups = 2;                               // consumer warpgroups
constexpr int kThreads = (kGroups + 1) * 128;            // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // setmaxnreg: 65,536 a multiprocessor
constexpr int kBulk = 16384;                             // bytes a weight copy

// Byte offsets in dynamic shared memory (base 1024-aligned).  The weight
// image is copied as it is: w1 as Cin/64 tiles (64 outputs x 64 inputs),
// w2 as 9 taps (dy-major) of 64 x 64, w3 as 256 x 64, then wd as 256 x 64.
// Then each consumer warpgroup's region: two halo chunks and `a`.
template <bool kDown>
struct Smem {
  static constexpr int kCin = kDown ? 64 : 256;
  static constexpr int kChunks = kCin / 64;
  static constexpr int kW1 = 0;
  static constexpr int kW2 = kW1 + kChunks * kOpTile;
  static constexpr int kW3 = kW2 + 9 * kOpTile;
  static constexpr int kWd = kW3 + 4 * kOpTile;
  static constexpr int kWeights = kWd + (kDown ? 4 * kOpTile : 0);
  static constexpr int kGroup = (kStages + 1) * kChunk;  // stages, then a (100 rows) / hid (64)
  static constexpr int kBar = kWeights + kGroups * kGroup;  // u64: full, empty [group][stage], weights
  static constexpr int kBytes = kBar + (2 * kGroups * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};
static_assert(Smem<true>::kAlloc <= 232448 && Smem<false>::kAlloc <= 232448, "shared memory");

struct Params {
  const __nv_bfloat16* x;  // (B, H, W, Cin): the residual of blocks 1 and 2
  const uint8_t* weights;  // the shared-memory image of the block's weights
  const float* b1;         // (64)
  const float* b2;         // (64)
  const float* b3;         // (256)
  __nv_bfloat16* out;      // (B, H, W, 256)
  int H, W, tiles_x, tiles_y, tiles;
};

// D (64 x 64, fp32) += A (64 x 16, shared, K-major) . B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, shared, K-major) . B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of channels [c, c + 1] of row ``r`` in a 128-byte-swizzled
// tile of 64-channel rows (the layout TMA writes with SWIZZLE_128B).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRow + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// A fragments of one 64-channel tap (4 k-steps of 16) for this lane, from
// shared row ``p`` (the lane's row of the warp's 16; channels 8 kh on).
__device__ __forceinline__ void load_tap(uint32_t* f, uint32_t tile, int p, int kh) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(f + 4 * kk, tile + p * kRow + (((2 * kk + kh) ^ (p & 7)) << 4));
}

// Accumulator fragment of an m64nN wgmma: element 4 j + 2 r + e of this
// thread is row 16 wq + g + 8 r, column 8 j + 2 tq + e.
// conv1 epilogue of halo rows 64 mt ..: relu(acc + b1) in bf16 into `a`,
// zero outside the image.
__device__ __forceinline__ void store_a(uint8_t* a, const float* acc, int mt, const float* b1,
                                        int wq, int g, int tq, int y0, int x0, int H, int W) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = mt * 64 + 16 * wq + g + 8 * r;  // halo pixel
    if (p >= kHaloPix) continue;
    const int hy = p / kHalo, hx = p - hy * kHalo;
    const int y = y0 - 1 + hy, x = x0 - 1 + hx;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;
      const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + c));
      const uint32_t v = inside ? pack_bf16(fmaxf(acc[4 * j + 2 * r] + b.x, 0.f),
                                            fmaxf(acc[4 * j + 2 * r + 1] + b.y, 0.f))
                                : 0u;
      *reinterpret_cast<uint32_t*>(a + swz(p, c)) = v;
    }
  }
}

// 4 x 4 transpose of 32-bit words across the 4 lanes of a quad: lane t's
// x[i] becomes lane i's x[t].  It turns the accumulator's layout (lane tq
// holds channels 8 j + 2 tq, + 1 for j = 4 jg .. 4 jg + 3) into 16
// contiguous bytes a lane (lane tq holds channels 8 (4 jg + tq) .. + 7),
// and back.
__device__ __forceinline__ void quad_transpose(uint32_t* x, int tq) {
  const bool odd = tq & 1, high = tq & 2;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, odd ? x[2 * m] : x[2 * m + 1], 1);
    if (odd)
      x[2 * m] = recv;
    else
      x[2 * m + 1] = recv;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, high ? x[e] : x[2 + e], 2);
    if (high)
      x[e] = recv;
    else
      x[2 + e] = recv;
  }
}

// Where this lane's output pixel ``r`` (accumulator row 16 wq + g + 8 r:
// tile row 2 wq + r, column g) lies in an NHWC image of 256 channels, in
// elements; -1 outside the image.
__device__ __forceinline__ long long pixel_offset(const Params& p, int b, int y0, int x0, int wq,
                                                  int g, int r) {
  const int y = y0 + 2 * wq + r, x = x0 + g;
  return (y < p.H && x < p.W) ? (((long long)b * p.H + y) * p.W + x) * kCout : -1;
}

// The residual (the block's input) of one 128-channel half for this
// lane's two pixels, 16 bytes a load: issued early, used by store_out.
// Read once, so evict-first: it leaves L2 to the halo re-reads
// (k2_breakdown.py times it against __ldg).
__device__ __forceinline__ void load_residual(const Params& p, int half, int b, int y0, int x0,
                                              int wq, int g, int tq, uint4 (&res)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = pixel_offset(p, b, y0, x0, wq, g, r);
#pragma unroll
    for (int jg = 0; jg < 4; ++jg)
      res[r][jg] = off < 0 ? make_uint4(0u, 0u, 0u, 0u)
                           : __ldcs(reinterpret_cast<const uint4*>(p.x + off + 128 * half +
                                                                  8 * (4 * jg + tq)));
  }
}

// conv3 epilogue of one 128-channel half: relu(acc + b3 (+ residual)) in
// bf16 to device memory, for the pixels inside the image, 16 bytes a
// store.
template <bool kDown>
__device__ __forceinline__ void store_out(const Params& p, const float* acc,
                                          const uint4 (&res)[2][4], int half, int b, int y0,
                                          int x0, int wq, int g, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long off = pixel_offset(p, b, y0, x0, wq, g, r);
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      uint32_t w[4], rw[4] = {res[r][jg].x, res[r][jg].y, res[r][jg].z, res[r][jg].w};
      if (!kDown) quad_transpose(rw, tq);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jg + k, c = 128 * half + 8 * j + 2 * tq;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(p.b3 + c));
        float v0 = acc[4 * j + 2 * r] + bias.x, v1 = acc[4 * j + 2 * r + 1] + bias.y;
        if (!kDown) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(&rw[k]);
          v0 += __bfloat162float(rv.x);
          v1 += __bfloat162float(rv.y);
        }
        w[k] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
      quad_transpose(w, tq);
      if (off >= 0)
        *reinterpret_cast<uint4*>(p.out + off + 128 * half + 8 * (4 * jg + tq)) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Consumer warpgroup grp of a CTA (and its producer warp) walks the 8 x 8
// output tiles grp + 2 blockIdx.x, then every 2 gridDim.x on.
__device__ __forceinline__ void tile_coords(const Params& p, int t, int& b, int& y0, int& x0) {
  const int tx = t % p.tiles_x, rest = t / p.tiles_x;
  x0 = tx * kTile;
  y0 = (rest % p.tiles_y) * kTile;
  b = rest / p.tiles_y;
}

template <bool kDown>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_block_kernel(const __grid_constant__ CUtensorMap map_x, const Params p) {
  using L = Smem<kDown>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBar;  // full (group, stage), then empty, then the weights'
  const uint32_t wbar = bars + 8 * 2 * kGroups * kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < kGroups * kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kGroups * kStages + i), 4);  // the warpgroup's four warps
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int grp = (warp >> 2) < kGroups ? warp >> 2 : warp - 4 * kGroups;
  const uint32_t region = base + L::kWeights + grp * L::kGroup;
  auto full = [&](int s) { return bars + 8 * (grp * kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (kGroups * kStages + grp * kStages + s); };

  if (warp >= 4 * kGroups) {
    // ---------------- producer: warp grp feeds consumer warpgroup grp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (grp >= kGroups || lane != 0) return;
    if (grp == 0) {  // the weights, once
      mbar_expect_tx(wbar, L::kWeights);
      for (int off = 0; off < L::kWeights; off += kBulk)
        bulk_load(base + off, p.weights + off, min(kBulk, L::kWeights - off), wbar);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = kGroups * blockIdx.x + grp; t < p.tiles; t += kGroups * gridDim.x) {
      int b, y0, x0;
      tile_coords(p, t, b, y0, x0);
      for (int c = 0; c < L::kChunks; ++c) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), kBoxBytes);
        tma_load_4d(region + stage * kChunk, &map_x, full(stage), 64 * c, x0 - 1, y0 - 1, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroup grp: its tiles, end to end
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wq = warp & 3;
  const int g = lane >> 2, tq = lane & 3;                // accumulator row group, column pair
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);   // ldmatrix: this lane's row of 16
  const int lkh = lane >> 4;                             // ldmatrix: channels 8 lkh ..
  const int ly = 2 * wq + (lrow >> 3), lx = lrow & 7;    // that row's output pixel in the tile
  const int gbar = 2 + grp;                              // this warpgroup's named barrier
  const uint32_t abuf = region + kStages * kChunk;
  uint8_t* a_ptr = smem + (abuf - base);
  mbar_wait(wbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int t = kGroups * blockIdx.x + grp; t < p.tiles; t += kGroups * gridDim.x) {
    int b, y0, x0;
    tile_coords(p, t, b, y0, x0);
    const int xstage = stage;  // with the downsample, the one chunk stays to the end

    // ---- conv1 on the 100 halo pixels: rows 0..63 and 64..127
    float c1[2][32];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) c1[m][i] = 0.f;
    for (int c = 0; c < L::kChunks; ++c) {
      mbar_wait(full(stage), phase);
      const uint32_t xs = region + stage * kChunk;
      const uint32_t w1 = base + L::kW1 + c * kOpTile;
      fence_regs<32>(c1[0]);
      fence_regs<32>(c1[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wgmma_ss_n64(c1[m], desc_sw128(xs + m * kOpTile + 32 * kk, 16),
                       desc_sw128(w1 + 32 * kk, 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(c1[0]);
      fence_regs<32>(c1[1]);
      if (!kDown) {  // the chunk is done with: the producer may refill it
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage));
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    bar_sync(gbar, 128);  // the warpgroup is done with the previous tile's hid
    store_a(a_ptr, c1[0], 0, p.b1, wq, g, tq, y0, x0, p.H, p.W);
    store_a(a_ptr, c1[1], 1, p.b1, wq, g, tq, y0, x0, p.H, p.W);
    bar_sync(gbar, 128);  // all of `a` is written

    // ---- conv2: 9 taps x 4 k-steps, A gathered from `a` by ldmatrix
    float c2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) c2[i] = 0.f;
    fence_regs<32>(c2);
    uint32_t fa[2][16];
    load_tap(fa[0], abuf, ly * kHalo + lx, lkh);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t w2 = base + L::kW2 + tap * kOpTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64(c2, fa[tap & 1] + 4 * kk, desc_sw128(w2 + 32 * kk, 16));
      wgmma_commit();
      if (tap + 1 < 9) {
        const int dy = (tap + 1) / 3, dx = (tap + 1) % 3;
        wgmma_wait<1>();  // the tap before this one is done: its fragments may be refilled
        load_tap(fa[(tap + 1) & 1], abuf, (ly + dy) * kHalo + lx + dx, lkh);
      }
    }
    wgmma_wait<0>();
    fence_regs<32>(c2);
    bar_sync(gbar, 128);  // the warpgroup is done reading `a`
    // hid = relu(c2 + b2) in bf16, rows 16 wq + g (+ 8) = output pixels
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 16 * wq + g + 8 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(p.b2 + c));
        *reinterpret_cast<uint32_t*>(a_ptr + swz(m, c)) =
            pack_bf16(fmaxf(c2[4 * j + 2 * r] + bias.x, 0.f), fmaxf(c2[4 * j + 2 * r + 1] + bias.y, 0.f));
      }
    }
    fence_proxy_async();  // for wgmma's reads
    bar_sync(gbar, 128);  // hid is written

    // ---- conv3 (+ the downsample): two 128-column halves in flight
    uint32_t fx[16];
    if (kDown)  // the tile's centre pixels, from the halo chunk
      load_tap(fx, region + xstage * kChunk, (ly + 1) * kHalo + lx + 1, lkh);
    float c3[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 64; ++i) c3[h][i] = 0.f;
      fence_regs<64>(c3[h]);
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n128(c3[h], desc_sw128(abuf + 32 * kk, 16),
                      desc_sw128(base + L::kW3 + h * 2 * kOpTile + 32 * kk, 16));
        if (kDown)
          wgmma_rs_n128(c3[h], fx + 4 * kk, desc_sw128(base + L::kWd + h * 2 * kOpTile + 32 * kk, 16));
      }
      wgmma_commit();
    }
    uint4 res[2][4] = {};
    if (!kDown) load_residual(p, 0, b, y0, x0, wq, g, tq, res);
    wgmma_wait<1>();
    fence_regs<64>(c3[0]);
    store_out<kDown>(p, c3[0], res, 0, b, y0, x0, wq, g, tq);
    if (!kDown) load_residual(p, 1, b, y0, x0, wq, g, tq, res);
    wgmma_wait<0>();
    fence_regs<64>(c3[1]);
    if (kDown) {  // the products that read the centre are done: the chunk may be refilled
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(xstage));
    }
    store_out<kDown>(p, c3[1], res, 1, b, y0, x0, wq, g, tq);
  }
}

template <bool kDown>
cudaError_t launch(const CUtensorMap& map, const Params& p, int grid, cudaStream_t stream) {
  constexpr int smem = Smem<kDown>::kAlloc;
  static std::atomic<unsigned long long> raised{0};
  const cudaError_t err = allow_smem((const void*)bottleneck_block_kernel<kDown>, smem, raised);
  if (err != cudaSuccess) return err;
  bottleneck_block_kernel<kDown><<<grid, kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

}  // namespace

// One bottleneck block over a (B, H, W, cin) bf16 NHWC batch into ``out``
// (B, H, W, 256) bf16.  ``weights`` is the block's shared-memory image
// (ops/fused_bottleneck.py::_kernel_weights); b1, b2 (64) and b3 (256) are
// fp32.  downsample = 1 takes cin = 64 and the downsample product; 0 takes
// cin = 256 and the identity residual.  Any H and W.  Returns the CUDA
// error of the launch (0 = launched).
extern "C" int bottleneck_block_launch(const void* x, const void* weights, const void* b1,
                                       const void* b2, const void* b3, void* out, int B, int H,
                                       int W, int cin, int downsample, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin != (downsample ? kCm : kCout))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const long long tiles = (long long)B * tiles_y * tiles_x;
  if (tiles > 0x7fffffffLL - kGroups * 1024LL) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // x as the tensor (cin, W, H, B); boxes of 64 channels x 10 x 10 pixels
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                 (cuuint64_t)H * W * cin * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)kHalo, (cuuint32_t)kHalo, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const __nv_bfloat16*)x;
  p.weights = (const uint8_t*)weights;
  p.b1 = (const float*)b1;
  p.b2 = (const float*)b2;
  p.b3 = (const float*)b3;
  p.out = (__nv_bfloat16*)out;
  p.H = H;
  p.W = W;
  p.tiles_x = tiles_x;
  p.tiles_y = tiles_y;
  p.tiles = (int)tiles;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (tiles + kGroups - 1) / kGroups;  // a tile for each warpgroup at least
  const int grid = (int)(ctas < sms ? ctas : sms);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(downsample ? launch<true>(map, p, grid, st) : launch<false>(map, p, grid, st));
}
