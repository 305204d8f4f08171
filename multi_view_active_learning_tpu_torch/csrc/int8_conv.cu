// K5: the int8 conv unit of the quantized backbones -- s8 convolution with
// the activation's quantize, the folded BatchNorm, the ReLU and the residual
// add fused in.
//
// Replaces no TPU kernel: the JAX package leaves the int8 conv to XLA
// (models/quantize.py there).  The port's composition of aten calls for it
// (a cast, a divide, round, clamp, an im2col of k x k strided taps,
// torch._int_mm, an epilogue of three products, an add, a ReLU and casts;
// about 16 launches over full-size float32 and s32 tensors a conv) held 92%
// of the int8 pool sweep's device time, so this kernel was added.  That
// composition stays as its plain twin (kernels/int8_conv.py::
// int8_conv_bn_plain), which the CPU tests hold to the JAX package.
//
// Contract, bit for bit the twin's.  x is bf16 NHWC [N, H, W, Cin], sx the
// float32 per-tensor activation scale on the device (static or dynamic; the
// host never reads it), wq the s8 weights [Cout, k, k, Cin] (per-Cout scales
// ws), scale / bias the folded BN.  Then
//     q   = clip(rint(x / sx), -127, 127)           true division, __fdiv_rn
//     acc = sum over the k x k taps and Cin of q * wq   exact s32
//     y   = acc * ((sx * ws[co]) * scale[co]) + bias[co]   separate roundings
//     y   = bf16(relu?(y))                          round to nearest even
//     y   = bf16(relu(float(y) + float(residual)))  with a residual
// written as bf16 NHWC [N, Ho, Wo, Cout].  Stride 1 or 2, pads (before,
// after) on both spatial axes.
//
// Bound on an H100.  PoseResNet-50 at 256^2 does 5.34 G multiply-adds a
// crop in its 53 convs: 2.68 ms for the sweep's 496 crops at the int8 peak
// (1979 TOP/s).  The least bytes (x read once in bf16, the output written
// once in bf16, a residual read once: 71.3 MB a crop; the weights once,
// 23.5 MB) are 10.56 ms at 3.35 TB/s.  So the unit is bound by memory,
// every 1 x 1 conv and the wide early layers most, and only the 3 x 3
// convs of the two deep stages by the tensor cores; the design keeps every
// intermediate but the s8 activation out of device memory.
//
// Design:
//   * Two launches a conv.  A pre-pass quantizes x once into an s8 NHWC
//     buffer q, channels padded to 16 (a TMA stride is a multiple of 16
//     bytes) with zeros (k5_quantize_kernel).  A convolution whose Cin is
//     under 16 (the stems: 3 channels, or 12 space-to-depth'd) would waste
//     8x of each 128-byte K chunk on a tap walk, so there the pre-pass
//     gathers its k x k taps instead (k5_im2col_kernel, q [pixels, k*k*Cin
//     padded to 16]) and the product is a plain GEMM.
//   * The product (k5_wgmma_kernel) is an implicit GEMM: rows are output
//     pixels, K is taps x Cin, no im2col in device memory.  A by TMA: a 4-D
//     map over q [C, W, H, N] whose box is 128 bytes of channels x bw x
//     rows x images (128 pixels), with element strides (1, s, s, 1) so a
//     stride-2 conv reads every other pixel; tap (ky, kx) offsets the box
//     by (ky - pad, kx - pad), and TMA's zero fill outside the map is the
//     pad, the ragged pixel tile and the channel tail.  A 1 x 1 stride-1
//     conv (and the gathered stem) walks q as one row of N*H*W pixels, so
//     its tiles are full.  B by TMA: a map over the weights [Cin_pad, k*k,
//     Cout] (as quantize_state_dict stores them; no packing when Cin is a
//     multiple of 16), box 128 bytes x 1 x tile_n.  Both 128-byte
//     swizzled and K-major, as wgmma needs for s8.
//   * wgmma.mma_async m64nNk32 s32.s8.s8 with N = tile_n, 64, 128 or 256 by
//     Cout (the tile plan, kernels/int8_conv.py::conv_plan, picks it from
//     the shape): one A tile serves the whole Cout up to 256.  Two consumer
//     warpgroups (setmaxnreg 232) take 64 rows each; one producer thread
//     (its warpgroup at 40) keeps a ring of 192 KB in flight on full/empty
//     mbarriers: 4 stages at N = 256, 6 at 128, 8 at 64.  Persistent, one
//     block an SM, tiles in the order (pixel tile, Cout tile), Cout fastest,
//     so the blocks that share an A tile run side by side.
//   * Epilogue as K4's (csrc/deconv.cu): each warp stages its 16 rows x 64
//     bf16 channels in shared memory and writes whole 16-byte vectors; the
//     residual is read in the same 16-byte vectors where it is added.
//     Loading it two chunks ahead, from the tile's start, measured no
//     faster and made the 256-wide tile spill.
//   * A wait on an mbarrier that outlasts about 2^34 cycles traps.
//   * ptxas -v (sm_90a): k5_wgmma_kernel<64>, <128> and <256> each 168
//     registers at launch (the producer warpgroup drops to 40, the consumers
//     take 232), no stack, no spills; 216,192 bytes of dynamic shared memory
//     a block (the 192 KB ring, 18 KB staging, barriers, 1 KB for alignment),
//     one block an SM.  k5_quantize_kernel 34 registers; k5_im2col_kernel
//     40 (either index width); no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The plan, field for field as kernels/int8_conv.py::conv_plan lays it out
// (int64 each).  dims innermost first; strides in bytes, of dims 1-3.  The
// entry point refuses a plan of another length (int8_conv.py PLAN_LEN).
struct Plan {
  long long im2col;               // 1: the pre-pass gathers the taps (Cin < 16)
  long long n, h, w, cin;         // x
  long long ho, wo, cout;         // out
  long long k, stride, pad;       // the conv; pad before (after: the bounds)
  long long cin_a;                // channels of q
  long long gk, gstride, gpad;    // the product's taps over q
  long long gn, gh, gw;           // the product's pixel grid
  long long tile_n, kc, chunks;   // Cout tile; K chunk (128 bytes) and chunks a tap
  long long bw, rows, imgs, j_tiles, i_tiles, n_tiles, tiles;
  long long a_bytes;              // bytes of one A box in shared memory
  long long relu;
  long long a_dims[4], a_strides[3], a_box[4], a_estr[4];
  long long b_dims[4], b_strides[3], b_box[4];
};

// What the product kernel reads of the plan.
struct K5Args {
  int gk, gstride, gpad, gn, gh, gw, cout, chunks, kc;
  int bw, rows, imgs, j_tiles, i_tiles, n_tiles, tiles, relu;
  unsigned a_bytes;
};

constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileM = 128, kRowBytes = 128;
constexpr int kABytes = kTileM * kRowBytes;  // 16 KB
constexpr int kRingBytes = 192 * 1024;
constexpr int kStagingRow = kRowBytes + 16;
constexpr int kStagingBytes = 4 * kConsumers * 16 * kStagingRow;
constexpr long long kWaitCycles = 1LL << 34;

template <int kTileN>
struct Tiles {
  static constexpr int kBBytes = kTileN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kAcc = kTileN / 2;  // s32 sums a thread: 64 x kTileN over 128
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStagingBytes + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// K-major tile, 128-byte swizzle: rows of 128 bytes, 8-row groups 1024
// bytes apart; a K step inside the row adds its byte offset.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define R8(a, b, c, d, e, f, g, h) "%" #a ", %" #b ", %" #c ", %" #d ", %" #e ", %" #f ", %" #g ", %" #h
#define WGMMA_D32                                                                         \
  R8(0, 1, 2, 3, 4, 5, 6, 7) ", " R8(8, 9, 10, 11, 12, 13, 14, 15) ", "                   \
  R8(16, 17, 18, 19, 20, 21, 22, 23) ", " R8(24, 25, 26, 27, 28, 29, 30, 31)
#define WGMMA_D64                                                                         \
  WGMMA_D32 ", " R8(32, 33, 34, 35, 36, 37, 38, 39) ", " R8(40, 41, 42, 43, 44, 45, 46, 47) \
  ", " R8(48, 49, 50, 51, 52, 53, 54, 55) ", " R8(56, 57, 58, 59, 60, 61, 62, 63)
#define WGMMA_D128                                                                            \
  WGMMA_D64 ", " R8(64, 65, 66, 67, 68, 69, 70, 71) ", " R8(72, 73, 74, 75, 76, 77, 78, 79)   \
  ", " R8(80, 81, 82, 83, 84, 85, 86, 87) ", " R8(88, 89, 90, 91, 92, 93, 94, 95) ", "          \
  R8(96, 97, 98, 99, 100, 101, 102, 103) ", " R8(104, 105, 106, 107, 108, 109, 110, 111) ", " \
  R8(112, 113, 114, 115, 116, 117, 118, 119) ", " R8(120, 121, 122, 123, 124, 125, 126, 127)
#define D8(i) \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define D32(i) D8(i), D8(i + 8), D8(i + 16), D8(i + 24)

// One 64 x N x 32 s8 product of the warpgroup into s32, N = 64, 128, 256.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" WGMMA_D32 "}, %32, %33, p;\n}\n"
      : D32(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WGMMA_D64 "}, %64, %65, p;\n}\n"
      : D32(0), D32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WGMMA_D128 "}, %128, %129, p;\n}\n"
      : D32(0), D32(32), D32(64), D32(96)
      : "l"(a), "l"(b), "r"(accumulate));
}

struct TileCoord {
  int n0, i0, j0, co0;
};

// Tile t -> (pixel tile, Cout tile), Cout tile fastest
// (kernels/int8_conv.py::tile_coords).
__device__ __forceinline__ TileCoord tile_coords(const K5Args& t, int tile, int tile_n) {
  const int nt = tile % t.n_tiles;
  const int mt = tile / t.n_tiles;
  const int jb = mt % t.j_tiles;
  const int rest = mt / t.j_tiles;
  const int ib = rest % t.i_tiles;
  const int nb = rest / t.i_tiles;
  return TileCoord{nb * t.imgs, ib * t.rows, jb * t.bw, nt * tile_n};
}

__device__ __forceinline__ float unit_epilogue(int acc, float mult, float bias, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), mult), bias);
  return relu ? fmaxf(y, 0.f) : y;
}

// Two bf16 pairs (element 0 in the low half): bf16(relu(float(y) + float(r))).
__device__ __forceinline__ uint32_t add_relu_bf16x2(uint32_t y, uint32_t r) {
  const float lo = fmaxf(__fadd_rn(__uint_as_float(y << 16), __uint_as_float(r << 16)), 0.f);
  const float hi =
      fmaxf(__fadd_rn(__uint_as_float(y & 0xffff0000u), __uint_as_float(r & 0xffff0000u)), 0.f);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// The product and epilogue.  Maps: A over q, B over the s8 weights.
template <int kTileN>
__global__ void __launch_bounds__(kThreads, 1)
k5_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ sx, const float* __restrict__ ws,
                const float* __restrict__ scale, const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ residual, __nv_bfloat16* __restrict__ out,
                const __grid_constant__ K5Args t) {
  using T = Tiles<kTileN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes + kStagingBytes);
  uint64_t* empty = full + T::kStages;
  const int wg = threadIdx.x / 128;
  const int ktiles = t.gk * t.gk * t.chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
        const TileCoord c = tile_coords(t, tile, kTileN);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const int tap = kt / t.chunks;
          const int ci = (kt - tap * t.chunks) * t.kc;
          const int ky = tap / t.gk, kx = tap - (tap / t.gk) * t.gk;
          const uint32_t bar = smem_u32(&full[stage]);
          uint8_t* dst = smem + stage * T::kStageBytes;
          mbar_expect_tx(bar, t.a_bytes + T::kBBytes);
          tma_load_4d(smem_u32(dst), &map_a, bar, ci, c.j0 * t.gstride + kx - t.gpad,
                      c.i0 * t.gstride + ky - t.gpad, c.n0);
          tma_load_4d(smem_u32(dst + kABytes), &map_b, bar, ci, tap, c.co0, 0);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    uint8_t* staging = smem + T::kStages * T::kStageBytes + (wg * 4 + warp) * 16 * kStagingRow;
    const float sxv = __ldg(sx);
    const int box_pixels = t.bw * t.rows * t.imgs;
    constexpr int kCols = kRowBytes / 2;  // bf16 columns per staged chunk

    int acc[T::kAcc];
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
      const TileCoord c = tile_coords(t, tile, kTileN);
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t a = smem_u32(smem + stage * T::kStageBytes) + wg * 64 * kRowBytes;
        const uint32_t b = smem_u32(smem + stage * T::kStageBytes + kABytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_s8(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k), (kt | k) != 0);
        }
        wgmma_commit();
        fence_acc(acc);
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
        }
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));

      // The output offset (element index of channel 0) of this lane's four
      // staged rows, or -1 outside the problem.
      long long obase[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = wg * 64 + warp * 16 + (lane >> 3) + 4 * u;
        const int img = p / (t.bw * t.rows);
        const int rem = p - img * t.bw * t.rows;
        const int rr = rem / t.bw, col = rem - rr * t.bw;
        const int n = c.n0 + img, i = c.i0 + rr, j = c.j0 + col;
        const bool ok = p < box_pixels && n < t.gn && i < t.gh && j < t.gw;
        obase[u] = ok ? ((static_cast<long long>(n) * t.gh + i) * t.gw + j) * t.cout : -1;
      }

#pragma unroll
      for (int cc = 0; cc < kTileN / kCols; ++cc) {
#pragma unroll
        for (int jj = 0; jj < kCols / 8; ++jj) {
          const int j = cc * (kCols / 8) + jj;  // 8-column group of the accumulator
          const int col = jj * 8 + 2 * q;
          const int co = c.co0 + cc * kCols + col;
          float m0 = 0.f, m1 = 0.f, b0 = 0.f, b1 = 0.f;
          if (co < t.cout) {
            const float2 w = __ldg(reinterpret_cast<const float2*>(ws + co));
            const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + co));
            const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + co));
            m0 = __fmul_rn(__fmul_rn(sxv, w.x), sc.x);
            m1 = __fmul_rn(__fmul_rn(sxv, w.y), sc.y);
            b0 = bi.x;
            b1 = bi.y;
          }
          __nv_bfloat16* row0 = reinterpret_cast<__nv_bfloat16*>(staging + g * kStagingRow) + col;
          __nv_bfloat16* row8 = reinterpret_cast<__nv_bfloat16*>(staging + (g + 8) * kStagingRow) + col;
          *reinterpret_cast<__nv_bfloat162*>(row0) =
              __floats2bfloat162_rn(unit_epilogue(acc[4 * j], m0, b0, t.relu),
                                    unit_epilogue(acc[4 * j + 1], m1, b1, t.relu));
          *reinterpret_cast<__nv_bfloat162*>(row8) =
              __floats2bfloat162_rn(unit_epilogue(acc[4 * j + 2], m0, b0, t.relu),
                                    unit_epilogue(acc[4 * j + 3], m1, b1, t.relu));
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (lane >> 3) + 4 * u, vec = lane & 7;
          const int co = c.co0 + cc * kCols + vec * 8;
          if (obase[u] >= 0 && co < t.cout) {
            uint4 v = *reinterpret_cast<const uint4*>(staging + row * kStagingRow + vec * 16);
            if (residual != nullptr) {
              const uint4 r = __ldg(reinterpret_cast<const uint4*>(residual + obase[u] + co));
              v = make_uint4(add_relu_bf16x2(v.x, r.x), add_relu_bf16x2(v.y, r.y),
                             add_relu_bf16x2(v.z, r.z), add_relu_bf16x2(v.w, r.w));
            }
            *reinterpret_cast<uint4*>(out + obase[u] + co) = v;
          }
        }
        __syncwarp();
      }
    }
  }
}

// The quantize of the twin: rint(x / sx) clipped to +-127.
__device__ __forceinline__ int quant(float v, float sx) {
  return min(max(__float2int_rn(__fdiv_rn(v, sx)), -127), 127);
}
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}
__device__ __forceinline__ uint4 pack16(const int (&v)[16]) {
  return make_uint4(pack_s8(v[0], v[1], v[2], v[3]), pack_s8(v[4], v[5], v[6], v[7]),
                    pack_s8(v[8], v[9], v[10], v[11]), pack_s8(v[12], v[13], v[14], v[15]));
}

// Pre-pass: q [pixels, cin_a] s8, zeros past cin, 16 elements a thread.
// Where cin == cin_a (every conv of the backbones but the stems) x and q
// are one stream and a thread's place needs no division.  Cin is a
// multiple of 8 (16-byte loads of x).
__global__ void __launch_bounds__(256)
k5_quantize_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ sx,
                   int8_t* __restrict__ q, long long pixels, int cin, int cin_a) {
  const float s = __ldg(sx);
  const int vecs = cin_a / 16;
  const long long total = pixels * vecs;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long src = v * 16;
    int left = 16;  // channels of x in this vector
    if (cin != cin_a) {
      const long long p = v / vecs;
      const int c0 = static_cast<int>(v - p * vecs) * 16;
      src = p * cin + c0;
      left = cin - c0;
    }
    int r[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (8 * h < left) u = __ldg(reinterpret_cast<const uint4*>(x + src + 8 * h));
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[h * 8 + 2 * e] = quant(__uint_as_float(w4[e] << 16), s);
        r[h * 8 + 2 * e + 1] = quant(__uint_as_float(w4[e] & 0xffff0000u), s);
      }
    }
    *reinterpret_cast<uint4*>(q + v * 16) = pack16(r);
  }
}

// Pre-pass of a convolution with Cin under 16: q [N*Ho*Wo, cin_a], column
// (ky, kx, c) of output pixel (n, i, j) the quantized x[n, i*s + ky - pad,
// j*s + kx - pad, c], zero outside x and past k*k*Cin; 16 columns a thread.
// For one ky the columns (kx, c) are k*Cin consecutive elements of x's row
// iy, from column j*s - pad on, so a thread walks them without a division;
// the pixel's place takes 32-bit arithmetic (I) where the grid fits.
template <typename I>
__global__ void __launch_bounds__(256)
k5_im2col_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ sx,
                 int8_t* __restrict__ q, int n, int h, int w, int cin, int ho, int wo, int k,
                 int stride, int pad, int cin_a) {
  const float s = __ldg(sx);
  const I vecs = static_cast<I>(cin_a / 16);
  const int kcin = k * cin;
  const I total = static_cast<I>(n) * ho * wo * vecs;
  for (I v = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; v < total;
       v += static_cast<I>(gridDim.x) * blockDim.x) {
    const I p = v / vecs;
    const int c0 = static_cast<int>(v - p * vecs) * 16;
    const int oj = static_cast<int>(p % wo);
    const I rest = p / wo;
    const int oi = static_cast<int>(rest % ho);
    const int nn = static_cast<int>(rest / ho);
    const int ix0 = oj * stride - pad;
    const int jlo = max(0, -ix0) * cin, jhi = min(k, w - ix0) * cin;  // x's columns
    const __nv_bfloat16* img = x + static_cast<long long>(nn) * h * w * cin;
    int ky = c0 / kcin, j = c0 - ky * kcin;
    int r[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      int val = 0;
      if (ky < k) {
        const int iy = oi * stride + ky - pad;
        if (iy >= 0 && iy < h && j >= jlo && j < jhi) {
          val = quant(__bfloat162float(img[(static_cast<long long>(iy) * w + ix0) * cin + j]), s);
        }
        if (++j == kcin) {
          j = 0;
          ++ky;
        }
      }
      r[e] = val;
    }
    *reinterpret_cast<uint4*>(q + static_cast<long long>(v) * 16) = pack16(r);
  }
}

// cuTensorMapEncodeTiled through the CUDA runtime, so the library links no
// libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D s8 map with 128-byte swizzle and element strides `estr`;
// out-of-bounds elements read as zero.
bool encode_map(CUtensorMap* map, const void* base, const long long* dims, const long long* strides,
                const long long* box, const long long* estr) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t b[4], e[4];
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    e[i] = estr == nullptr ? 1u : static_cast<cuuint32_t>(estr[i]);
  }
  for (int i = 0; i < 3; ++i) st[i] = static_cast<cuuint64_t>(strides[i]);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), d, st, b, e,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <int kTileN>
cudaError_t launch_product(const CUtensorMap& map_a, const CUtensorMap& map_b, const void* sx,
                           const void* ws, const void* scale, const void* bias, const void* residual,
                           void* out, const K5Args& t, int sms, cudaStream_t st) {
  using T = Tiles<kTileN>;
  const cudaError_t e = cudaFuncSetAttribute(k5_wgmma_kernel<kTileN>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (e != cudaSuccess) return e;
  const int grid = t.tiles < sms ? t.tiles : sms;
  k5_wgmma_kernel<kTileN><<<grid, kThreads, T::kSmemBytes, st>>>(
      map_a, map_b, static_cast<const float*>(sx), static_cast<const float*>(ws),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(residual), static_cast<__nv_bfloat16*>(out), t);
  return cudaGetLastError();
}

}  // namespace

// K5.  x [n, h, w, cin] bf16, q an s8 scratch (plan.im2col: [n*ho*wo,
// cin_a]; else [n, h, w, cin_a]), wq the s8 weights as the plan's B map
// reads them, sx the float32 activation scale on the device, ws / scale /
// bias [cout] float32, residual null or bf16 [n, ho, wo, cout], out bf16
// [n, ho, wo, cout], the plan from kernels/int8_conv.py::conv_plan and its
// length in int64s.  The wrapper checks types, shapes, contiguity and
// 16-byte alignment.
extern "C" int mval_int8_conv_bn(const void* x, void* q, const void* wq, const void* sx,
                                 const void* ws, const void* scale, const void* bias,
                                 const void* residual, void* out, const long long* plan,
                                 int plan_len, void* stream) {
  if (plan_len != static_cast<int>(sizeof(Plan) / sizeof(long long))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n * p.ho * p.wo == 0) return static_cast<int>(cudaGetLastError());
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);

  // The pre-pass.
  const long long rows = p.im2col ? p.n * p.ho * p.wo : p.n * p.h * p.w;
  long long blocks = (rows * (p.cin_a / 16) + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  const float* sxp = static_cast<const float*>(sx);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  if (p.im2col) {
    const int n = static_cast<int>(p.n), h = static_cast<int>(p.h), w = static_cast<int>(p.w);
    const int cin = static_cast<int>(p.cin), ho = static_cast<int>(p.ho), wo = static_cast<int>(p.wo);
    const int k = static_cast<int>(p.k), stride = static_cast<int>(p.stride);
    const int pad = static_cast<int>(p.pad), cin_a = static_cast<int>(p.cin_a);
    if (rows * (p.cin_a / 16) + 256LL * blocks < (1LL << 32)) {  // 32-bit places
      k5_im2col_kernel<unsigned><<<static_cast<int>(blocks), 256, 0, st>>>(
          xp, sxp, qp, n, h, w, cin, ho, wo, k, stride, pad, cin_a);
    } else {
      k5_im2col_kernel<long long><<<static_cast<int>(blocks), 256, 0, st>>>(
          xp, sxp, qp, n, h, w, cin, ho, wo, k, stride, pad, cin_a);
    }
  } else {
    k5_quantize_kernel<<<static_cast<int>(blocks), 256, 0, st>>>(
        xp, sxp, qp, rows, static_cast<int>(p.cin), static_cast<int>(p.cin_a));
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // The product.
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, q, p.a_dims, p.a_strides, p.a_box, p.a_estr) ||
      !encode_map(&map_b, wq, p.b_dims, p.b_strides, p.b_box, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K5Args t;
  t.gk = static_cast<int>(p.gk);
  t.gstride = static_cast<int>(p.gstride);
  t.gpad = static_cast<int>(p.gpad);
  t.gn = static_cast<int>(p.gn);
  t.gh = static_cast<int>(p.gh);
  t.gw = static_cast<int>(p.gw);
  t.cout = static_cast<int>(p.cout);
  t.chunks = static_cast<int>(p.chunks);
  t.kc = static_cast<int>(p.kc);
  t.bw = static_cast<int>(p.bw);
  t.rows = static_cast<int>(p.rows);
  t.imgs = static_cast<int>(p.imgs);
  t.j_tiles = static_cast<int>(p.j_tiles);
  t.i_tiles = static_cast<int>(p.i_tiles);
  t.n_tiles = static_cast<int>(p.n_tiles);
  t.tiles = static_cast<int>(p.tiles);
  t.relu = static_cast<int>(p.relu);
  t.a_bytes = static_cast<unsigned>(p.a_bytes);
  switch (p.tile_n) {
    case 64:
      e = launch_product<64>(map_a, map_b, sx, ws, scale, bias, residual, out, t, sms, st);
      break;
    case 128:
      e = launch_product<128>(map_a, map_b, sx, ws, scale, bias, residual, out, t, sms, st);
      break;
    case 256:
      e = launch_product<256>(map_a, map_b, sx, ws, scale, bias, residual, out, t, sms, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
