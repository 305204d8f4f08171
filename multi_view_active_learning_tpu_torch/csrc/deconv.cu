// K3 and K4: fused ConvTranspose(k4, s2, p1) + folded BatchNorm + ReLU.
//
// Replace the TPU kernels ops/pallas/deconv.py::fused_deconv_bn_relu (K3,
// _deconv_kernel) and ::fused_deconv_bn_relu_int8 (K4, _deconv_kernel_int8)
// of the JAX package: the PoseResNet deconv head, inference only.
//
// Contract.  x is NHWC [N, H, W, Cin]; the output is NHWC [N, 2H, 2W, Cout]
// in x's type.  Per spatial dim, output o = 2m + r (phase r in {0, 1}) is a
// sum over two taps a in {0, 1} of the input padded by one,
//     y[2m + r] = sum_a Xp[m + r + a] * W[3 - 2a - r]        (torch layout)
// so each of the four output phases (r, s) is a dense GEMM of its input
// pixels [N*H*W, 4 taps x Cin] against [4 taps x Cin, Cout].  The weights
// are packed once per load (kernels/deconv.py::pack_weight) as
// [4 phases][Cout][4 taps][Cin_pad], K contiguous, Cin zero-padded to a
// multiple of 16.  The epilogue is
//     out = relu(acc * mult[co] + bias[co])   rounded once to x's type,
// applied to the f32 (K3) or s32 (K4) accumulator with __fmul_rn/__fadd_rn,
// the plain version's separate multiply and add, so K4 is bit-exact.
//   * K3: mult = folded BN scale; bf16 operands, f32 accumulation; float32
//     activations run deconv_f32_kernel on the CUDA cores (off the scoring
//     path).
//   * K4: a pre-pass (deconv_quantize_kernel) quantizes x once,
//     q = clip(rint(x * inv_sx), -127, 127) with inv_sx = 1 / max(sx, 1e-8)
//     formed from the device scalar sx, into an s8 NHWC buffer whose
//     channels are padded to 16 (a TMA stride is a multiple of 16 bytes);
//     s8 x s8 -> s32 is exact; mult = (max(sx, 1e-8) * ws[co]) * bn_scale[co]
//     is formed in the epilogue in the plain version's order, so neither a
//     static nor a dynamic scale costs a launch or a host sync per call.
//     The pre-pass was chosen over quantizing in a producer warpgroup: it
//     takes bf16 and float32 x alike, meets the stride rule at Cin = 72, and
//     costs one read of x and one write of q (0.17 GB over the three layers
//     at bench width, beside the 0.47 GB of K4's own input, weights and
//     output).
//
// Bound on an H100.  Operations: 16 * N*H*W * Cin * Cout multiply-adds.  At
// the scoring width (124 crops of 256^2, PoseResNet-50) the three layers do
// 2.33e11 MACs: 0.47 ms at the bf16 dense peak (989 TFLOP/s), 0.24 ms at
// the int8 peak (1979 TOP/s).  Second constraint, the bytes: layer 3's
// output ([124, 64, 64, 256] bf16, 0.26 GB) alone is 0.078 ms at 3.35 TB/s,
// 29% of K3's and 58% of K4's operations bound for that layer, so its store
// has to overlap the products.
//
// Design (one kernel template for both, deconv_wgmma_kernel):
//   * Tile: 128 pixels of one phase x 256 output channels, so each A tile is
//     read once for the whole Cout (Cout > 256 takes more N tiles; Cout < 256
//     leaves zero-filled weight rows whose columns are not stored).  A 128-
//     pixel tile is a box of whole rows: 2 images x 8 rows at 8x8, 8 rows at
//     16x16, 4 rows at 32x32, 3 images x 5 rows at 5x7 (105 pixels; the rest
//     of the tile is masked), 128 columns of one row when W >= 128.
//   * A by TMA: a 4-D tensor map over x (or q) [C, W, H, N], box {128 bytes
//     of channels, bw, rows, images}.  Tap (a, b) of phase (r, s) offsets the
//     box by (r + a - 1, s + b - 1); TMA fills out-of-bounds with zeros, which
//     is the pad of 1, the ragged pixel tile, and the Cin tail (Cin = 72,
//     640).  B by TMA: a 4-D map over the packed weights [Cin_pad, 4, Cout,
//     4], box {128 bytes, 1, 256, 1}.  Both with 128-byte swizzle, both
//     K-major, as wgmma needs for s8.  The tiling plan (maps, boxes, tap
//     offsets, tile counts) is computed in Python (kernels/deconv.py::
//     tile_plan), where the CPU tests emulate the tile walk from it.
//   * Warp specialization: two consumer warpgroups (setmaxnreg 232) each run
//     wgmma.mma_async m64n256k16 (bf16 -> f32) or m64n256k32 (s8 -> s32) on
//     64 of the 128 rows, 128 accumulator registers a thread, one commit
//     group in flight; one producer thread (its warpgroup at setmaxnreg 40)
//     keeps a ring of 4 stages of 48 KB (A 16 KB + B 32 KB) in flight on
//     full/empty mbarriers.  This replaces mma.sync + ldmatrix (which cannot
//     reach Hopper's full tensor-core rate) and K4's register staging.
//   * Persistent: one block per SM walks tiles blockIdx.x, + gridDim.x, ...
//     in the order (pixel tile, phase, Cout tile), so the four phases of a
//     pixel tile run side by side and share their A bytes in L2.  The
//     producer runs ahead across tiles, so the next tile's loads are in
//     flight while the consumers store this one.  Waves at bench width (132
//     SMs): 248 tiles (1.9 waves, 94% of the last wave busy), 992, 3968;
//     layer 1's 128-deep K makes each tile long, and its 6% tail is left as
//     it is (no split-K: a second pass over a [4, M, 256] f32 scratch would
//     cost more than the tail).
//   * Epilogue: each warp converts its 16 x 256 accumulators a 128-byte
//     column chunk at a time into a padded staging tile in shared memory,
//     then writes whole 16-byte vectors, eight lanes per output pixel row:
//     coalesced, where the old kernel wrote 4-byte pairs.  The epilogue of a
//     tile does not overlap the next tile's products: at layer 3 it costs
//     about twice the output's bytes at the HBM rate
//     (tools/deconv_breakdown.py builds the kernel with -DDECONV_NO_MMA and
//     -DDECONV_LOADS_ONLY to time it without its products and epilogue).
//     Three ways to overlap it measured slower on the card and were not
//     kept: the producer warpgroup's idle warps storing a staged tile (a
//     full 64 KB tile leaves room for 3 ring stages only; two 16 KB passes
//     make the consumers wait on those warps), and TMA stores of staged
//     passes through a 5-D map over the output (the consumers spilled).
//   * A wait on an mbarrier that outlasts about 2^34 cycles traps, so a
//     fault in the pipeline ends the launch with an error, not a hung card.
//   * ptxas -v (sm_90a): deconv_wgmma_kernel 168 registers at launch (the
//     producer warpgroup drops to 40, the consumers take 232), no stack, no
//     spills; 216,128 bytes of dynamic shared memory a block (4 x 48 KB
//     ring, 18 KB staging, barriers, 1 KB for alignment), one block an SM.
//     deconv_quantize_kernel 30 registers; deconv_f32_kernel 63 registers,
//     8,704 bytes of shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The tiling plan, field for field as kernels/deconv.py::tile_plan lays it
// out (int64 each).  dims are innermost first; strides in bytes, of dims 1-3.
// The entry points refuse a plan of another length (kernels/deconv.py
// PLAN_LEN).
struct Plan {
  long long n, h, w, cin, cout, cin_a, kc, chunks;
  long long bw, rows, imgs, j_tiles, i_tiles, n_tiles, tiles;
  long long a_dims[4], a_strides[3], a_box[4];
  long long b_dims[4], b_strides[3], b_box[4];
  long long tap_dy[16], tap_dx[16];  // index phase * 4 + tap
};

// What the kernel reads of the plan.
struct TileArgs {
  int n, h, w, cout, chunks, kc, bw, rows, imgs, j_tiles, i_tiles, n_tiles, tiles;
  unsigned a_bytes;  // bytes of one A box
  signed char dy[16], dx[16];
};

constexpr int kConsumers = 2;                    // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;  // and one producer warpgroup
constexpr int kTileM = 128, kTileN = 256, kRowBytes = 128;
constexpr int kStages = 4;
constexpr int kABytes = kTileM * kRowBytes;  // 16 KB
constexpr int kBBytes = kTileN * kRowBytes;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStagingRow = kRowBytes + 16;  // padded: pair writes free of bank conflicts
constexpr int kStagingBytes = 4 * kConsumers * 16 * kStagingRow;  // 16 rows per consumer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kStagingBytes + 2 * kStages * 8;
constexpr long long kWaitCycles = 1LL << 34;
constexpr int kCinAlign = 16;  // kernels/deconv.py CIN_ALIGN

struct TileCoord {
  int phase, n0, i0, j0, co0;
};

// Tile t -> (pixel tile, phase, Cout tile), Cout tile fastest
// (kernels/deconv.py::tile_coords).
__device__ __forceinline__ TileCoord tile_coords(const TileArgs& t, int tile) {
  const int nt = tile % t.n_tiles;
  const int q = tile / t.n_tiles;
  const int mt = q >> 2;
  const int jb = mt % t.j_tiles;
  const int rest = mt / t.j_tiles;
  const int ib = rest % t.i_tiles;
  const int nb = rest / t.i_tiles;
  return TileCoord{q & 3, nb * t.imgs, ib * t.rows, jb * t.bw, nt * kTileN};
}

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
// Wait for the phase of `bar` with this parity; trap after kWaitCycles.
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

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.  The
// tile base is 1024-byte aligned; a K step inside the 128-byte row adds its
// byte offset to the start address.
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

// Keep the compiler from moving accumulator uses across the asynchronous
// products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WGMMA_D128                                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "           \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "           \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127"
#define D8(c, i) \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define D128(c)                                                                                   \
  D8(c, 0), D8(c, 8), D8(c, 16), D8(c, 24), D8(c, 32), D8(c, 40), D8(c, 48), D8(c, 56), D8(c, 64), \
      D8(c, 72), D8(c, 80), D8(c, 88), D8(c, 96), D8(c, 104), D8(c, 112), D8(c, 120)

// One 64 x 256 x 32-byte product of the warpgroup: bf16 (k16) into f32.
__device__ __forceinline__ void wgmma_k32b(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WGMMA_D128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : D128("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}
// s8 (k32) into s32.
__device__ __forceinline__ void wgmma_k32b(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WGMMA_D128 "}, %128, %129, p;\n}\n"
      : D128("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

__device__ __forceinline__ float epilogue(float acc, float mult, float bias) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, mult), bias), 0.f);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// K3 (kInt8 = false: bf16 operands from x) and K4 (kInt8 = true: s8
// operands from the pre-pass's q), output in Tout.  Maps: A over x or q,
// B over the packed weights.  K4 reads sx and ws for its multiplier.
template <bool kInt8, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
deconv_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sx,
                    const float* __restrict__ ws, const float* __restrict__ scale,
                    const float* __restrict__ bias, Tout* __restrict__ out,
                    const __grid_constant__ TileArgs t) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kStagingBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int ktiles = 4 * t.chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
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
        const TileCoord c = tile_coords(t, tile);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const int tap = kt / t.chunks;
          const int ci = (kt - tap * t.chunks) * t.kc;
          const int k = c.phase * 4 + tap;
          const uint32_t bar = smem_u32(&full[stage]);
          uint8_t* dst = smem + stage * kStageBytes;
          mbar_expect_tx(bar, t.a_bytes + kBBytes);
          tma_load_4d(smem_u32(dst), &map_a, bar, ci, c.j0 + t.dx[k], c.i0 + t.dy[k], c.n0);
          tma_load_4d(smem_u32(dst + kABytes), &map_b, bar, ci, tap, c.co0, c.phase);
          if (++stage == kStages) {
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
    uint8_t* staging = smem + kStages * kStageBytes + (wg * 4 + warp) * 16 * kStagingRow;
    const float sxc = kInt8 ? fmaxf(__ldg(sx), 1e-8f) : 0.f;
    const int box_pixels = t.bw * t.rows * t.imgs;
    constexpr int kCols = kRowBytes / static_cast<int>(sizeof(Tout));  // columns per staged chunk
    constexpr int kVec = 16 / static_cast<int>(sizeof(Tout));          // columns per 16-byte vector

    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = Acc(0);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
      const TileCoord c = tile_coords(t, tile);
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint32_t a = smem_u32(smem + stage * kStageBytes) + wg * 64 * kRowBytes;
        const uint32_t b = smem_u32(smem + stage * kStageBytes + kABytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#ifndef DECONV_NO_MMA  // tools/deconv_breakdown.py: the kernel without its products
          wgmma_k32b(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k), (kt | k) != 0);
#endif
        }
        wgmma_commit();
        fence_acc(acc);
        if (kt > 0) {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if ((threadIdx.x & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
#ifdef DECONV_LOADS_ONLY  // and without its epilogue: the rate the ring is fed at
      continue;
#endif

      // Where this lane's four staged rows go: the output offset of the
      // pixel (element index of channel 0), or -1 outside the problem.
      const int pr = c.phase >> 1, ps = c.phase & 1;
      long long obase[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = wg * 64 + warp * 16 + (lane >> 3) + 4 * u;
        const int img = p / (t.bw * t.rows);
        const int rem = p - img * t.bw * t.rows;
        const int rr = rem / t.bw, col = rem - rr * t.bw;
        const int n = c.n0 + img, i = c.i0 + rr, j = c.j0 + col;
        const bool ok = p < box_pixels && n < t.n && i < t.h && j < t.w;
        obase[u] = ok ? (static_cast<long long>(n * 2 * t.h + 2 * i + pr) * (2 * t.w) + 2 * j + ps) *
                            t.cout
                      : -1;
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
            const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + co));
            const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + co));
            if (kInt8) {
              const float2 w = __ldg(reinterpret_cast<const float2*>(ws + co));
              m0 = __fmul_rn(__fmul_rn(sxc, w.x), sc.x);
              m1 = __fmul_rn(__fmul_rn(sxc, w.y), sc.y);
            } else {
              m0 = sc.x;
              m1 = sc.y;
            }
            b0 = bi.x;
            b1 = bi.y;
          }
          Tout* row0 = reinterpret_cast<Tout*>(staging + g * kStagingRow) + col;
          Tout* row8 = reinterpret_cast<Tout*>(staging + (g + 8) * kStagingRow) + col;
          store_pair(row0, epilogue(to_float(acc[4 * j]), m0, b0),
                     epilogue(to_float(acc[4 * j + 1]), m1, b1));
          store_pair(row8, epilogue(to_float(acc[4 * j + 2]), m0, b0),
                     epilogue(to_float(acc[4 * j + 3]), m1, b1));
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (lane >> 3) + 4 * u, vec = lane & 7;
          const int co = c.co0 + cc * kCols + vec * kVec;
          if (obase[u] >= 0 && co < t.cout) {
            *reinterpret_cast<uint4*>(out + obase[u] + co) =
                *reinterpret_cast<const uint4*>(staging + row * kStagingRow + vec * 16);
          }
        }
        __syncwarp();
      }
    }
  }
}

// K4's pre-pass: q = clip(rint(x * inv_sx), -127, 127) into s8 NHWC with
// cin_a (a multiple of 16) channels, zeros past cin; 16 channels a thread.
__device__ __forceinline__ int quant(float v, float inv) {
  return min(max(__float2int_rn(__fmul_rn(v, inv)), -127), 127);
}
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

template <typename Tin>
__global__ void __launch_bounds__(256)
deconv_quantize_kernel(const Tin* __restrict__ x, const float* __restrict__ sx,
                       int8_t* __restrict__ xq, long long pixels, int cin, int cin_a) {
  const float inv = __fdiv_rn(1.f, fmaxf(__ldg(sx), 1e-8f));
  const int vecs = cin_a / 16;
  const long long total = pixels * vecs;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < total;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = v / vecs;
    const int c0 = static_cast<int>(v - p * vecs) * 16;
    const Tin* src = x + p * cin + c0;
    float f[16];
    constexpr int kPer = 16 / sizeof(Tin);  // elements per 16-byte load
#pragma unroll
    for (int h = 0; h < 16 / kPer; ++h) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + h * kPer < cin) u = __ldg(reinterpret_cast<const uint4*>(src + h * kPer));
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (sizeof(Tin) == 2) {
          f[h * 8 + 2 * e] = __uint_as_float(w4[e] << 16);
          f[h * 8 + 2 * e + 1] = __uint_as_float(w4[e] & 0xffff0000u);
        } else {
          f[h * 4 + e] = __uint_as_float(w4[e]);
        }
      }
    }
    uint32_t qv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qv[e] = pack_s8(quant(f[4 * e], inv), quant(f[4 * e + 1], inv), quant(f[4 * e + 2], inv),
                      quant(f[4 * e + 3], inv));
    }
    *reinterpret_cast<uint4*>(xq + p * cin_a + c0) = make_uint4(qv[0], qv[1], qv[2], qv[3]);
  }
}

// K3 in float32 on the CUDA cores: 64 x 64 tiles, 16-deep K tiles, a 4 x 4
// micro-tile per thread.  Not on the scoring path (bf16 there); it keeps
// the float32 compute type exact in float32.
struct Shape {
  int n, h, w, cin, cout, cin_pad, m;  // m = n*h*w pixels of each phase
};
constexpr int kFThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kFThreads)
deconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wpk,
                  const float* __restrict__ mult, const float* __restrict__ bias,
                  float* __restrict__ out, Shape s) {
  __shared__ __align__(16) float sA[kFK][kFM + 4];
  __shared__ __align__(16) float sB[kFK][kFN + 4];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int phase = blockIdx.z, pr = phase >> 1, ps = phase & 1;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int hw = s.h * s.w;

  const int row = tid >> 2, vq = tid & 3;  // staged row and float4 of the row
  const int p = m0 + row;
  const bool pok = p < s.m;
  const int pp = pok ? p : 0;
  const int pn = pp / hw, rem = pp - pn * hw;
  const int pi = rem / s.w, pj = rem - pi * s.w;
  const int co_load = n0 + row;
  const int chunks = s.cin_pad / kFK;
  const size_t wrow = 4 * static_cast<size_t>(s.cin_pad);

  float acc[4][4] = {};
  for (int kt = 0; kt < 4 * chunks; ++kt) {
    const int tap = kt / chunks;
    const int ci = (kt - tap * chunks) * kFK + vq * 4;
    const int iy = pi + pr + (tap >> 1) - 1, ix = pj + ps + (tap & 1) - 1;
    const bool ok = pok && iy >= 0 && iy < s.h && ix >= 0 && ix < s.w && ci < s.cin;
    const float4 a = ok ? __ldg(reinterpret_cast<const float4*>(
                              x + (static_cast<size_t>(pn * s.h + iy) * s.w + ix) * s.cin + ci))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = co_load < s.cout
                         ? __ldg(reinterpret_cast<const float4*>(
                               wpk + static_cast<size_t>(phase * s.cout + co_load) * wrow +
                               static_cast<size_t>(tap) * s.cin_pad + ci))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    sA[vq * 4 + 0][row] = a.x;
    sA[vq * 4 + 1][row] = a.y;
    sA[vq * 4 + 2][row] = a.z;
    sA[vq * 4 + 3][row] = a.w;
    sB[vq * 4 + 0][row] = b.x;
    sB[vq * 4 + 1][row] = b.y;
    sB[vq * 4 + 2][row] = b.z;
    sB[vq * 4 + 3][row] = b.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = m0 + ty * 4 + i;
    if (q >= s.m) continue;
    const int n = q / hw, r2 = q - n * hw;
    const int oi = r2 / s.w, oj = r2 - oi * s.w;
    float* o = out + (static_cast<size_t>(n * 2 * s.h + 2 * oi + pr) * (2 * s.w) + 2 * oj + ps) * s.cout;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int co = n0 + tx * 4 + j;
      if (co >= s.cout) continue;
      store_pair(o + co, epilogue(acc[i][j], __ldg(mult + co), __ldg(bias + co)),
                 epilogue(acc[i][j + 1], __ldg(mult + co + 1), __ldg(bias + co + 1)));
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links no libcuda.
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

// A 4-D map with 128-byte swizzle; out-of-bounds elements read as zero.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                const long long* dims, const long long* strides, const long long* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t b[4], e[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) st[i] = static_cast<cuuint64_t>(strides[i]);
  return fn(map, type, 4, const_cast<void*>(base), d, st, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 0;
  }
  return sms;
}

template <bool kInt8, typename Tout>
cudaError_t launch_wgmma(const void* a_src, const void* wpk, const void* sx, const void* ws,
                         const void* scale, const void* bias, void* out, const Plan& p,
                         cudaStream_t st) {
  const CUtensorMapDataType type =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, type, a_src, p.a_dims, p.a_strides, p.a_box) ||
      !encode_map(&map_b, type, wpk, p.b_dims, p.b_strides, p.b_box)) {
    return cudaErrorInvalidValue;
  }
  TileArgs t;
  t.n = static_cast<int>(p.n);
  t.h = static_cast<int>(p.h);
  t.w = static_cast<int>(p.w);
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
  t.a_bytes = static_cast<unsigned>(p.a_box[0] * p.a_box[1] * p.a_box[2] * p.a_box[3] * (kInt8 ? 1 : 2));
  for (int i = 0; i < 16; ++i) {
    t.dy[i] = static_cast<signed char>(p.tap_dy[i]);
    t.dx[i] = static_cast<signed char>(p.tap_dx[i]);
  }
  const cudaError_t e = cudaFuncSetAttribute(deconv_wgmma_kernel<kInt8, Tout>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = t.tiles < sms ? t.tiles : sms;
  deconv_wgmma_kernel<kInt8, Tout><<<grid, kThreads, kSmemBytes, st>>>(
      map_a, map_b, static_cast<const float*>(sx), static_cast<const float*>(ws),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<Tout*>(out), t);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_quantize(const void* x, const void* sx, void* xq, const Plan& p, cudaStream_t st) {
  const long long pixels = p.n * p.h * p.w;
  const long long total = pixels * (p.cin_a / 16);
  long long blocks = (total + 255) / 256;
  const long long cap = 8LL * (sm_count() > 0 ? sm_count() : 132);
  if (blocks > cap) blocks = cap;
  deconv_quantize_kernel<Tin><<<static_cast<int>(blocks), 256, 0, st>>>(
      static_cast<const Tin*>(x), static_cast<const float*>(sx), static_cast<int8_t*>(xq), pixels,
      static_cast<int>(p.cin), static_cast<int>(p.cin_a));
  return cudaGetLastError();
}

}  // namespace

// K3.  x [n, h, w, cin] bf16 (is_bf16 = 1) or float32, weights packed
// [4][cout][4][cin_pad] in x's type, scale/bias [cout] float32, out
// [n, 2h, 2w, cout] in x's type, plan from kernels/deconv.py::tile_plan
// (bf16: 2-byte elements) and its length in int64s.  The wrapper checks cin % 8 == 0, cout % 8 == 0
// and 16-byte alignment.
extern "C" int mval_fused_deconv_bn_relu(const void* x, const void* wpk, const void* scale,
                                         const void* bias, void* out, const long long* plan,
                                         int plan_len, int is_bf16, void* stream) {
  if (plan_len != static_cast<int>(sizeof(Plan) / sizeof(long long))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n * p.h * p.w == 0) return static_cast<int>(cudaGetLastError());
  if (is_bf16) {
    return static_cast<int>(
        launch_wgmma<false, __nv_bfloat16>(x, wpk, nullptr, nullptr, scale, bias, out, p, st));
  }
  Shape s;
  s.n = static_cast<int>(p.n);
  s.h = static_cast<int>(p.h);
  s.w = static_cast<int>(p.w);
  s.cin = static_cast<int>(p.cin);
  s.cout = static_cast<int>(p.cout);
  s.cin_pad = (s.cin + kCinAlign - 1) / kCinAlign * kCinAlign;
  s.m = s.n * s.h * s.w;
  const dim3 grid((s.m + kFM - 1) / kFM, (s.cout + kFN - 1) / kFN, 4);
  deconv_f32_kernel<<<grid, kFThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wpk),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// K4.  x [n, h, w, cin] bf16 (is_bf16 = 1) or float32, xq an s8 scratch of
// [n, h, w, cin_a], weights packed [4][cout][4][cin_pad] s8, sx the float32
// activation scale on the device, ws/scale/bias [cout] float32, out
// [n, 2h, 2w, cout] in x's type, plan from tile_plan (1-byte elements) and
// its length.
extern "C" int mval_fused_deconv_bn_relu_int8(const void* x, void* xq, const void* wpk,
                                              const void* sx, const void* ws, const void* scale,
                                              const void* bias, void* out, const long long* plan,
                                              int plan_len, int is_bf16, void* stream) {
  if (plan_len != static_cast<int>(sizeof(Plan) / sizeof(long long))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.n * p.h * p.w == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = is_bf16 ? launch_quantize<__nv_bfloat16>(x, sx, xq, p, st)
                          : launch_quantize<float>(x, sx, xq, p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = is_bf16 ? launch_wgmma<true, __nv_bfloat16>(xq, wpk, sx, ws, scale, bias, out, p, st)
              : launch_wgmma<true, float>(xq, wpk, sx, ws, scale, bias, out, p, st);
  return static_cast<int>(e);
}
