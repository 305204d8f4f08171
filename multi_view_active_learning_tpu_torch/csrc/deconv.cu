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
// pixels [N*H*W, 4 taps x Cin] against [4 taps x Cin, Cout].  The wrapper
// packs the weights per phase as [4 phases][Cout][4 taps][Cin_pad] (K
// contiguous, Cin zero-padded to a multiple of 64).  The epilogue is
//     out = relu(acc * mult[co] + bias[co])   rounded once to x's type,
// applied to the f32 (K3) or s32 (K4) accumulator, as on the TPU.
//   * K3: mult = folded BN scale; bf16 operands on the tensor cores
//     (mma.sync m16n8k16, f32 accumulation), or float32 on the CUDA cores.
//   * K4: x is quantized while it is staged, q = clip(rint(x * inv_sx),
//     -127, 127) with inv_sx = 1 / act_scale read from device memory; the
//     weights arrive as per-Cout s8; mma.sync m16n8k32 s8 x s8 -> s32,
//     exact; mult = act_scale * w_scale * BN scale.
//
// Bound on an H100.  Operations: 16 * N*H*W * Cin * Cout multiply-adds.  At
// the scoring width (124 crops of 256^2, PoseResNet-50) the three head
// layers do 2.33e11 MACs = 4.66e11 operations: about 0.47 ms at the bf16
// dense peak (989 TFLOP/s) and 0.24 ms at the int8 peak (1979 TOP/s).  The
// bytes (the largest output, [124, 64, 64, 256] bf16, is 0.26 GB, 0.08 ms)
// weigh less, so K3 and K4 are bound by operations.
//
// Design: one block computes a 128-pixel x 128-channel tile of one phase,
// so the phases interleave in the epilogue and each output is stored once;
// there is no [4, M, Cout] scratch and no separate interleave pass.  The K
// loop walks the four taps and the Cin chunks.  K3 copies its tiles to
// shared memory with cp.async, three stages deep, and fits 128 registers so
// two blocks share an SM; K4 quantizes x on the way, so its tiles pass
// through registers, double-buffered, the next tile's loads in flight during
// the current tile's products.  Eight warps each own a 64 x 32 sub-tile
// (4 x 4 mma tiles) and load their fragments with ldmatrix; shared rows are
// padded to 20 words, which keeps those loads free of bank conflicts.  The
// TPU kernel's sample grouping and 256-wide Cin chunks existed for VMEM and
// are not kept.  Not yet done (later work): wgmma/TMA, a staged coalesced
// store, K4 staging without the register round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;        // output pixels of one phase per block
constexpr int kBN = 128;        // output channels per block
constexpr int kBKW = 16;        // K tile in 32-bit words per row
constexpr int kLDW = kBKW + 4;  // padded shared row, in words
constexpr int kCinAlign = 64;   // packed weights pad Cin to a multiple of this

struct Shape {
  int n, h, w, cin, cout, cin_pad, m;  // m = n*h*w pixels of each phase
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// The two bf16 elements of one 32-bit word, as floats.
__device__ __forceinline__ void unpack_bf16(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ int quant(float v, float inv) {
  return min(max(__float2int_rn(v * inv), -127), 127);
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Shared-memory helpers: a 16-byte asynchronous copy that writes zeros
// when `full` is false (src-size 0 reads nothing), and four 8 x 8 b16
// matrices per warp into mma fragments.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Tensor-core kernel, K3 (bf16, kInt8 = false) and K4 (kInt8 = true, Tin
// bf16 or float).  One 16-byte shared vector holds kVec K elements: 8 bf16
// or 16 s8.  A row of a tile is kBKW words = 4 vectors.  K3 copies its
// tiles straight to shared memory with cp.async, kStages deep; K4 quantizes
// x on the way, so its tiles pass through registers, double-buffered.
template <bool kInt8>
struct MmaConfig {
  static constexpr int kStages = kInt8 ? 2 : 3;
  static constexpr int kSmemBytes = kStages * (kBM + kBN) * kLDW * 4;
  static constexpr int kMinBlocks = kInt8 ? 1 : 2;  // K3 fits 128 registers: two blocks an SM
};

template <typename Tin, bool kInt8>
__global__ void __launch_bounds__(kThreads, MmaConfig<kInt8>::kMinBlocks)
deconv_mma_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ wpk,
                  const float* __restrict__ inv_sx, const float* __restrict__ mult,
                  const float* __restrict__ bias, Tin* __restrict__ out, Shape s) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int kStages = MmaConfig<kInt8>::kStages;
  constexpr int kVec = kInt8 ? 16 : 8;               // K elements per shared vector
  constexpr int kKTile = 4 * kVec;                   // K elements per tile row
  constexpr int kPerLoad = 16 / sizeof(Tin);         // input elements per global uint4
  constexpr int kRaw = kInt8 ? kVec / kPerLoad : 1;  // K4: global uint4 loads per shared vector
  constexpr int kWBytes = kInt8 ? 1 : 2;             // bytes per packed weight
  constexpr int kStageWords = (kBM + kBN) * kLDW;

  extern __shared__ __align__(16) uint32_t smem[];  // kStages x (A tile, B tile)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int phase = blockIdx.z, pr = phase >> 1, ps = phase & 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int hw = s.h * s.w;
  const float inv = kInt8 ? __ldg(inv_sx) : 1.f;

  // Each thread stages shared vectors tid and tid + 256 of the 512 in each
  // A and B tile: row v / 4, vector v % 4 of the row.  Its A rows (output
  // pixels) are fixed for the whole K loop.
  int row[2], vq[2], pn[2], pi[2], pj[2];
  bool pok[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int v = tid + u * kThreads;
    row[u] = v >> 2;
    vq[u] = v & 3;
    const int p = m0 + row[u];
    pok[u] = p < s.m;
    const int pp = pok[u] ? p : 0;
    pn[u] = pp / hw;
    const int rem = pp - pn[u] * hw;
    pi[u] = rem / s.w;
    pj[u] = rem - pi[u] * s.w;
  }
  const int chunks = s.cin_pad / kKTile;
  const int ktiles = 4 * chunks;
  const size_t wrow = 4 * static_cast<size_t>(s.cin_pad);  // packed weights per Cout row

  // Where vector u of tile kt comes from: the A source (x if masked) and
  // whether it is inside x, and the B source (wpk if masked) and whether
  // it is inside the weights.
  auto sources = [&](int kt, int u, const Tin*& a_src, bool& a_ok, const uint8_t*& b_src,
                     bool& b_ok) {
    const int tap = kt / chunks;
    const int ci = (kt - tap * chunks) * kKTile + vq[u] * kVec;
    const int iy = pi[u] + pr + (tap >> 1) - 1, ix = pj[u] + ps + (tap & 1) - 1;
    a_ok = pok[u] && iy >= 0 && iy < s.h && ix >= 0 && ix < s.w && ci < s.cin;
    a_src = a_ok ? x + (static_cast<size_t>(pn[u] * s.h + iy) * s.w + ix) * s.cin + ci : x;
    const int co = n0 + row[u];
    b_ok = co < s.cout;
    b_src = b_ok ? wpk + ((static_cast<size_t>(phase * s.cout + co)) * wrow +
                          static_cast<size_t>(tap) * s.cin_pad + ci) * kWBytes
                 : wpk;
  };
  auto a_tile = [&](int stage) { return smem + stage * kStageWords; };
  auto b_tile = [&](int stage) { return smem + stage * kStageWords + kBM * kLDW; };

  // K3: asynchronous copies of tile kt into `stage`.
  auto fetch = [&](int kt, int stage) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const Tin* a_src;
      const uint8_t* b_src;
      bool a_ok, b_ok;
      sources(kt, u, a_src, a_ok, b_src, b_ok);
      cp_async16(a_tile(stage) + row[u] * kLDW + vq[u] * 4, a_src, a_ok);
      cp_async16(b_tile(stage) + row[u] * kLDW + vq[u] * 4, b_src, b_ok);
    }
  };

  // K4: tile kt into registers, then quantized into shared memory.  The
  // mask is per global uint4 (8 bf16 or 4 float), as Cin % 8 == 0.
  uint4 ra[2][kRaw];
  uint4 rb[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int kt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const Tin* a_src;
      const uint8_t* b_src;
      bool a_ok, b_ok;
      sources(kt, u, a_src, a_ok, b_src, b_ok);
      const int ci = (kt % chunks) * kKTile + vq[u] * kVec;
#pragma unroll
      for (int r = 0; r < kRaw; ++r) {
        const bool ok = a_ok && ci + r * kPerLoad < s.cin;
        ra[u][r] = ok ? __ldg(reinterpret_cast<const uint4*>(a_src + r * kPerLoad)) : zero;
      }
      rb[u] = b_ok ? __ldg(reinterpret_cast<const uint4*>(b_src)) : zero;
    }
  };
  auto commit = [&](int stage) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float f[16];
      if constexpr (sizeof(Tin) == 2) {
#pragma unroll
        for (int r = 0; r < kRaw; ++r) {
          const uint32_t w4[4] = {ra[u][r].x, ra[u][r].y, ra[u][r].z, ra[u][r].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) unpack_bf16(w4[e], f[r * 8 + 2 * e], f[r * 8 + 2 * e + 1]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRaw; ++r) {
          f[r * 4 + 0] = __uint_as_float(ra[u][r].x);
          f[r * 4 + 1] = __uint_as_float(ra[u][r].y);
          f[r * 4 + 2] = __uint_as_float(ra[u][r].z);
          f[r * 4 + 3] = __uint_as_float(ra[u][r].w);
        }
      }
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[e] = pack_s8(quant(f[4 * e], inv), quant(f[4 * e + 1], inv),
                       quant(f[4 * e + 2], inv), quant(f[4 * e + 3], inv));
      }
      *reinterpret_cast<uint4*>(a_tile(stage) + row[u] * kLDW + vq[u] * 4) =
          make_uint4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<uint4*>(b_tile(stage) + row[u] * kLDW + vq[u] * 4) = rb[u];
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  // Two mma K steps of 8 words per tile; fragments by ldmatrix (an s8
  // fragment is the same 8 x 16-byte matrix as a bf16 one).
  auto compute = [&](int stage) {
    const uint32_t* A = a_tile(stage);
    const uint32_t* B = b_tile(stage);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], A + (wm * 64 + mi * 16 + (lane & 15)) * kLDW + ks * 8 + (lane >> 4) * 4);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4(t, B + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLDW + ks * 8 +
                           ((lane >> 3) & 1) * 4);
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
    }
  };

  if constexpr (!kInt8) {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < ktiles) fetch(st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile kt landed
      __syncthreads();               // everyone's, and stage (kt - 1) is free
      const int next = kt + kStages - 1;
      if (next < ktiles) fetch(next, next % kStages);
      cp_async_commit();
      compute(kt % kStages);
    }
  } else {
    load(0);
    commit(0);
    __syncthreads();
    for (int kt = 0; kt < ktiles; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < ktiles) load(kt + 1);
      compute(cur);
      if (kt + 1 < ktiles) commit(cur ^ 1);
      __syncthreads();
    }
  }

  // Epilogue: each accumulator pair is two neighbouring channels of one
  // pixel of this phase, written at its interleaved place in the output.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (p >= s.m) continue;
      const int n = p / hw;
      const int rem = p - n * hw;
      const int i = rem / s.w, j = rem - i * s.w;
      Tin* o = out + (static_cast<size_t>(n * 2 * s.h + 2 * i + pr) * (2 * s.w) + 2 * j + ps) * s.cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = n0 + wn * 32 + ni * 8 + t4 * 2;
        if (co >= s.cout) continue;
        const float v0 = epilogue(to_float(acc[mi][ni][half * 2]), __ldg(mult + co), __ldg(bias + co));
        const float v1 = epilogue(to_float(acc[mi][ni][half * 2 + 1]), __ldg(mult + co + 1),
                                  __ldg(bias + co + 1));
        store_pair(o + co, v0, v1);
      }
    }
  }
}

// Launch the tensor-core kernel, raising its dynamic shared memory limit
// first (K3's three stages take 60 KB, above the 48 KB default).
template <typename Tin, bool kInt8>
cudaError_t launch_mma(const void* x, const void* wpk, const void* inv_sx, const void* mult,
                       const void* bias, void* out, const Shape& s, cudaStream_t st) {
  constexpr int kBytes = MmaConfig<kInt8>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(deconv_mma_kernel<Tin, kInt8>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.m + kBM - 1) / kBM, (s.cout + kBN - 1) / kBN, 4);
  deconv_mma_kernel<Tin, kInt8><<<grid, kThreads, kBytes, st>>>(
      static_cast<const Tin*>(x), static_cast<const uint8_t*>(wpk),
      static_cast<const float*>(inv_sx), static_cast<const float*>(mult),
      static_cast<const float*>(bias), static_cast<Tin*>(out), s);
  return cudaGetLastError();
}

// K3 in float32 on the CUDA cores: 64 x 64 tiles, 16-deep K tiles, a 4 x 4
// micro-tile per thread.  Not on the scoring path (bf16 there); it keeps
// the float32 compute type exact in float32.
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
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

Shape make_shape(int n, int h, int w, int cin, int cout) {
  Shape s;
  s.n = n;
  s.h = h;
  s.w = w;
  s.cin = cin;
  s.cout = cout;
  s.cin_pad = (cin + kCinAlign - 1) / kCinAlign * kCinAlign;
  s.m = n * h * w;
  return s;
}

}  // namespace

// K3.  x [n, h, w, cin] bf16 (is_bf16 = 1) or float32, weights packed
// [4][cout][4][cin_pad] in x's type, scale/bias [cout] float32, out
// [n, 2h, 2w, cout] in x's type.  The wrapper checks cin % 8 == 0 and
// cout % 8 == 0.
extern "C" int mval_fused_deconv_bn_relu(const void* x, const void* wpk, const void* scale,
                                         const void* bias, void* out, int n, int h, int w,
                                         int cin, int cout, int is_bf16, void* stream) {
  const Shape s = make_shape(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.m == 0) return static_cast<int>(cudaGetLastError());
  if (is_bf16) {
    return static_cast<int>(
        launch_mma<__nv_bfloat16, false>(x, wpk, nullptr, scale, bias, out, s, st));
  }
  const dim3 grid((s.m + kFM - 1) / kFM, (cout + kFN - 1) / kFN, 4);
  deconv_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wpk),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// K4.  x [n, h, w, cin] bf16 (is_bf16 = 1) or float32, weights packed
// [4][cout][4][cin_pad] s8, inv_sx a float32 scalar on the device,
// mult/bias [cout] float32, out [n, 2h, 2w, cout] in x's type.
extern "C" int mval_fused_deconv_bn_relu_int8(const void* x, const void* wpk, const void* inv_sx,
                                              const void* mult, const void* bias, void* out,
                                              int n, int h, int w, int cin, int cout, int is_bf16,
                                              void* stream) {
  const Shape s = make_shape(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s.m == 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(
      is_bf16 ? launch_mma<__nv_bfloat16, true>(x, wpk, inv_sx, mult, bias, out, s, st)
              : launch_mma<float, true>(x, wpk, inv_sx, mult, bias, out, s, st));
}
