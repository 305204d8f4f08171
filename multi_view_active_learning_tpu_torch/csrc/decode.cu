// K1: fused heatmap decode, heatmap rows streamed into shared memory by
// Hopper's bulk asynchronous copy and reduced by a block each.
//
// Replaces the TPU kernel ops/pallas/decode.py::fused_decode
// (_decode_kernel) of the JAX package.  For each row of a [M, h*w] float32
// heatmap matrix (rows `row_stride` floats apart) it computes, in one launch:
//   out[r, 0:2] = (idx % w, idx / w) * stride   hard argmax, first index on ties
//   out[r, 2]   = the peak value
//   out[r, 3:5] = soft-argmax * stride          stable softmax moments
//   out[r, 5:8] = 0                             padding (32-byte rows)
//
// Bound on an H100: bytes.  The scoring path's [2356, 4096] float32 input is
// 38.6 MB read once (about 11.5 us at 3.35 TB/s).  Design against that bound
// (the launch geometry is kernels/decode.py::launch_plan):
//   * Bulk path (16-byte aligned rows of a multiple of 16 bytes that fit in
//     shared memory): each block takes an equal contiguous share of the rows
//     (one row at the bench shape; the grid is three rounds of the blocks
//     resident on every SM).  Thread 0 streams a row into shared memory with
//     cp.async.bulk, one transaction per row, completion on an mbarrier.
//   * The row is read from shared memory once, into registers (kHeld float4s
//     a thread, 4 warps on a 64 x 64 map), and the stage is refilled with the
//     block's next row right after pass 1, so the next bytes land while pass
//     2 runs.  Measured on the card: arithmetic that read the stage twice, or
//     held the stage until pass 2 was done, did not overlap the copies.
//   * Pass 1 takes the max of each float4 (three fmaxf) against a running
//     max; the thread holding the first float4 with the block's max resolves
//     the first component equal to it: the row's first index of the max.
//   * Pass 2: e = ex2.approx(v log2 e - peak log2 e).  No division: each
//     held float4's (x, y) is the same for every row and is computed once per
//     launch; when w % 4 == 0 the four values of a float4 share y, so sum(e *
//     x) over them is x0 * sum(e) + (e1 + 2 e2 + 3 e3).  The argmax index is
//     divided once per row.  Two __syncthreads a row combine the warps.
//   * Ragged path (a 5x7 map, a misaligned view, rows too long for shared
//     memory): one warp per row reading device memory with scalar loads, its
//     reductions warp shuffles only; the second pass re-reads the row from
//     L1/L2.
// Exactness: hard argmax and peak bit-equal the plain version (first index
// wins: a thread's indices grow, so only a strictly greater value replaces
// its candidate, and every combine breaks ties toward the smaller index);
// the soft-argmax keeps the two-pass exp(v - peak) form around the global
// peak, summed in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// kernels/decode.py::DecodePlan, field for field (the wrapper passes it
// flattened to int64s; the entry point checks the length).
struct Plan {
  long long m, hw, width, row_stride, grid, warps, smem_bytes, bulk;
};

struct Args {
  long long row_stride;  // floats between rows
  int m, hw, width;
  int rows_q, rows_rem;  // bulk path: m = grid * rows_q + rows_rem
  float stride;
};

constexpr int kOutCols = 8;
constexpr int kBulkWarps = 4;  // bulk path: warps on a row at most (kernels/decode.py BULK_WARPS)
constexpr int kBulkMinBlocks = 6;  // bulk path: blocks an SM must fit (caps the registers)
constexpr int kRaggedWarps = 8;  // scalar path: warps a block (kernels/decode.py RAGGED_WARPS)
constexpr long long kWaitCycles = 1LL << 34;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemBlock = 232448;  // shared memory one block may use (kernels/decode.py SMEM_BLOCK)
constexpr int kNone = 0x7fffffff;  // the index of no element
constexpr int kMaxCards = 64;  // cards whose shared-memory opt-in is remembered
constexpr int kHeld = 8;  // bulk path: float4s a thread holds in registers (kernels/decode.py HELD)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Wait for the phase of `bar` with this parity; trap after kWaitCycles
// rather than hang the card on a copy that never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One row into a shared-memory stage: the single arrival of `bar` carries
// the transaction's byte count, and the copy's completion ends the phase.
// The proxy fence orders the block's earlier reads of the stage before the
// copy's writes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// (value, index) max with the first index winning ties.
__device__ __forceinline__ void argmax_combine(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void take_if_greater(float v, int i, float& best, int& best_i) {
  if (v > best) {
    best = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    argmax_combine(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                   __shfl_xor_sync(0xffffffffu, i, off));
  }
}

__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
}

// A thread's walk over a row, every `step` values from value `first`:
// where its first value sits in the map and how far (x, y) move per step.
// Divided once per launch; (x, y) are whole numbers kept in float, exact
// below 2^24.
struct Walk {
  float x0, y0, dx, dy;
};

__device__ __forceinline__ Walk make_walk(int first, int step, int width) {
  return Walk{static_cast<float>(first % width), static_cast<float>(first / width),
              static_cast<float>(step % width), static_cast<float>(step / width)};
}

__device__ __forceinline__ void advance(float& x, float& y, const Walk& w, float width) {
  x += w.dx;
  y += w.dy;
  if (x >= width) {
    x -= width;
    y += 1.f;
  }
}

// One float4's share of the softmax moments: e of its four values and the
// sums of e, e x and e y, with (x, y) the position of its first value.
template <bool kW4>
__device__ __forceinline__ void moments4(float4 v, float pl, float x, float y, float wf, float& se,
                                         float& sx, float& sy) {
  const float e0 = exp2_approx(fmaf(v.x, kLog2e, -pl));
  const float e1 = exp2_approx(fmaf(v.y, kLog2e, -pl));
  const float e2 = exp2_approx(fmaf(v.z, kLog2e, -pl));
  const float e3 = exp2_approx(fmaf(v.w, kLog2e, -pl));
  const float s4 = (e0 + e1) + (e2 + e3);
  se += s4;
  if (kW4) {
    // The four share y; sum_j e_j (x + j) = x s4 + e1 + 2 e2 + 3 e3.
    sx += fmaf(x, s4, fmaf(3.f, e3, fmaf(2.f, e2, e1)));
    sy = fmaf(y, s4, sy);
  } else {
    const float e[4] = {e0, e1, e2, e3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float xj = x + j, yj = y;
      while (xj >= wf) {  // at most 3 / width times
        xj -= wf;
        yj += 1.f;
      }
      sx = fmaf(e[j], xj, sx);
      sy = fmaf(e[j], yj, sy);
    }
  }
}

__device__ __forceinline__ void store_row(float* o, int idx, float peak, float se, float sx,
                                          float sy, int width, float s) {
  float4* o4 = reinterpret_cast<float4*>(o);
  o4[0] = make_float4(static_cast<float>(idx % width) * s, static_cast<float>(idx / width) * s,
                      peak, sx / se * s);
  o4[1] = make_float4(sy / se * s, 0.f, 0.f, 0.f);
}

// Shared partials of one block's warps, and the row's peak element and
// index from the thread that holds them.
struct Partials {
  float v[kBulkWarps];
  int i[kBulkWarps];
  float s[3][kBulkWarps];
  float peak;
  int idx;
};

// One staged row through a block: pass 1 into registers, the block's
// argmax, pass 2 from the registers, the warps' sums into `part` (thread 0
// finishes the row after the caller's barrier).  kFull: every thread holds
// kHeld float4s, so the held loops need no bounds checks.  (hx, hy): the
// position of each held float4's first value, the same for every row.
// When the whole row is held (`held_all`), `refill` runs right after the
// block's first barrier: every thread has read the stage by then, so the
// next row's copy lands while this one's pass 2 runs.
template <bool kW4, bool kFull, typename Refill>
__device__ __forceinline__ void bulk_row(const float4* p4, int nq, int t, int T, int warps,
                                         bool held_all, const float (&hx)[kHeld],
                                         const float (&hy)[kHeld], float rx, float ry,
                                         const Walk& walk, float wf, Partials& part,
                                         Refill refill) {
  const int lane = t & 31, warp = t >> 5;
  // Pass 1: each float4's max replaces the candidate only when strictly
  // greater: the first float4 holding the thread's max.  Rows longer than
  // kHeld float4s a thread read the rest again from shared memory.
  float4 held[kHeld];
  float peak = -INFINITY;
  int q = kNone;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int qj = t + j * T;
    if (kFull || qj < nq) {
      held[j] = p4[qj];
      const float m = max4(held[j]);
      if (j == 0 || m > peak) {
        peak = m;
        q = qj;
      }
    }
  }
  for (int qj = t + kHeld * T; qj < nq; qj += T) take_if_greater(max4(p4[qj]), qj, peak, q);
  warp_argmax(peak, q);
  if (lane == 0) {
    part.v[warp] = peak;
    part.i[warp] = q;
  }
  __syncthreads();
  if (held_all && t == 0) refill();
  peak = part.v[0];
  q = part.i[0];
  for (int w = 1; w < warps; ++w) argmax_combine(peak, q, part.v[w], part.i[w]);
  // The thread holding float4 q resolves the first component equal to the
  // max: the row's index, and its peak element bit for bit (fmaxf may have
  // returned +0 for a -0 element; both give the same exponentials).
  if (q >= kHeld * T ? t == 0 : (q - t) % T == 0 && q >= t) {
    float4 v = q >= kHeld * T ? p4[q] : held[0];
#pragma unroll
    for (int j = 1; j < kHeld; ++j) {
      if (q == t + j * T) v = held[j];
    }
    const int k = v.x == peak ? 0 : v.y == peak ? 1 : v.z == peak ? 2 : 3;
    part.peak = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    part.idx = 4 * q + k;
  }

  // Pass 2 from the registers, then the rest (if any) from shared memory.
  const float pl = peak * kLog2e;
  float se = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (kFull || t + j * T < nq) moments4<kW4>(held[j], pl, hx[j], hy[j], wf, se, sx, sy);
  }
  for (int qj = t + kHeld * T; qj < nq; qj += T) {
    moments4<kW4>(p4[qj], pl, rx, ry, wf, se, sx, sy);
    advance(rx, ry, walk, wf);
  }
  warp_sum3(se, sx, sy);
  if (lane == 0) {
    part.s[0][warp] = se;
    part.s[1][warp] = sx;
    part.s[2][warp] = sy;
  }
}

template <bool kW4>
__global__ void __launch_bounds__(kBulkWarps * 32, kBulkMinBlocks)
decode_bulk_kernel(const float* __restrict__ hm, float* __restrict__ out, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];  // the staged row
  __shared__ Partials part;
  __shared__ uint64_t full_bar;  // one phase per row: the row's copy has landed
  const int t = threadIdx.x, T = blockDim.x, warps = T >> 5, nq = a.hw >> 2;
  const float4* p4 = reinterpret_cast<const float4*>(smem);
  const uint32_t stage = smem_u32(smem), bar = smem_u32(&full_bar);
  const uint32_t bytes = static_cast<uint32_t>(a.hw) * 4u;
  // This block's rows [r0, r1): an equal contiguous share, the first
  // rows_rem blocks one row more (kernels/decode.py::rows_of_block).
  const int b = blockIdx.x;
  const long long r0 = static_cast<long long>(b) * a.rows_q + min(b, a.rows_rem);
  const long long r1 = r0 + a.rows_q + (b < a.rows_rem ? 1 : 0);
  const Walk walk = make_walk(4 * t, 4 * T, a.width);
  const float wf = static_cast<float>(a.width);
  float hx[kHeld], hy[kHeld], rx = walk.x0, ry = walk.y0;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    hx[j] = rx;
    hy[j] = ry;
    advance(rx, ry, walk, wf);
  }
  const bool full = nq >= kHeld * T, held_all = nq <= kHeld * T;

  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (r0 < r1) bulk_load(stage, hm + r0 * a.row_stride, bytes, bar);
  }
  __syncthreads();

  for (long long row = r0; row < r1; ++row) {
    mbar_wait(bar, static_cast<uint32_t>(row - r0) & 1u);
    // The stage takes the next row once every thread is done reading it.
    auto refill = [&]() {
      if (row + 1 < r1) bulk_load(stage, hm + (row + 1) * a.row_stride, bytes, bar);
    };
    if (full) {
      bulk_row<kW4, true>(p4, nq, t, T, warps, held_all, hx, hy, rx, ry, walk, wf, part, refill);
    } else {
      bulk_row<kW4, false>(p4, nq, t, T, warps, held_all, hx, hy, rx, ry, walk, wf, part, refill);
    }
    __syncthreads();  // the partial sums, the peak and the index are in
    if (t == 0) {
      float se = part.s[0][0], sx = part.s[1][0], sy = part.s[2][0];
      for (int w = 1; w < warps; ++w) {
        se += part.s[0][w];
        sx += part.s[1][w];
        sy += part.s[2][w];
      }
      store_row(out + row * kOutCols, part.idx, part.peak, se, sx, sy, a.width, a.stride);
      if (!held_all) refill();
    }
  }
}

// One warp per row, scalar loads from device memory, rows walked with a grid
// stride.
__global__ void __launch_bounds__(kRaggedWarps * 32)
decode_ragged_kernel(const float* __restrict__ hm, float* __restrict__ out, Args a) {
  const int lane = threadIdx.x & 31, hw = a.hw;
  const long long warps_total = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const Walk walk = make_walk(lane, 32, a.width);
  const float wf = static_cast<float>(a.width);
  for (long long row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); row < a.m;
       row += warps_total) {
    const float* p = hm + row * a.row_stride;
    float peak = -INFINITY;
    int idx = kNone;
    if (lane < hw) {
      peak = p[lane];
      idx = lane;
    }
#pragma unroll 4
    for (int i = lane + 32; i < hw; i += 32) take_if_greater(p[i], i, peak, idx);
    warp_argmax(peak, idx);

    const float pl = peak * kLog2e;
    float se = 0.f, sx = 0.f, sy = 0.f, x = walk.x0, y = walk.y0;
#pragma unroll 4
    for (int i = lane; i < hw; i += 32) {
      const float e = exp2_approx(fmaf(p[i], kLog2e, -pl));
      se += e;
      sx = fmaf(e, x, sx);
      sy = fmaf(e, y, sy);
      advance(x, y, walk, wf);
    }
    warp_sum3(se, sx, sy);
    if (lane == 0) store_row(out + row * kOutCols, idx, peak, se, sx, sy, a.width, a.stride);
  }
}

}  // namespace

extern "C" int mval_fused_decode(const void* heatmaps, void* out, const long long* plan_flat,
                                 int plan_len, float stride, void* stream) {
  if (plan_len != static_cast<int>(sizeof(Plan) / sizeof(long long))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  memcpy(&p, plan_flat, sizeof(Plan));
  if (p.warps < 1 || p.warps > (p.bulk ? kBulkWarps : kRaggedWarps) || p.width < 1 || p.hw < 1 ||
      p.grid < 1 || p.smem_bytes > kSmemBlock || (p.bulk && (p.hw % 4 || p.smem_bytes < 4 * p.hw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.m > 0) {
    const Args a{p.row_stride,
                 static_cast<int>(p.m),
                 static_cast<int>(p.hw),
                 static_cast<int>(p.width),
                 static_cast<int>(p.m / p.grid),
                 static_cast<int>(p.m % p.grid),
                 stride};
    const dim3 grid(static_cast<unsigned>(p.grid)), block(static_cast<unsigned>(p.warps * 32));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* hm = static_cast<const float*>(heatmaps);
    float* o = static_cast<float*>(out);
    if (p.bulk) {
      const bool w4 = p.width % 4 == 0;
      void (*kernel)(const float*, float*, Args) =
          w4 ? &decode_bulk_kernel<true> : &decode_bulk_kernel<false>;
      // Dynamic shared memory allowed so far, per card (the attribute is the
      // current card's).
      static int opted_in[kMaxCards][2];
      int card = 0;
      cudaError_t err = cudaGetDevice(&card);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (card >= kMaxCards || p.smem_bytes > opted_in[card][w4]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(p.smem_bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        if (card < kMaxCards) opted_in[card][w4] = static_cast<int>(p.smem_bytes);
      }
      kernel<<<grid, block, static_cast<size_t>(p.smem_bytes), st>>>(hm, o, a);
    } else {
      decode_ragged_kernel<<<grid, block, 0, st>>>(hm, o, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
