// K2: min distance from every pool row to the masked centers, with the
// centers split across a thread-block cluster.
//
// Replaces the TPU kernel ops/pallas/pairwise.py::min_distance_to_centers
// (_min_dist_kernel) of the JAX package: for every row x_i of a [n, d]
// float32 matrix,
//   out[i] = sqrt(min over j with mask[j] of max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0))
// and +inf when no center is set (the semantics of the plain version,
// ops/coreset.py::_min_dist_to_centers; the TPU kernel returns 1e15 there).
// The [n, n] distance matrix never exists.
//
// Bound on an H100: operations.  The coreset ranking's 2048 x 57 pool with
// 200 centers needs 2*n*|centers|*d = 47 MFLOP (0.7 us at the 67 TFLOP/s
// FP32 rate) against 0.47 MB of input, so at this size the floor is one
// launch and a few memory round trips; at 10^4-10^5 rows, or at the 2048-wide
// trunk embeddings of AL.CORESET_FEATURES=EMBEDDING (1.68 GFLOP for a
// 2048 x 2048 pool with 200 centers), the products rule.
// The dot products run as IEEE FP32 FMAs on the CUDA cores, not TF32 tensor
// cores: the expanded form cancels, and its error must stay at the FP32
// floor the tests budget for.  |x|^2, |c|^2 and x.c are each an fmaf chain
// over k ascending, so a labeled point's distance to itself is exactly 0.
//
// Design (launch geometry: kernels/pairwise.py::launch_plan):
//   * A cluster of `cluster` CTAs owns kRows pool rows (one per lane); the
//     grid is row_blocks x cluster CTAs, chosen so that small pools still
//     fill the SMs.
//   * Each CTA compacts the mask itself, `chunk` entries at a time: 16-byte
//     vector loads, __popc of each thread's set bytes and a shuffle prefix
//     sum give the chunk's center indices in order in shared memory.  An
//     empty range costs one vector load per 16 entries and no center work.
//   * Rank r of the cluster takes the r-th of `cluster` equal slices of
//     each chunk's compacted list (kernels/pairwise.py::rank_slice), in
//     tiles of kTile centers: one kGroup group per warp.
//   * The feature axis is walked in `k_steps` pieces of `k_width` floats
//     (the whole row when it fits, so d has no limit).  A step stages the
//     tile's centers, and the rows when there is more than one step,
//     transposed to [k][j] with 4-byte cp.async, double-buffered over the
//     (tile, piece) sequence: the next step lands while the current one is
//     reduced.  A lane's row against its warp's group is kGroup FMA chains
//     held in registers across the pieces, fed per k by one conflict-free
//     load of x and kGroup / 4 broadcast float4 loads of centers.  The 16
//     lanes j < kGroup run the group's |c|^2 chains the same way, and the
//     first tile runs |x|^2.  The pieces go k ascending, so every chain is
//     the one fmaf chain over k of the unchunked sum.
//   * With one step the rows are staged once, while the mask is compacted,
//     and waited for with the first center tile.
//   * The four warps' minima meet in shared memory, the cluster's through
//     distributed shared memory: each rank writes its partial minima into
//     rank 0's shared memory (map_shared_rank), and after one cluster.sync()
//     rank 0 takes the min and the sqrt and stores.  One launch: no atomics,
//     no memset, no second pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

// kernels/pairwise.py::DistancePlan, field for field (the wrapper passes it
// flattened to int64s; the entry point checks the length).
struct Plan {
  long long n, d, row_blocks, cluster, grid, chunk, center_tile, tile_stride, k_width, k_steps,
      smem_bytes;
};

struct Args {
  int n, d, cluster, chunk, ts, kw, nk;  // ts: floats between k-rows of a center tile
};

constexpr int kRows = 32;  // pool rows per cluster, one per lane (kernels/pairwise.py ROWS)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 16;  // centers per warp step (kernels/pairwise.py GROUP)
constexpr int kTile = kWarps * kGroup;  // centers per staged tile (kernels/pairwise.py TILE)
constexpr int kScan = kThreads * 16;  // mask entries per compaction pass
constexpr int kMaxCluster = 8;  // the portable cluster size (kernels/pairwise.py MAX_CLUSTER)
constexpr int kMaxCards = 64;  // cards whose shared-memory opt-in is remembered
constexpr int kSmemBlock = 232448;  // shared memory one block may use (kernels/pairwise.py SMEM_BLOCK)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Bits 0-3: which of the four bytes of w are nonzero.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (w & 0xffu ? 1u : 0u) | (w & 0xff00u ? 2u : 0u) | (w & 0xff0000u ? 4u : 0u) |
         (w & 0xff000000u ? 8u : 0u);
}

// Element i = j w + k of a [rows][w] block, walked by a thread in steps of
// kThreads without a division per element: (j, k) advance by constant steps.
struct Walk {
  int j, k, dj, dk;
};

__device__ __forceinline__ Walk make_walk(int w) {
  return Walk{static_cast<int>(threadIdx.x) / w, static_cast<int>(threadIdx.x) % w, kThreads / w,
              kThreads % w};
}

__device__ __forceinline__ void advance(Walk& it, int w) {
  it.j += it.dj;
  it.k += it.dk;
  if (it.k >= w) {
    it.k -= w;
    ++it.j;
  }
}

// Stage features [k0, k0 + kwe) of this cluster's rows into xs [kw][kRows]
// (rows past n as zeros), without committing.
__device__ __forceinline__ void stage_rows(float* xs, const float* __restrict__ x, int row0, int k0,
                                           int kwe, const Args& a) {
  for (Walk it = make_walk(kwe); it.j < kRows; advance(it, kwe)) {
    if (row0 + it.j < a.n) {
      cp_async4(xs + it.k * kRows + it.j, x + static_cast<size_t>(row0 + it.j) * a.d + k0 + it.k);
    } else {
      xs[it.k * kRows + it.j] = 0.f;
    }
  }
}

// One step: features [k0, k0 + kwe) of centers list[lo, lo + cnt) into a
// [kw][ts] tile, and of the rows too when `rows`; one commit group.
__device__ __forceinline__ void stage_step(float* buf, const float* __restrict__ x,
                                           const int* list, int lo, int cnt, int k0, int kwe,
                                           int row0, bool rows, const Args& a) {
  if (rows) stage_rows(buf, x, row0, k0, kwe, a);
  float* tile = buf + a.kw * kRows;
  for (Walk it = make_walk(kwe); it.j < cnt; advance(it, kwe)) {
    cp_async4(tile + it.k * a.ts + it.j, x + static_cast<size_t>(list[lo + it.j]) * a.d + k0 + it.k);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
min_distance_kernel(const float* __restrict__ x, const unsigned char* __restrict__ mask,
                    float* __restrict__ out, Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / a.cluster) * kRows;
  const int n = a.n, d = a.d, nk = a.nk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp * kGroup;  // this warp's group of every tile
  // A CTA may write a peer's shared memory only once the peer runs: arrive
  // here, wait just before the write (by then every peer has long started).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  extern __shared__ __align__(16) float smem[];
  const int buf_floats = a.kw * (kRows + a.ts);
  float* bufs = smem;                            // 2 x ([kw][kRows] rows, [kw][ts] centers)
  float* part = bufs + 2 * buf_floats;           // [kWarps][kRows]
  float* gather = part + kWarps * kRows;         // [cluster][kRows]: rank 0's, each rank's min
  int* wsum = reinterpret_cast<int*>(gather + kMaxCluster * kRows);  // [kWarps]
  int* list = wsum + kWarps;                     // [chunk]

  // With one step the rows stay in buffer 0's row block for the whole run.
  if (nk == 1) {
    stage_rows(bufs, x, row0, 0, d, a);
    cp_async_commit();  // waited for with the first center tile, or at the end
  }

  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  float best = INFINITY, xsq = 0.f, cs = 0.f;
  float acc[kGroup];
  bool have_xsq = false;
  for (int c0 = 0; c0 < n; c0 += a.chunk) {
    const int c1 = min(n, c0 + a.chunk);
    // Compact the chunk's set entries into list[0, count), in index order.
    int count = 0;
    for (int p0 = c0; p0 < c1; p0 += kScan) {
      const int base = p0 + tid * 16;
      unsigned bits = 0;
      if (vec && base + 16 <= c1) {
        const uint4 v = *reinterpret_cast<const uint4*>(mask + base);
        bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
               nonzero_bytes(v.w) << 12;
      } else {
        for (int j = 0; j < 16; ++j) {
          if (base + j < c1 && mask[base + j]) bits |= 1u << j;
        }
      }
      const int mine = __popc(bits);
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? wsum[w] : 0;
        total += wsum[w];
      }
      int pos = count + before + incl - mine;
      while (bits) {
        list[pos++] = base + __ffs(bits) - 1;
        bits &= bits - 1;
      }
      count += total;
      __syncthreads();  // wsum is rewritten by the next pass; list is complete
    }

    // This rank's slice of the chunk's centers: tiles of kTile, each walked
    // in nk steps of the feature axis.
    const int lo = static_cast<int>(static_cast<long long>(count) * rank / a.cluster);
    const int hi = static_cast<int>(static_cast<long long>(count) * (rank + 1) / a.cluster);
    const int steps = (hi - lo + kTile - 1) / kTile * nk;
    if (steps > 0) stage_step(bufs, x, list, lo, min(kTile, hi - lo), 0, min(a.kw, d), row0,
                              nk > 1, a);
    for (int s = 0; s < steps; ++s) {
      const int t = s / nk, kc = s - t * nk;
      const int t_lo = lo + t * kTile, cnt = min(kTile, hi - t_lo);
      const int k0 = kc * a.kw, kwe = min(a.kw, d - k0);
      float* buf = bufs + (s & 1) * buf_floats;
      if (s + 1 < steps) {
        const int tn = (s + 1) / nk, kn = (s + 1) - tn * nk;
        const int n_lo = lo + tn * kTile;
        stage_step(bufs + ((s + 1) & 1) * buf_floats, x, list, n_lo, min(kTile, hi - n_lo),
                   kn * a.kw, min(a.kw, d - kn * a.kw), row0, nk > 1, a);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step s (and before it the rows) is in shared memory
      const float* xs = nk == 1 ? bufs : buf;
      const float* tile = buf + a.kw * kRows;
      if (kc == 0) {
        cs = 0.f;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
      }
      if (!have_xsq) {
#pragma unroll 4
        for (int k = 0; k < kwe; ++k) {
          const float v = xs[k * kRows + lane];
          xsq = fmaf(v, v, xsq);
        }
      }
      if (g < cnt) {
        // Lane j < kGroup: |c|^2 of center g + j, the same fmaf chain as |x|^2.
        if (lane < kGroup && g + lane < cnt) {
#pragma unroll 4
          for (int k = 0; k < kwe; ++k) {
            const float v = tile[k * a.ts + g + lane];
            cs = fmaf(v, v, cs);
          }
        }
#pragma unroll 4
        for (int k = 0; k < kwe; ++k) {
          const float xv = xs[k * kRows + lane];
          const float4* c4 = reinterpret_cast<const float4*>(tile + k * a.ts + g);
#pragma unroll
          for (int v = 0; v < kGroup / 4; ++v) {
            const float4 c = c4[v];
            acc[4 * v] = fmaf(xv, c.x, acc[4 * v]);
            acc[4 * v + 1] = fmaf(xv, c.y, acc[4 * v + 1]);
            acc[4 * v + 2] = fmaf(xv, c.z, acc[4 * v + 2]);
            acc[4 * v + 3] = fmaf(xv, c.w, acc[4 * v + 3]);
          }
        }
      }
      if (kc == nk - 1) {
        have_xsq = true;
        if (g < cnt) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const float cj = __shfl_sync(0xffffffffu, cs, j);
            if (g + j < cnt) best = fminf(best, fmaxf((xsq + cj) - 2.f * acc[j], 0.f));
          }
        }
      }
      __syncthreads();  // step s's buffer is free for step s + 2
    }
  }

  // The CTA's min over its warps into rank 0's shared memory (through
  // distributed shared memory from the other ranks), then rank 0's min over
  // the ranks after one cluster barrier.
  cp_async_wait<0>();
  part[warp * kRows + lane] = best;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp == 0) {
    float m = part[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fminf(m, part[w * kRows + lane]);
    cluster.map_shared_rank(gather, 0)[rank * kRows + lane] = m;
  }
  cluster.sync();  // the ranks' minima are in rank 0's shared memory
  if (rank == 0 && warp == 0) {
    float m = gather[lane];
    for (int r = 1; r < a.cluster; ++r) m = fminf(m, gather[r * kRows + lane]);
    if (row0 + lane < n) out[row0 + lane] = sqrtf(m);
  }
}

}  // namespace

extern "C" int mval_min_distance_to_centers(const void* features, const void* center_mask,
                                            void* out, const long long* plan_flat, int plan_len,
                                            void* stream) {
  if (plan_len != static_cast<int>(sizeof(Plan) / sizeof(long long))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  memcpy(&p, plan_flat, sizeof(Plan));
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.grid != p.row_blocks * p.cluster || p.d < 1 ||
      p.center_tile != kTile || p.tile_stride < kTile || p.tile_stride % 4 || p.chunk % kScan ||
      p.k_width < 1 || p.k_width > p.d || p.k_steps != (p.d + p.k_width - 1) / p.k_width ||
      p.n > INT32_MAX || p.d > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.n <= 0) return static_cast<int>(cudaGetLastError());
  if (p.smem_bytes > kSmemBlock) return static_cast<int>(cudaErrorInvalidValue);
  // A block's whole shared memory, once per card (the attribute is the
  // current card's).
  static bool opted_in[kMaxCards];
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (card >= kMaxCards || !opted_in[card]) {
    err = cudaFuncSetAttribute(min_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBlock);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (card < kMaxCards) opted_in[card] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Args a{static_cast<int>(p.n), static_cast<int>(p.d), static_cast<int>(p.cluster),
               static_cast<int>(p.chunk), static_cast<int>(p.tile_stride),
               static_cast<int>(p.k_width), static_cast<int>(p.k_steps)};
  err = cudaLaunchKernelEx(&cfg, min_distance_kernel, static_cast<const float*>(features),
                           static_cast<const unsigned char*>(center_mask),
                           static_cast<float*>(out), a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
