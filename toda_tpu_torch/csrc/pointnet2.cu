// Farthest point sampling (FPS) and ball query (BQ) for Hopper (sm_90a).
//
// Built by toda_tpu_torch/ops/_build.py into a shared library with a plain C
// interface; toda_tpu_torch/ops/pointnet2_ops.py binds it with ctypes. Every
// launcher runs on the caller's stream, allocates nothing, and returns the
// cudaGetLastError() of its launch (0 = cudaSuccess).
//
// Neither replaces a TPU kernel: the JAX package computes both in plain jnp
// (toda_tpu/ops/pointnet2_ops.py farthest_point_sampling :22, ball_query
// :48). They are kernels here because the plain PyTorch versions do not fit
// the H100: FPS is 4095 dependent steps of ~6 launches each (~25k launches a
// batch, >100 ms of host time), and the ball query's (queries, N) distance
// matrix is gigabytes at PV-RCNN's shapes (4096 keypoints a scan against
// 196,608 points).
//
// Both give indices equal to their plain versions: the squared distance is
// (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA), the radius
// test is d2 < r2 with r2 = float32(radius**2) from the wrapper, and argmax
// ties go to the lower index.
//
// FPS. A scan is one thread-block cluster of 16 blocks (the non-portable
// cluster size) of 1024 threads; each block keeps its sixteenth of the
// scan's points in shared memory (x, y, z as three arrays, <= 12,288 points
// = 144 KB at N = 196,608) and each thread the running distances of its up
// to 16 points in registers (point j of a block is thread j % 1024's k-th,
// k = j / 1024). A step updates every distance with the last sample, takes
// each thread's best (value, index), reduces it per warp with shuffles, per
// block through shared memory, and across the cluster through distributed
// shared memory: each block publishes its best (with its coordinates) in a
// slot of its own, one cluster.sync() a step, and every block reads the 16
// slots and reduces them the same way, so all blocks agree on the sample
// without another barrier. The slots alternate between two buffers, so a
// block never overwrites a slot another block may still be reading. Step 0
// is the same reduction over the validity (the first valid point). Bound:
// latency. The work is N x samples distance updates (~10 operations each,
// 0.5 ms of f32 issue at 4 x 196,608 x 4,096), but the steps are dependent,
// so a step costs a block's pass over its points plus three barriers, one of
// them across 16 SMs; scans run in parallel in separate clusters.
//
// BQ. A spatial grid bounds the scan: a query tests only the candidates of
// the 27 cells around it (tens to hundreds at PV-RCNN's shapes), not all N.
// One toda_ball_query call bins and queries, in a workspace the wrapper
// allocates:
//   1. bq_bounds_kernel: the valid candidates' per-axis min and max (atomics
//      on order-preserving ints), from which every later kernel computes the
//      grid in the same f32 operations (grid_of): the corner at the minimum,
//      the cell side max(extent / (cap - 1), radius * (1 + 2**-10)), at most
//      cap <= 2048 cells an axis with b * cap**3 < 2**31.
//   2. bq_keys_kernel: each candidate's key (scan, cy, cx, cz), a cell index
//      being floor((x - corner) / side); an invalid candidate's key lies past
//      every cell. Then a stable CUB radix sort of the 31-bit keys, with the
//      flat indices as values.
//   3. bq_pack_kernel: the candidates in key order as (x, y, z, flat index)
//      int4s, one 16-byte load a candidate.
//   4. ball_query_grid_kernel, one warp per query: 18 lanes binary-search the
//      sorted keys for its nine columns (cy + dy, cx + dx), each over z-cells
//      cz - 1 .. cz + 1 as one run of the order, clamped to the grid; the
//      warp walks the nine ranges as one list, 32 candidates at a time, with
//      the rounded sq_dist and __ballot_sync.
// pointnet2_ops.ball_query_grid is the binning's plain version (the CPU tests
// hold it to brute force); its docstring proves that no in-ball point is
// missed: a cell position's f32 rounding error is at most 2**-12 of a cell,
// and a point in the ball lies within r * (1 + 3 * 2**-24) < side * (1 -
// 2**-11) of the query along each axis, so its cell is at most one away.
// A query's ranges are disjoint and hold no invalid candidate.
//
// Candidates arrive by cell, not by index, so "first found" is not "first by
// index". The warp keeps the nsample smallest in-ball indices seen so far in
// registers (slot k * 32 + lane in held[k], ascending, kNoIndex when empty):
// a hit enters only if it is below the held nsample-th (kNoIndex until
// nsample are held); the warp inserts a ballot's hits one at a time (the
// rank among the held values by ballot, the larger ones shifted up a slot by
// shuffles) and the entry pushed past slot nsample - 1 drops. So the slots
// end as the first nsample in-ball points in index order, as the plain
// version's; the count is the held entries, and the slots past it repeat
// the first (0 when there is none). Bound: the bytes (each input read once,
// the outputs written once) are a few microseconds; a call is held by its
// ~18 dependent device operations (the sort's passes the largest) and the
// query warps' latency.

#include <cooperative_groups.h>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFpsCtas = 16;
constexpr int kFpsThreads = 1024;
constexpr int kFpsWarps = kFpsThreads / 32;
constexpr int kFpsPerThread = 16;
constexpr int kBqWarps = 8;
constexpr int kBqRanges = 9;  // a query's columns: (cy + dy, cx + dx), dy, dx in -1..1
constexpr int kBqKeyBits = 31;  // keys are below b * cap**3 < 2**31
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;

struct Best {
  float d;
  int i;  // index within the scan
  float x, y, z;
};

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx, float by,
                                         float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (d, i) beats (bd, bi): a larger value, or an equal one at a lower index
__device__ __forceinline__ bool beats(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bd, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, bd, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (beats(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kFpsThreads, 1)
    fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
               int32_t* __restrict__ out, int n, int ns) {
  extern __shared__ float xs[];  // [per_cta] x, then y, then z
  __shared__ Best warp_best[kFpsWarps];
  __shared__ Best slot[2];
  __shared__ Best win;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int scan = blockIdx.x / kFpsCtas;
  const int per_cta = (n + kFpsCtas - 1) / kFpsCtas;
  const int lo = rank * per_cta;
  const int cnt = max(0, min(per_cta, n - lo));
  float* ys = xs + per_cta;
  float* zs = ys + per_cta;
  const float* p = points + (int64_t)scan * n * 3;
  const uint8_t* valid = mask + (int64_t)scan * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float dist[kFpsPerThread];
#pragma unroll
  for (int k = 0; k < kFpsPerThread; ++k) {
    const int j = threadIdx.x + k * kFpsThreads;
    if (j < cnt) {
      const int64_t g = lo + j;
      xs[j] = p[3 * g];
      ys[j] = p[3 * g + 1];
      zs[j] = p[3 * g + 2];
      dist[k] = valid[g] ? 1e9f : -1e9f;
    } else {
      dist[k] = -INFINITY;
    }
  }
  __syncthreads();

  for (int s = 0; s < ns; ++s) {
    float bd = -INFINITY;
    int bi = kNoIndex;
    if (s == 0) {  // the first valid point: argmax of the validity
#pragma unroll
      for (int k = 0; k < kFpsPerThread; ++k) {
        const int j = threadIdx.x + k * kFpsThreads;
        const float v = dist[k] > 0.f ? 1.f : 0.f;
        if (j < cnt && beats(v, lo + j, bd, bi)) {
          bd = v;
          bi = lo + j;
        }
      }
    } else {
      const float lx = win.x, ly = win.y, lz = win.z;
#pragma unroll
      for (int k = 0; k < kFpsPerThread; ++k) {
        const int j = threadIdx.x + k * kFpsThreads;
        if (j < cnt) {
          dist[k] = fminf(dist[k], sq_dist(xs[j], ys[j], zs[j], lx, ly, lz));
          if (beats(dist[k], lo + j, bd, bi)) {
            bd = dist[k];
            bi = lo + j;
          }
        }
      }
    }
    warp_argmax(bd, bi);
    if (lane == 0) {
      warp_best[warp].d = bd;
      warp_best[warp].i = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = warp_best[lane].d;
      bi = warp_best[lane].i;
      warp_argmax(bd, bi);
      if (lane == 0) {
        Best b;
        b.d = bd;
        b.i = bi;
        const int j = bi == kNoIndex ? 0 : bi - lo;
        b.x = cnt > 0 ? xs[j] : 0.f;
        b.y = cnt > 0 ? ys[j] : 0.f;
        b.z = cnt > 0 ? zs[j] : 0.f;
        slot[s & 1] = b;
      }
    }
    cluster.sync();
    if (warp == 0) {
      Best b;
      if (lane < kFpsCtas) {
        b = *cluster.map_shared_rank(&slot[s & 1], lane);
      } else {
        b.d = -INFINITY;
        b.i = kNoIndex;
        b.x = b.y = b.z = 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        Best o;
        o.d = __shfl_xor_sync(kFull, b.d, off);
        o.i = __shfl_xor_sync(kFull, b.i, off);
        o.x = __shfl_xor_sync(kFull, b.x, off);
        o.y = __shfl_xor_sync(kFull, b.y, off);
        o.z = __shfl_xor_sync(kFull, b.z, off);
        if (beats(o.d, o.i, b.d, b.i)) b = o;
      }
      if (lane == 0) {
        win = b;
        if (rank == 0) out[(int64_t)scan * ns + s] = b.i;
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still read its slots
  cluster.sync();
}

// BQ's grid. The candidates' bounds are kept as order-preserving ints of
// their floats, so atomicMin / atomicMax reduce them; the wrapper's memsets
// start them at +-3.39e38 (bytes 0x7f / 0x80).
__device__ __forceinline__ int float_order(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float order_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

struct Grid {
  float lo[3], side[3];
  int dims[3];  // cells along x, y, z
};

// The grid of pointnet2_ops.ball_query_grid, in the same f32 operations:
// the corner at the valid candidates' minimum (0 when there is none), the
// side max(extent / (cap - 1), side_min), floor(extent / side) + 1 cells.
__device__ __forceinline__ Grid grid_of(const int* __restrict__ bounds, float side_min, int cap) {
  Grid g;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float lo = order_float(bounds[d]), hi = order_float(bounds[3 + d]);
    const bool some = lo <= hi;
    const float ext = some ? __fsub_rn(hi, lo) : 0.f;
    g.lo[d] = some ? lo : 0.f;
    g.side[d] = fmaxf(__fdiv_rn(ext, (float)(cap - 1)), side_min);
    g.dims[d] = (int)floorf(__fdiv_rn(ext, g.side[d])) + 1;
  }
  return g;
}

// floor((x - corner) / side), clamped to [-2, cells + 1]
__device__ __forceinline__ int cell_of(const Grid& g, int d, float x) {
  const float u = floorf(__fdiv_rn(__fsub_rn(x, g.lo[d]), g.side[d]));
  return (int)fminf(fmaxf(u, -2.f), (float)(g.dims[d] + 1));
}

__global__ void __launch_bounds__(256)
    bq_bounds_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                     int64_t total, int* __restrict__ bounds) {
  float mn[3] = {INFINITY, INFINITY, INFINITY}, mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (mask[i]) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float v = xyz[3 * i + d];
        mn[d] = fminf(mn[d], v);
        mx[d] = fmaxf(mx[d], v);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn[d] = fminf(mn[d], __shfl_xor_sync(kFull, mn[d], off));
      mx[d] = fmaxf(mx[d], __shfl_xor_sync(kFull, mx[d], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      atomicMin(&bounds[d], float_order(mn[d]));
      atomicMax(&bounds[3 + d], float_order(mx[d]));
    }
  }
}

// key (scan, cy, cx, cz) of each candidate (b * cells for an invalid one),
// and its flat index as the sort's value
__global__ void __launch_bounds__(256)
    bq_keys_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                   const int* __restrict__ bounds, float side_min, int cap, int b, int n,
                   int* __restrict__ keys, int* __restrict__ vals) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)b * n) return;
  const Grid g = grid_of(bounds, side_min, cap);
  const int64_t nx = g.dims[0], ny = g.dims[1], nz = g.dims[2];
  int64_t key = b * ny * nx * nz;
  if (mask[i]) {
    const int64_t scan = i / n;
    key = ((scan * ny + cell_of(g, 1, xyz[3 * i + 1])) * nx + cell_of(g, 0, xyz[3 * i])) * nz +
          cell_of(g, 2, xyz[3 * i + 2]);
  }
  keys[i] = (int)key;
  vals[i] = (int)i;
}

// the candidates in key order: x, y, z (f32 bits) and the flat index
__global__ void __launch_bounds__(256)
    bq_pack_kernel(const float* __restrict__ xyz, const int* __restrict__ order, int total,
                   int4* __restrict__ cand) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const int64_t i = order[j];
  cand[j] = make_int4(__float_as_int(xyz[3 * i]), __float_as_int(xyz[3 * i + 1]),
                      __float_as_int(xyz[3 * i + 2]), (int)i);
}

// The held value of slot s (k = s / 32 in registers, on lane s % 32), for
// every lane of the warp.
template <int K>
__device__ __forceinline__ int held_at(const int (&held)[K], int s) {
  int h = held[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == (s >> 5)) h = held[k];
  return __shfl_sync(kFull, h, s & 31);
}

// K held slots a lane: nsample <= 32 * K.
template <int K>
__global__ void __launch_bounds__(kBqWarps * 32)
    ball_query_grid_kernel(const int4* __restrict__ cand, const int* __restrict__ keys,
                           const int* __restrict__ bounds, const float* __restrict__ qxyz,
                           const uint8_t* __restrict__ qmask, int32_t* __restrict__ idx,
                           int32_t* __restrict__ cnt, int64_t nq, int b, int n, int m, float r2,
                           float side_min, int cap, int ns) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kBqWarps + (threadIdx.x >> 5);
  if (q >= nq) return;
  int held[K];
#pragma unroll
  for (int k = 0; k < K; ++k) held[k] = kNoIndex;
  if (qmask[q]) {
    const int64_t scan = q / m;
    const int scan_base = (int)scan * n;  // flat index of the scan's point 0
    const float qx = qxyz[3 * q], qy = qxyz[3 * q + 1], qz = qxyz[3 * q + 2];
    // lane l < 18 finds column l % 9's start (l < 9) or end in the sorted
    // keys: column (cy + dy, cx + dx), dy = r / 3 - 1, dx = r % 3 - 1, over
    // z-cells cz - 1 .. cz + 1 clamped to the grid; off the grid, key 0 twice
    int bound = 0;
    if (lane < 2 * kBqRanges) {
      const Grid g = grid_of(bounds, side_min, cap);
      const int r = lane % kBqRanges;
      const int64_t cy = cell_of(g, 1, qy) + r / 3 - 1, cx = cell_of(g, 0, qx) + r % 3 - 1;
      const int cz = cell_of(g, 2, qz);
      const int z0 = max(cz - 1, 0), z1 = min(cz + 1, g.dims[2] - 1);
      int64_t key = 0;
      if (cy >= 0 && cy < g.dims[1] && cx >= 0 && cx < g.dims[0] && z0 <= z1)
        key = ((scan * g.dims[1] + cy) * g.dims[0] + cx) * g.dims[2] +
              (lane < kBqRanges ? z0 : z1 + 1);
      int lo = 0, hi = b * n;  // lower_bound of key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((int64_t)keys[mid] < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      bound = lo;
    }
    // lane r < 9 holds range r; an inclusive prefix sum of the lengths
    const int start = bound;
    const int stop = __shfl_down_sync(kFull, bound, kBqRanges);  // every lane shuffles
    const int len = lane < kBqRanges ? stop - bound : 0;
    int end = len;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const int t = __shfl_up_sync(kFull, end, off);
      if (lane >= off) end += t;
    }
    // list position p of range r is candidate p + shift[r]
    int ends[kBqRanges], shift[kBqRanges];
#pragma unroll
    for (int r = 0; r < kBqRanges; ++r) {
      ends[r] = __shfl_sync(kFull, end, r);
      shift[r] = __shfl_sync(kFull, start - (end - len), r);
    }
    const int total = ends[kBqRanges - 1];
    int thresh = kNoIndex;  // the held nsample-th: a hit must be below it
    for (int base = 0; base < total; base += 32) {
      const int p = base + lane;
      int v = kNoIndex;
      bool in = false;
      if (p < total) {
        int j = p + shift[kBqRanges - 1];
#pragma unroll
        for (int r = kBqRanges - 2; r >= 0; --r)
          if (p < ends[r]) j = p + shift[r];
        const int4 c = cand[j];
        v = c.w - scan_base;
        in = sq_dist(__int_as_float(c.x), __int_as_float(c.y), __int_as_float(c.z), qx, qy,
                     qz) < r2 && v < thresh;
      }
      unsigned hits = __ballot_sync(kFull, in);
      while (hits) {  // warp-uniform: every lane walks the same hits
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const int val = __shfl_sync(kFull, v, src);
        if (val >= thresh) continue;
        int pos = 0;  // held values below val
#pragma unroll
        for (int k = 0; k < K; ++k) pos += __popc(__ballot_sync(kFull, held[k] < val));
        int up[K], last[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          up[k] = __shfl_up_sync(kFull, held[k], 1);
          last[k] = __shfl_sync(kFull, held[k], 31);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = k * 32 + lane;
          // lane 0's slot 0 never shifts (s > pos >= 0 is false there)
          const int prev = lane > 0 ? up[k] : last[k > 0 ? k - 1 : 0];
          if (s >= ns)
            held[k] = kNoIndex;
          else if (s == pos)
            held[k] = val;
          else if (s > pos)
            held[k] = prev;
        }
        thresh = held_at(held, ns - 1);
      }
    }
  }
  int c = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) c += __popc(__ballot_sync(kFull, held[k] != kNoIndex));
  const int least = __shfl_sync(kFull, held[0], 0);
  const int first = c > 0 ? least : 0;
  int32_t* slots = idx + q * ns;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k * 32 + lane;
    if (s < ns) slots[s] = s < c ? held[k] : first;
  }
  if (lane == 0) cnt[q] = c;
}

// The ball query's scratch, carved from the wrapper's workspace: the
// bounds, keys and values before and after the sort, the packed
// candidates, the sort's temporary storage.
struct BqWork {
  int* bounds;
  int *keys_in, *keys, *vals_in, *order;
  int4* cand;
  void* sort_tmp;
  size_t sort_bytes, total;
};

__host__ size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

__host__ BqWork carve(void* base, int items) {
  BqWork w = {};
  cub::DeviceRadixSort::SortPairs(nullptr, w.sort_bytes, (const int*)nullptr, (int*)nullptr,
                                  (const int*)nullptr, (int*)nullptr, items, 0, kBqKeyBits);
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* at = reinterpret_cast<void*>(p + off);
    off += align_up(bytes);
    return at;
  };
  w.bounds = static_cast<int*>(take(6 * sizeof(int)));
  w.keys_in = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.keys = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.vals_in = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.order = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.cand = static_cast<int4*>(take((size_t)items * sizeof(int4)));
  w.sort_tmp = take(w.sort_bytes);
  w.total = off;
  return w;
}

}  // namespace

extern "C" {

// points (b, n, 3) f32, mask (b, n) bool -> out (b, ns) int32. n must be at
// most 16 x 1024 x 16 points a scan.
int toda_fps(const float* points, const uint8_t* mask, int32_t* out, int b, int n, int ns,
             cudaStream_t stream) {
  if (b <= 0 || ns <= 0) return 0;
  const int per_cta = (n + kFpsCtas - 1) / kFpsCtas;
  if (n <= 0 || per_cta > kFpsThreads * kFpsPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)per_cta * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kFpsCtas);
  cfg.blockDim = dim3(kFpsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFpsCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel, points, mask, out, n, ns);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Bytes of the workspace toda_ball_query needs for b scans of n candidates.
size_t toda_ball_query_workspace(int b, int n) {
  return carve(nullptr, b * n).total;
}

// xyz (b, n, 3) f32 + xmask (b, n) bool, qxyz (b, m, 3) f32 + qmask (b, m)
// bool -> idx (b, m, ns) int32, cnt (b, m) int32. r2 = float32(r**2),
// side_min = float32(r * (1 + 2**-10)), cap the cells an axis (b * cap**3 <
// 2**31), ns at most 128; work holds toda_ball_query_workspace(b, n) bytes.
int toda_ball_query(const float* xyz, const uint8_t* xmask, const float* qxyz,
                    const uint8_t* qmask, int32_t* idx, int32_t* cnt, void* work,
                    size_t work_bytes, int b, int n, int m, float r2, float side_min, int cap,
                    int ns, cudaStream_t stream) {
  const int64_t nq = (int64_t)b * m;
  if (nq <= 0) return 0;
  const int items = b * n;
  if (ns <= 0 || ns > 128 || n <= 0 || cap < 2) return (int)cudaErrorInvalidValue;
  BqWork w = carve(work, items);
  if (w.total > work_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(w.bounds, 0x7f, 3 * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(w.bounds + 3, 0x80, 3 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (items + 255) / 256;
  bq_bounds_kernel<<<min(blocks, 264), 256, 0, stream>>>(xyz, xmask, items, w.bounds);
  bq_keys_kernel<<<blocks, 256, 0, stream>>>(xyz, xmask, w.bounds, side_min, cap, b, n,
                                             w.keys_in, w.vals_in);
  err = cub::DeviceRadixSort::SortPairs(w.sort_tmp, w.sort_bytes, w.keys_in, w.keys, w.vals_in,
                                        w.order, items, 0, kBqKeyBits, stream);
  if (err != cudaSuccess) return (int)err;
  bq_pack_kernel<<<blocks, 256, 0, stream>>>(xyz, w.order, items, w.cand);
  const unsigned qblocks = (unsigned)((nq + kBqWarps - 1) / kBqWarps);
  if (ns <= 32)
    ball_query_grid_kernel<1><<<qblocks, kBqWarps * 32, 0, stream>>>(
        w.cand, w.keys, w.bounds, qxyz, qmask, idx, cnt, nq, b, n, m, r2, side_min, cap, ns);
  else if (ns <= 64)
    ball_query_grid_kernel<2><<<qblocks, kBqWarps * 32, 0, stream>>>(
        w.cand, w.keys, w.bounds, qxyz, qmask, idx, cnt, nq, b, n, m, r2, side_min, cap, ns);
  else
    ball_query_grid_kernel<4><<<qblocks, kBqWarps * 32, 0, stream>>>(
        w.cand, w.keys, w.bounds, qxyz, qmask, idx, cnt, nq, b, n, m, r2, side_min, cap, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
