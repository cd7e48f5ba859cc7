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
// 196,608 points). Both bin their points first: the same bounds kernel, a
// CUB radix sort and the same pack kernel, in a workspace the wrapper
// allocates.
//
// Both give indices equal to their plain versions: the squared distance is
// (dx*dx + dy*dy) + dz*dz with every operation rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA), the radius
// test is d2 < r2 with r2 = float32(radius**2) from the wrapper, and argmax
// ties go to the lower index.
//
// FPS. One toda_fps call sorts each scan's points by the Morton code of their
// cell in a 1024**3 grid (BQ's bounds kernel, fps_keys_kernel, CUB's radix
// sort, BQ's pack kernel), then runs fps_kernel: a scan is one thread-block
// cluster of 16 blocks (the non-portable cluster size) of 16 warps; chunk c
// of 32 x P consecutive sorted points goes to block c % 16, warp c / 16, a
// thread holding P consecutive ones (P = 24 up to 196,608 points a scan, 32
// up to 2**18; measured against 8 and 32 warps a block). A block keeps its
// points' x, y, z in shared memory; a thread keeps their running distances
// and low key bits in registers, and the bounding box of its valid points.
//
// A step: (1) each thread computes lb, the rounded sq_dist from the last
// sample to the nearest point of its box; where lb >= its largest running
// distance no distance can change (the proof is in pointnet2_ops
// farthest_point_sampling_buckets: rounding is monotone), so it keeps its
// distances and its best. On PV-RCNN's scans well under 1% of the boxes
// are updated a step after the first few hundred. (2) The argmax of one
// order-preserving u64 key, (distance bits, inverted index, slot): a warp
// reduces it with two redux.sync, a block through shared memory and one
// __syncthreads, and warp 0's 16 lanes push the block's best (key and
// coordinates, 20 bytes) into a mailbox slot of every block of the cluster
// with st.async, counted on that block's mbarrier. (3) Every warp waits on
// its own block's mbarrier and reduces the 16 messages itself, so all
// blocks agree on the sample with no cluster barrier. Mailboxes and
// mbarriers alternate between two step parities; the __syncthreads keeps a
// block's warps within one step of each other, and no block pushes step s
// + 2 before every block pushed step s + 1, so a slot is read before it is
// overwritten and thread 0 rearms an mbarrier before its next phase's
// bytes arrive. Step 0 is the same reduction over the initial keys (1e9 for
// the valid points, -1e9 for the invalid): the first valid point. Bound:
// latency. Unpruned, the work would be N x samples distance updates (~10
// operations each, 0.43 ms of f32 issue at 4 x 196,608 x 4,096); pruning
// leaves a small share of it, and the floor any exact algorithm obeys is
// its bytes (a few microseconds). The steps are dependent: a step costs the
// box test, a few threads' updates, the reductions and one push-and-wait
// across 16 SMs (~0.55 us on the H100, below a cluster barrier's ~0.78 us).
// Scans run in parallel in separate clusters.
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

constexpr int kBqWarps = 8;
constexpr int kBqRanges = 9;  // a query's columns: (cy + dy, cx + dx), dy, dx in -1..1
constexpr int kBqKeyBits = 31;  // keys are below b * cap**3 < 2**31
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kFpsCtas = 16;
constexpr int kFpsWarps = 16;
// points a thread: kFpsSmallP up to 16 x 16 x 32 x 24 = 196,608 points a
// scan, kFpsLargeP up to 2**18
constexpr int kFpsSmallP = 24;
constexpr int kFpsLargeP = 32;
constexpr int kFpsIdxBits = 18;  // a point's index in its scan: n <= 2**18
constexpr unsigned kFpsIdxMask = (1u << kFpsIdxBits) - 1;
constexpr int kFpsPosBits = 14;  // a point's slot in its block's shared memory
constexpr unsigned kFpsPosMask = (1u << kFpsPosBits) - 1;
constexpr int kFpsCodeBits = 31;  // a scan's sort code: 30 Morton bits and the invalid flag
constexpr unsigned kFpsInvalidCode = 1u << 30;
// a block's message to each rank a step: the key (2 words) and x, y as one
// 16-byte store, z as a 4-byte one
constexpr int kFpsStepBytes = kFpsCtas * 20;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx, float by,
                                         float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by), dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// FPS's key of a point: the running distance as an order-preserving u32,
// then the inverted index (a lower index wins a tie), then the point's slot
// in its block (which no two points of a scan share with equal index bits),
// so that the unsigned max of keys is the argmax with the lowest index.
__device__ __forceinline__ unsigned fps_order(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fps_unorder(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// the best key of a thread's P points: the largest distance by a tree of
// fmaxf, then the largest low bits among the points at it (the lowest index)
template <int P>
__device__ __forceinline__ unsigned long long thread_best(const float (&dist)[P],
                                                          const unsigned (&low)[P]) {
  float t[P];
  unsigned u[P];
#pragma unroll
  for (int k = 0; k < P; ++k) t[k] = dist[k];
#pragma unroll
  for (int w = 1; w < P; w *= 2)
#pragma unroll
    for (int k = 0; k + w < P; k += 2 * w) t[k] = fmaxf(t[k], t[k + w]);
#pragma unroll
  for (int k = 0; k < P; ++k) u[k] = dist[k] == t[0] ? low[k] : 0u;
#pragma unroll
  for (int w = 1; w < P; w *= 2)
#pragma unroll
    for (int k = 0; k + w < P; k += 2 * w) u[k] = max(u[k], u[k + w]);
  return (unsigned long long)fps_order(t[0]) << 32 | u[0];
}

// the max of a warp's keys, on every lane
__device__ __forceinline__ void warp_max_key(unsigned& hi, unsigned& lo) {
  const unsigned h = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, hi == h ? lo : 0u);
  hi = h;
}

// every 3rd bit from bit 0 of v's low 10 bits (Morton interleave)
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3ffu;
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  v = (v | (v << 2)) & 0x09249249u;
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the shared::cluster address of the same variable in block `rank`
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait lasts microseconds; one that spins 2**24 times lost a push, and
// traps (the launch fails) rather than hanging the card.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  for (unsigned spins = 0; !bar_done(bar, parity);)
    if (++spins == (1u << 24)) __trap();
}

// stores into another block's shared memory that count their bytes on its
// mbarrier (st.async: the receiver's wait sees the data)
__device__ __forceinline__ void push4(unsigned dst, unsigned bar, unsigned a, unsigned b,
                                      unsigned c, unsigned d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(dst),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push1(unsigned dst, unsigned bar, unsigned a) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   dst),
               "r"(a), "r"(bar)
               : "memory");
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

// Each valid point's sort key: the scan, then the Morton code of its cell in
// a 1024**3 grid over the valid points' bounds (BQ's bounds kernel); an
// invalid point's code lies past every cell. pointnet2_ops.fps_sort_keys is
// its plain version, in the same f32 operations.
__global__ void __launch_bounds__(256)
    fps_keys_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                    const int* __restrict__ bounds, int b, int n,
                    unsigned long long* __restrict__ keys, int* __restrict__ vals) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)b * n) return;
  unsigned code = kFpsInvalidCode;
  if (mask[i]) {
    code = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float lo = order_float(bounds[d]), hi = order_float(bounds[3 + d]);
      const float scale = __fdiv_rn(1024.f, fmaxf(__fsub_rn(hi, lo), 1e-30f));
      const float u = floorf(__fmul_rn(__fsub_rn(xyz[3 * i + d], lo), scale));
      code |= spread3((unsigned)fminf(fmaxf(u, 0.f), 1023.f)) << (2 - d);
    }
  }
  keys[i] = (unsigned long long)(i / n) << kFpsCodeBits | code;
  vals[i] = (int)i;
}

// FPS over the scans' points in sort order (see the header). kFpsWarps x 32
// threads a block, P points a thread; mode 0 is FPS, 1 skips the distance
// update (the step's chain alone), 2 runs empty steps (the push and wait
// alone).
template <int P>
__global__ void __launch_bounds__(kFpsWarps * 32, 1)
    fps_kernel(const int4* __restrict__ cand, const uint8_t* __restrict__ mask,
               int32_t* __restrict__ out, int n, int ns, int mode) {
  constexpr int kSlots = kFpsWarps * 32 * P;
  static_assert(kSlots <= (1 << kFpsPosBits), "a slot fits the key's slot bits");
  static_assert(kFpsCtas * kSlots <= (1 << kFpsIdxBits), "a scan's index fits its bits");
  extern __shared__ float xs[];  // [kSlots] x, then y, then z
  float* ys = xs + kSlots;
  float* zs = ys + kSlots;
  __shared__ unsigned long long warp_key[kFpsWarps];
  __shared__ uint4 msg[2][kFpsCtas];  // per step parity and sender: key hi, lo, x, y
  __shared__ float msg_z[2][kFpsCtas];
  __shared__ uint64_t bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int scan = blockIdx.x / kFpsCtas;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = scan * n;  // flat index of the scan's point 0
  if (threadIdx.x == 0) {
    bar_init(smem_addr(&bar[0]), 1);
    bar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_expect(smem_addr(&bar[0]), kFpsStepBytes);
    bar_expect(smem_addr(&bar[1]), kFpsStepBytes);
  }
  // sorted positions q0 .. q0 + P - 1 of chunk warp * 16 + rank; point k
  // sits in slot (warp * P + k) * 32 + lane
  const int q0 = (warp * kFpsCtas + rank) * 32 * P + lane * P;
  float dist[P];
  unsigned low[P];
  float blo[3] = {INFINITY, INFINITY, INFINITY};  // the valid points' bounds
  float bhi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int q = q0 + k, slot = (warp * P + k) * 32 + lane;
    float p[3] = {0.f, 0.f, 0.f};
    dist[k] = -INFINITY;
    low[k] = 0;
    if (q < n) {
      const int4 c = cand[base + q];
      p[0] = __int_as_float(c.x);
      p[1] = __int_as_float(c.y);
      p[2] = __int_as_float(c.z);
      const bool valid = mask[c.w];
      dist[k] = valid ? 1e9f : -1e9f;
      low[k] = (kFpsIdxMask - (unsigned)(c.w - base)) << kFpsPosBits | (unsigned)slot;
      if (valid) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          blo[d] = fminf(blo[d], p[d]);
          bhi[d] = fmaxf(bhi[d], p[d]);
        }
      }
    }
    xs[slot] = p[0];
    ys[slot] = p[1];
    zs[slot] = p[2];
  }
  // the thread's best and its distance. Step 0's keys order the valid
  // points (1e9) before the invalid (-1e9) and the absent (-inf): its argmax
  // is the first valid point
  unsigned long long best = thread_best(dist, low);
  float bd = fps_unorder((unsigned)(best >> 32));
  __syncthreads();
  cluster.sync();  // every block's mbarriers are set before any push
  float wx = 0.f, wy = 0.f, wz = 0.f;
  for (int s = 0; s < ns; ++s) {
    const int par = s & 1;
    if (s > 0 && mode == 0) {
      // lb: sq_dist from the sample to the nearest point of the box
      const float lb = sq_dist(fminf(fmaxf(wx, blo[0]), bhi[0]), fminf(fmaxf(wy, blo[1]), bhi[1]),
                               fminf(fmaxf(wz, blo[2]), bhi[2]), wx, wy, wz);
      if (lb < bd) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int slot = (warp * P + k) * 32 + lane;
          dist[k] = fminf(dist[k], sq_dist(xs[slot], ys[slot], zs[slot], wx, wy, wz));
        }
        best = thread_best(dist, low);
        bd = fps_unorder((unsigned)(best >> 32));
      }
    }
    if (mode != 2) {
      unsigned hi = (unsigned)(best >> 32), lo = (unsigned)best;
      warp_max_key(hi, lo);
      if (lane == 0) warp_key[warp] = (unsigned long long)hi << 32 | lo;
    }
    // also bounds the warps' skew to one step, which the mailboxes and the
    // mbarriers' parities rely on
    __syncthreads();
    if (warp == 0) {
      unsigned hi = 0, lo = 0;
      if (mode != 2) {
        const unsigned long long k = lane < kFpsWarps ? warp_key[lane] : 0ull;
        hi = (unsigned)(k >> 32);
        lo = (unsigned)k;
        warp_max_key(hi, lo);
      }
      if (lane < kFpsCtas) {  // the block's best to every rank, in slot [par][rank]
        const unsigned slot = lo & kFpsPosMask;
        const unsigned rbar = cluster_addr(smem_addr(&bar[par]), lane);
        push4(cluster_addr(smem_addr(&msg[par][rank]), lane), rbar, hi, lo,
              __float_as_uint(xs[slot]), __float_as_uint(ys[slot]));
        push1(cluster_addr(smem_addr(&msg_z[par][rank]), lane), rbar, __float_as_uint(zs[slot]));
      }
    }
    // every warp waits for the 16 blocks' bests and takes their max
    bar_wait(smem_addr(&bar[par]), (unsigned)(s >> 1) & 1u);
    const uint4 m = lane < kFpsCtas ? msg[par][lane] : make_uint4(0u, 0u, 0u, 0u);
    const float mz = lane < kFpsCtas ? msg_z[par][lane] : 0.f;
    unsigned hi = m.x, lo = m.y;
    warp_max_key(hi, lo);
    const int src = __ffs(__ballot_sync(kFull, m.x == hi && m.y == lo)) - 1;
    wx = __uint_as_float(__shfl_sync(kFull, m.z, src));
    wy = __uint_as_float(__shfl_sync(kFull, m.w, src));
    wz = __shfl_sync(kFull, mz, src);
    if (threadIdx.x == 0) {
      // bar[par] serves step s + 2 next; no block pushes it before this
      // block's step s + 1 push
      bar_expect(smem_addr(&bar[par]), kFpsStepBytes);
      if (rank == 0) out[(int64_t)scan * ns + s] = (int)(kFpsIdxMask - (lo >> kFpsPosBits));
    }
  }
  // no block leaves while another may still push to it
  cluster.sync();
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

// The scratch of a binning (BQ's and FPS's), carved from the wrapper's
// workspace: the bounds, keys and values before and after the sort, the
// packed candidates, the sort's temporary storage.
template <typename Key>
struct SortWork {
  int* bounds;
  Key *keys_in, *keys;
  int *vals_in, *order;
  int4* cand;
  void* sort_tmp;
  size_t sort_bytes, total;
};

__host__ size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

template <typename Key>
__host__ SortWork<Key> carve(void* base, int items, int key_bits) {
  SortWork<Key> w = {};
  cub::DeviceRadixSort::SortPairs(nullptr, w.sort_bytes, (const Key*)nullptr, (Key*)nullptr,
                                  (const int*)nullptr, (int*)nullptr, items, 0, key_bits);
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    void* at = reinterpret_cast<void*>(p + off);
    off += align_up(bytes);
    return at;
  };
  w.bounds = static_cast<int*>(take(6 * sizeof(int)));
  w.keys_in = static_cast<Key*>(take((size_t)items * sizeof(Key)));
  w.keys = static_cast<Key*>(take((size_t)items * sizeof(Key)));
  w.vals_in = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.order = static_cast<int*>(take((size_t)items * sizeof(int)));
  w.cand = static_cast<int4*>(take((size_t)items * sizeof(int4)));
  w.sort_tmp = take(w.sort_bytes);
  w.total = off;
  return w;
}

// the valid candidates' bounds (two memsets and BQ's bounds kernel)
__host__ cudaError_t bounds_of(const float* xyz, const uint8_t* mask, int items, int* bounds,
                               cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bounds, 0x7f, 3 * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(bounds + 3, 0x80, 3 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  bq_bounds_kernel<<<min((items + 255) / 256, 264), 256, 0, stream>>>(xyz, mask, items, bounds);
  return cudaGetLastError();
}

// the points a cluster of P points a thread holds
__host__ int fps_capacity(int p) { return kFpsCtas * kFpsWarps * 32 * p; }

// the sort's key bits for b scans: the code and the scan above it
__host__ int fps_key_bits(int b) {
  int bits = kFpsCodeBits;
  while ((1ll << (bits - kFpsCodeBits)) < b) ++bits;
  return bits;
}

template <int P>
__host__ cudaError_t launch_fps(const int4* cand, const uint8_t* mask, int32_t* out, int b, int n,
                                int ns, int mode, cudaStream_t stream) {
  const size_t smem = (size_t)kFpsWarps * 32 * P * 3 * sizeof(float);
  auto kernel = fps_kernel<P>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kFpsCtas);
  cfg.blockDim = dim3(kFpsWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kFpsCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, cand, mask, out, n, ns, mode);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace toda_fps needs for b scans of n points.
size_t toda_fps_workspace(int b, int n) {
  return carve<unsigned long long>(nullptr, b * n, fps_key_bits(b)).total;
}

// points (b, n, 3) f32, mask (b, n) bool -> out (b, ns) int32, n at most
// 2**18 (the key's index bits). One call sorts the points (bounds, keys, a
// CUB radix sort, pack) and runs fps_kernel, in work (toda_fps_workspace(b,
// n) bytes). Mode 0 is FPS (1 and 2 are the measurement's splits).
int toda_fps(const float* points, const uint8_t* mask, int32_t* out, void* work,
             size_t work_bytes, int b, int n, int ns, int mode, cudaStream_t stream) {
  if (b <= 0 || ns <= 0) return 0;
  if (n <= 0 || n > fps_capacity(kFpsLargeP) || (int64_t)b * n >= (1ll << 31) || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  const int items = b * n, key_bits = fps_key_bits(b);
  SortWork<unsigned long long> w = carve<unsigned long long>(work, items, key_bits);
  if (w.total > work_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = bounds_of(points, mask, items, w.bounds, stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (items + 255) / 256;
  fps_keys_kernel<<<blocks, 256, 0, stream>>>(points, mask, w.bounds, b, n, w.keys_in,
                                              w.vals_in);
  err = cub::DeviceRadixSort::SortPairs(w.sort_tmp, w.sort_bytes, w.keys_in, w.keys, w.vals_in,
                                        w.order, items, 0, key_bits, stream);
  if (err != cudaSuccess) return (int)err;
  bq_pack_kernel<<<blocks, 256, 0, stream>>>(points, w.order, items, w.cand);
  err = n <= fps_capacity(kFpsSmallP)
            ? launch_fps<kFpsSmallP>(w.cand, mask, out, b, n, ns, mode, stream)
            : launch_fps<kFpsLargeP>(w.cand, mask, out, b, n, ns, mode, stream);
  return (int)err;
}

// Bytes of the workspace toda_ball_query needs for b scans of n candidates.
size_t toda_ball_query_workspace(int b, int n) {
  return carve<int>(nullptr, b * n, kBqKeyBits).total;
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
  SortWork<int> w = carve<int>(work, items, kBqKeyBits);
  if (w.total > work_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = bounds_of(xyz, xmask, items, w.bounds, stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (items + 255) / 256;
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
