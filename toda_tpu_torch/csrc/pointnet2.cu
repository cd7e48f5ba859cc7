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
// BQ. One warp per query scans the candidates in index order, 32 at a time:
// each lane tests one point, __ballot_sync gives the in-ball lanes, and they
// write their indices at the running count plus their rank among the hits,
// in order. The warp stops at nsample hits; slots past the count repeat the
// first hit (0 when there is none), as pcdet's CUDA ball query does. A
// query with few neighbours scans all N; a scan's points (2.4 MB at
// 196,608) stay in L2 across the queries. Bound: the L2 reads of the
// scanned candidates (the device-memory bytes are each input once); the
// issue rate of the distance tests.

#include <cooperative_groups.h>
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

__global__ void __launch_bounds__(kBqWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ xmask,
                      const float* __restrict__ qxyz, const uint8_t* __restrict__ qmask,
                      int32_t* __restrict__ idx, int32_t* __restrict__ cnt, int64_t nq, int n,
                      int m, float r2, int ns) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kBqWarps + (threadIdx.x >> 5);
  if (q >= nq) return;
  int32_t* slots = idx + q * ns;
  int count = 0, first = 0;
  if (qmask[q]) {
    const int64_t scan = q / m;
    const float qx = qxyz[3 * q], qy = qxyz[3 * q + 1], qz = qxyz[3 * q + 2];
    const float* p = xyz + scan * n * 3;
    const uint8_t* valid = xmask + scan * n;
    for (int base = 0; base < n && count < ns; base += 32) {
      const int j = base + lane;
      bool in = false;
      if (j < n && valid[j]) in = sq_dist(p[3 * j], p[3 * j + 1], p[3 * j + 2], qx, qy, qz) < r2;
      const unsigned hits = __ballot_sync(kFull, in);
      if (hits) {
        if (count == 0) first = base + __ffs(hits) - 1;
        const int pos = count + __popc(hits & ((1u << lane) - 1u));
        if (in && pos < ns) slots[pos] = j;
        count += __popc(hits);
      }
    }
  }
  const int c = min(count, ns);
  for (int s = c + lane; s < ns; s += 32) slots[s] = first;
  if (lane == 0) cnt[q] = c;
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

// xyz (b, n, 3) f32 + xmask (b, n) bool, qxyz (b, m, 3) f32 + qmask (b, m)
// bool -> idx (b, m, ns) int32, cnt (b, m) int32.
int toda_ball_query(const float* xyz, const uint8_t* xmask, const float* qxyz,
                    const uint8_t* qmask, int32_t* idx, int32_t* cnt, int b, int n, int m,
                    float r2, int ns, cudaStream_t stream) {
  const int64_t nq = (int64_t)b * m;
  if (nq <= 0 || ns <= 0) return 0;
  const int64_t blocks = (nq + kBqWarps - 1) / kBqWarps;
  ball_query_kernel<<<(unsigned)blocks, kBqWarps * 32, 0, stream>>>(xyz, xmask, qxyz, qmask, idx,
                                                                    cnt, nq, n, m, r2, ns);
  return (int)cudaGetLastError();
}

}  // extern "C"
