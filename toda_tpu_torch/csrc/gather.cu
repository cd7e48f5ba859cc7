// Row scatter-add (K4) and voxelizer unpack (K5) for Hopper (sm_90a).
//
// Built by toda_tpu_torch/ops/_build.py into a shared library with a plain C
// interface; toda_tpu_torch/ops/gather.py binds it with ctypes. Every launcher
// runs on the caller's stream, allocates nothing, and returns the
// cudaGetLastError() of its launch (0 = cudaSuccess).
//
// K4 scatter_rows_add replaces toda_tpu/ops/pallas_gather.py _scatter_kernel
// (public scatter_rows_add). The TPU kernel walks 128-row output tiles over
// 640-row input windows and selects with one-hot MXU products, because the
// TPU has no fast scattered stores. Here the contract "valid idx is
// nondecreasing" makes every output row's contributions one contiguous run,
// so the first row of each run sums the run in order and issues one store.
// Rows are split by -1 only in inputs the contract does not promise to be
// run-contiguous; the store is an f32 atomicAdd onto a zeroed output so that
// such inputs still sum right (their order of addition is then unspecified).
// Bound: bytes. It reads g and idx once and writes out once (plus the
// wrapper's zero fill of out); there is no arithmetic to speak of.
//
// K5 unpack_pillars replaces pallas_gather.py _unpack_kernel (public
// unpack_pillars_t). The TPU kernel undoes a bf16 hi/lo lane packing and
// transposes with selector dots; in the port the sums are plain f32 rows
// (cell, [feat..., count]) and the output is row-major (cell, cpad), so this
// is one elementwise pass: mean = sum / max(round(count), 1), zero pad,
// cast. Bound: bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One thread per (input row i, column col). Only the head row of a run of
// equal idx does work: it sums g[i..end, col] in row order and adds the total
// to out[idx, col].
template <typename T>
__global__ void scatter_rows_add_kernel(const T* __restrict__ g,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ out, int64_t m,
                                        int w) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * w) return;
  int64_t i = t / w;
  int col = (int)(t - i * w);
  int32_t j = idx[i];
  if (j < 0) return;
  if (i > 0 && idx[i - 1] == j) return;
  float s = 0.f;
  for (int64_t k = i; k < m && idx[k] == j; ++k) s += to_f32(g[k * w + col]);
  atomicAdd(out + (int64_t)j * w + col, s);
}

// One thread per output element (cell, k) of the row-major (ncell, cpad)
// output. sums rows are (c features, count).
template <typename T>
__global__ void unpack_pillars_kernel(const float* __restrict__ sums,
                                      T* __restrict__ out, int64_t ncell,
                                      int c, int cpad) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ncell * cpad) return;
  int64_t cell = t / cpad;
  int k = (int)(t - cell * cpad);
  float v = 0.f;
  if (k < c) {
    const float* row = sums + cell * (c + 1);
    v = row[k] / fmaxf(rintf(row[c]), 1.f);
  }
  out[t] = from_f32<T>(v);
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for g). out must be zero-filled (n, w) f32.
int toda_scatter_rows_add(const void* g, const int32_t* idx, float* out,
                          int64_t m, int w, int dtype, cudaStream_t stream) {
  if (m * w > 0) {
    if (dtype == 0) {
      scatter_rows_add_kernel<float><<<blocks_for(m * w), kThreads, 0, stream>>>(
          (const float*)g, idx, out, m, w);
    } else {
      scatter_rows_add_kernel<__nv_bfloat16>
          <<<blocks_for(m * w), kThreads, 0, stream>>>(
              (const __nv_bfloat16*)g, idx, out, m, w);
    }
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (for out).
int toda_unpack_pillars(const float* sums, void* out, int64_t ncell, int c,
                        int cpad, int dtype, cudaStream_t stream) {
  if (ncell * cpad > 0) {
    if (dtype == 0) {
      unpack_pillars_kernel<float><<<blocks_for(ncell * cpad), kThreads, 0, stream>>>(
          sums, (float*)out, ncell, c, cpad);
    } else {
      unpack_pillars_kernel<__nv_bfloat16>
          <<<blocks_for(ncell * cpad), kThreads, 0, stream>>>(
              sums, (__nv_bfloat16*)out, ncell, c, cpad);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
