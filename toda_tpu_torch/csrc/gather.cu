// Row scatter-add (K4), voxelizer unpack (K5), row gather (K6), multi-tap
// row gather (K9), the two column gathers of the transposed layout (K7, K8)
// and the fused column gather + stride-1 conv (K10) for Hopper (sm_90a).
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
//
// K6 gather_rows replaces pallas_gather.py _gather_kernel (public
// gather_rows), the exact VJP of the dense scatter. The TPU kernel DMAs a
// span window of table rows per 128-row output block and selects with
// one-hot MXU products; here each thread copies one 16-byte chunk of one
// output row (4- or 2-byte words where the row width or the pointers are
// not 16-byte aligned) from its table row, or writes zeros for idx == -1.
// Neighbouring threads copy neighbouring chunks of a row. Bound: bytes (the
// gathered rows read once, the output written once).
//
// K9 gather_rows_taps replaces pallas_gather.py _gather_taps_kernel (public
// gather_rows_taps), the gathers of the row-major sparse conv: out[t][i] =
// table[idx[i, t]] for T <= 9 taps of one (M, T) table in one launch, a zero
// row where idx is -1. The TPU kernel DMAs one span window of table rows per
// 128-row block for all T taps and selects each tap with a one-hot MXU
// product, padded to 128 lanes, because a TPU core cannot gather rows. Here
// it is K6's copy with a tap axis: each thread copies one 16-byte chunk (4 or
// 2 bytes where the row width or a pointer is not 16-byte aligned) of one
// tap's output row; the output is (T, M, row) so each tap's rows are
// contiguous and neighbouring threads write neighbouring chunks. No window,
// no one-hot product, no lane padding. Bound: bytes (the gathered rows read
// once, the output written once).
//
// K8 gather_rows_taps_t replaces pallas_gather.py _gather_taps_t_kernel
// (public gather_rows_taps_t), and K7 gather9_stacked_t replaces
// _gather9_stacked_kernel (public gather9_stacked_t): the column gathers of
// the transposed-layout sparse conv, whose activations are (W, N) tables with
// one column per pillar. out[t][w][m] = table[w][idx[m, t]], a zero column
// where idx is -1. K8 writes T <= 9 taps as (T, W, M); K7 writes all 9 taps
// as (9W, M) rows, either [t][W] or, with a chunk, [W / chunk][t][chunk]
// (row j*9*chunk + t*chunk + r holds tap t of table row j*chunk + r), and
// copies the table's own column m for its identity tap when M == N, whatever
// idx holds there (as the TPU kernel does). The TPU kernels DMA per-dy-group
// span windows of columns and select with one-hot MXU products in 128-lane
// tiles, with a host-side overflow fallback. Here a block owns 256
// consecutive output columns of one tap and a slice of the table's rows: each
// thread loads its column's index once, then walks the rows, reading
// table[w][j] and writing out[row(t, w)][m]. Stores are coalesced along m;
// the per-tap indices are monotone over the key-sorted pillars, so a warp's
// reads of one row fall in a few neighbouring sectors. One kernel serves
// both (kStacked selects the row order). Bound: bytes (the gathered columns
// read once, the output written once).
//
// K10 gather9_conv_t replaces pallas_gather.py _gather9_conv_kernel (public
// gather9_conv_t): K7's nine column gathers fused with the stride-1 3x3x3
// conv of the transposed layout, so the (9W, M) stacked tensor never reaches
// device memory. out[zo*Cout + co][m] = sum_t sum_dz sum_ci
// w[dz, t/3, t%3, ci, co] * table[(zo + dz)*C + ci][src(m, t)], where the
// table (W = (nz+2)*C, N) carries one zero z cell of C rows on each side,
// src(m, t) = idx[m, t] (-1: a zero column) or, for the identity tap when
// M == N, m itself. The TPU kernel DMAs span windows of table columns and
// selects them with one-hot MXU products, then contracts z with a banded
// (3C, Cout) product per tap in VMEM. Here a block owns 32 output columns
// and ZT output z cells: per tap it loads its columns' sources once, stages
// the tap's (ZT+2)*C gathered table rows of those columns (f32) and the tap's
// (3C, Cout) weights in shared memory, and each thread adds the products
// into 32 f32 sums held in registers (one column, ZT z cells x Cout/8
// channels), over all nine taps; the output is written once, rounded to the
// table's type. Threads of a warp read neighbouring columns of one staged
// row (no bank conflicts) and the same weight (a broadcast). Bound: bytes at
// the card's rates (the operations fit the tensor cores' rate several times
// over); on CUDA cores this first version is bound by its shared-memory
// reads, about two per product. Tensor cores (mma.sync / wgmma) come later.

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

// One thread per word of the (m, row_words) output.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t m, int64_t row_words) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * row_words) return;
  int64_t i = t / row_words;
  int64_t k = t - i * row_words;
  int32_t j = idx[i];
  out[t] = j >= 0 ? table[(int64_t)j * row_words + k] : V();
}

// One thread per word of the (ntap, m, row_words) output; idx is (m, ntap).
template <typename V>
__global__ void gather_rows_taps_kernel(const V* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        V* __restrict__ out, int64_t m, int ntap,
                                        int64_t row_words) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)ntap * m * row_words) return;
  int64_t r = t / row_words;  // output row (tap, i)
  int64_t k = t - r * row_words;
  int64_t tap = r / m;
  int64_t i = r - tap * m;
  int32_t j = idx[i * ntap + tap];
  out[t] = j >= 0 ? table[(int64_t)j * row_words + k] : V();
}

// Column gather of the transposed layout (K7 when kStacked, else K8). Block
// (x, t, y): output columns [256x, 256x + 256) of tap t, table rows [y*rows,
// (y+1)*rows). table (w, n); idx (m, ntap); out rows as described above.
template <typename V, bool kStacked>
__global__ void gather_cols_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t n, int64_t m,
                                   int ntap, int w, int rows, int chunk,
                                   int identity) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= m) return;
  const int t = blockIdx.y;
  const int w0 = blockIdx.z * rows;
  const int w1 = min(w, w0 + rows);
  int64_t src;  // the table column this output column copies, -1 for zeros
  if (t == identity) {
    src = col;
  } else {
    src = idx[col * ntap + t];
  }
  for (int r = w0; r < w1; ++r) {
    int64_t orow;
    if (kStacked && chunk > 0) {
      const int j = r / chunk;
      orow = (int64_t)j * 9 * chunk + (int64_t)t * chunk + (r - j * chunk);
    } else {
      orow = (int64_t)t * w + r;
    }
    out[orow * m + col] = src >= 0 ? table[(int64_t)r * n + src] : V();
  }
}

constexpr int kThreads = 256;
constexpr int kColRows = 32;  // table rows per block of the column gathers

template <bool kStacked>
int launch_gather_cols(const void* table, const int32_t* idx, void* out,
                       int64_t n, int64_t m, int ntap, int w, int elem_bytes,
                       int chunk, int identity, cudaStream_t stream) {
  if (m > 0 && w > 0) {
    const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)ntap,
                    (unsigned)((w + kColRows - 1) / kColRows));
    if (elem_bytes == 4) {
      gather_cols_kernel<uint32_t, kStacked><<<grid, kThreads, 0, stream>>>(
          (const uint32_t*)table, idx, (uint32_t*)out, n, m, ntap, w, kColRows,
          chunk, identity);
    } else {
      gather_cols_kernel<uint16_t, kStacked><<<grid, kThreads, 0, stream>>>(
          (const uint16_t*)table, idx, (uint16_t*)out, n, m, ntap, w, kColRows,
          chunk, identity);
    }
  }
  return (int)cudaGetLastError();
}

constexpr int kConvCols = 32;      // output columns of one K10 block
constexpr int kConvThreads = 256;  // 8 warps; thread = (channel group, column)
constexpr int kConvSums = 32;      // f32 sums a thread keeps in registers

// K10. Block (x, y): output columns [32x, 32x + 32), output z [ZT*y, ZT*y +
// ZT). Thread (grp = tid / 32, col = tid % 32) sums channels grp + 8q,
// q < Q, for every z of the tile. w9 is (9, 3c, 8Q) f32; the dynamic shared
// memory holds the tap's weights and its staged rows.
template <typename T, int Q>
__global__ void __launch_bounds__(kConvThreads)
gather9_conv_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                    const float* __restrict__ w9, T* __restrict__ out, int64_t n,
                    int64_t m, int nz, int c, int identity) {
  constexpr int ZT = kConvSums / Q;
  constexpr int COUT = 8 * Q;
  extern __shared__ float smem[];
  float* ws = smem;                  // (3c, COUT) weights of the tap
  float* gs = smem + 3 * c * COUT;   // ((ZT + 2) * c, kConvCols) staged rows
  __shared__ int64_t src[kConvCols];
  const int col = threadIdx.x % kConvCols;
  const int grp = threadIdx.x / kConvCols;
  const int64_t m0 = (int64_t)blockIdx.x * kConvCols;
  const int z0 = blockIdx.y * ZT;
  const int rows = (ZT + 2) * c;
  const int64_t table_rows = (int64_t)(nz + 2) * c;
  float acc[ZT][Q];
#pragma unroll
  for (int zl = 0; zl < ZT; ++zl)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[zl][q] = 0.f;

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's reads of ws, gs and src are done
    if (threadIdx.x < kConvCols) {
      const int64_t mm = m0 + threadIdx.x;
      int64_t s = -1;
      if (mm < m) s = t == identity ? mm : (int64_t)idx[mm * 9 + t];
      src[threadIdx.x] = s;
    }
    const float* wt = w9 + (int64_t)t * 3 * c * COUT;
    for (int i = threadIdx.x; i < 3 * c * COUT; i += kConvThreads) ws[i] = wt[i];
    __syncthreads();
    for (int i = threadIdx.x; i < rows * kConvCols; i += kConvThreads) {
      const int r = i / kConvCols;
      const int64_t s = src[i % kConvCols];
      const int64_t gr = (int64_t)z0 * c + r;
      gs[i] = (s >= 0 && gr < table_rows) ? to_f32(table[gr * n + s]) : 0.f;
    }
    __syncthreads();
    // staged row zl*c + j holds haloed z = z0 + zl + dz, channel ci, for
    // j = dz*c + ci: the input of output z0 + zl through weight row j
    for (int j = 0; j < 3 * c; ++j) {
      float wv[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) wv[q] = ws[j * COUT + grp + 8 * q];
#pragma unroll
      for (int zl = 0; zl < ZT; ++zl) {
        const float g = gs[(zl * c + j) * kConvCols + col];
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[zl][q] = fmaf(g, wv[q], acc[zl][q]);
      }
    }
  }
  const int64_t mm = m0 + col;
  if (mm >= m) return;
#pragma unroll
  for (int zl = 0; zl < ZT; ++zl) {
    if (z0 + zl >= nz) break;
#pragma unroll
    for (int q = 0; q < Q; ++q)
      out[((int64_t)(z0 + zl) * COUT + grp + 8 * q) * m + mm] = from_f32<T>(acc[zl][q]);
  }
}

template <typename T, int Q>
int launch_gather9_conv(const void* table, const int32_t* idx, const float* w9,
                        void* out, int64_t n, int64_t m, int nz, int c,
                        int identity, cudaStream_t stream) {
  constexpr int ZT = kConvSums / Q;
  const size_t smem = sizeof(float) * ((size_t)3 * c * 8 * Q + (size_t)(ZT + 2) * c * kConvCols);
  cudaError_t err = cudaFuncSetAttribute(gather9_conv_kernel<T, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0 && nz > 0) {
    const dim3 grid((unsigned)((m + kConvCols - 1) / kConvCols), (unsigned)((nz + ZT - 1) / ZT));
    gather9_conv_kernel<T, Q><<<grid, kConvThreads, smem, stream>>>(
        (const T*)table, idx, w9, (T*)out, n, m, nz, c, identity);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_gather9_conv(const void* table, const int32_t* idx, const float* w9,
                          void* out, int64_t n, int64_t m, int nz, int c, int cout,
                          int identity, cudaStream_t stream) {
  switch (cout) {
    case 8: return launch_gather9_conv<T, 1>(table, idx, w9, out, n, m, nz, c, identity, stream);
    case 16: return launch_gather9_conv<T, 2>(table, idx, w9, out, n, m, nz, c, identity, stream);
    case 32: return launch_gather9_conv<T, 4>(table, idx, w9, out, n, m, nz, c, identity, stream);
    case 64: return launch_gather9_conv<T, 8>(table, idx, w9, out, n, m, nz, c, identity, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

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

// table: (n, row_bytes) bytes per row; out: (m, row_bytes). word: 16, 4 or
// 2, dividing row_bytes and both pointers' alignment.
int toda_gather_rows(const void* table, const int32_t* idx, void* out, int64_t m,
                     int64_t row_bytes, int word, cudaStream_t stream) {
  const int64_t words = row_bytes / word;
  if (m * words > 0) {
    const unsigned blocks = blocks_for(m * words);
    if (word == 16) {
      gather_rows_kernel<uint4><<<blocks, kThreads, 0, stream>>>(
          (const uint4*)table, idx, (uint4*)out, m, words);
    } else if (word == 4) {
      gather_rows_kernel<uint32_t><<<blocks, kThreads, 0, stream>>>(
          (const uint32_t*)table, idx, (uint32_t*)out, m, words);
    } else {
      gather_rows_kernel<uint16_t><<<blocks, kThreads, 0, stream>>>(
          (const uint16_t*)table, idx, (uint16_t*)out, m, words);
    }
  }
  return (int)cudaGetLastError();
}

// table: (n, row_bytes) bytes per row; idx: (m, ntap); out: (ntap, m,
// row_bytes). word as for toda_gather_rows.
int toda_gather_rows_taps(const void* table, const int32_t* idx, void* out, int64_t m,
                          int ntap, int64_t row_bytes, int word, cudaStream_t stream) {
  const int64_t words = row_bytes / word;
  const int64_t total = (int64_t)ntap * m * words;
  if (total > 0) {
    const unsigned blocks = blocks_for(total);
    if (word == 16) {
      gather_rows_taps_kernel<uint4><<<blocks, kThreads, 0, stream>>>(
          (const uint4*)table, idx, (uint4*)out, m, ntap, words);
    } else if (word == 4) {
      gather_rows_taps_kernel<uint32_t><<<blocks, kThreads, 0, stream>>>(
          (const uint32_t*)table, idx, (uint32_t*)out, m, ntap, words);
    } else {
      gather_rows_taps_kernel<uint16_t><<<blocks, kThreads, 0, stream>>>(
          (const uint16_t*)table, idx, (uint16_t*)out, m, ntap, words);
    }
  }
  return (int)cudaGetLastError();
}

// K8. table: (w, n) of elem_bytes (2 or 4) elements; idx: (m, ntap);
// out: (ntap, w, m).
int toda_gather_rows_taps_t(const void* table, const int32_t* idx, void* out,
                            int64_t n, int64_t m, int ntap, int w,
                            int elem_bytes, cudaStream_t stream) {
  return launch_gather_cols<false>(table, idx, out, n, m, ntap, w, elem_bytes,
                                   0, -1, stream);
}

// K7. table: (w, n); idx: (m, 9); out: (9w, m) in [t][w] order (chunk 0) or
// [w / chunk][t][chunk] order; identity: the tap that copies column m of the
// table (-1 for none; the caller passes it only when m == n).
int toda_gather9_stacked_t(const void* table, const int32_t* idx, void* out,
                           int64_t n, int64_t m, int w, int elem_bytes,
                           int chunk, int identity, cudaStream_t stream) {
  return launch_gather_cols<true>(table, idx, out, n, m, 9, w, elem_bytes,
                                  chunk, identity, stream);
}

// K10. table: (w = (nz+2)*c, n) of dtype (0 = float32, 1 = bfloat16),
// zero z halo included; idx: (m, 9); w9: (9, 3c, cout) f32, w9[t][dz*c +
// ci][co] = weights[dz][t/3][t%3][ci][co]; out: (nz*cout, m) in the table's
// type; cout in {8, 16, 32, 64}; identity: the tap that reads column m
// itself (-1 for none; the caller passes it only when m == n).
int toda_gather9_conv_t(const void* table, const int32_t* idx, const float* w9,
                        void* out, int64_t n, int64_t m, int nz, int c, int cout,
                        int identity, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return dispatch_gather9_conv<float>(table, idx, w9, out, n, m, nz, c, cout, identity,
                                        stream);
  return dispatch_gather9_conv<__nv_bfloat16>(table, idx, w9, out, n, m, nz, c, cout,
                                              identity, stream);
}

}  // extern "C"
