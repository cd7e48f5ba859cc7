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
// is one elementwise pass: mean = sum / max(rint(count), 1), zero pad, cast.
// Bound: bytes (20-24 bytes read and 10-16 written a cell). Rows of 5 or 6
// floats in and 5 or 8 2-byte elements out fit no vector width, so a block
// owns a contiguous run of cells: it copies the run's sums into shared
// memory with 16-byte loads (4-byte loads at an unaligned head or tail, the
// staged run kept at the global address's offset within 16 bytes), each
// thread then reads one cell's count once and divides its c features (a true
// IEEE division and a round to nearest even: bit-equal to the plain
// version), writing its output row into shared memory, and the block stores
// its contiguous output span with 16-byte stores (element stores at the
// span's unaligned head and tail).
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
// one column per pillar. out[row(t, w)][m] = table[w][idx[m, t]], a zero
// column where idx is -1. K8 writes T <= 9 taps as (T, W, M); K7 writes all 9
// taps as (9W, M) rows, either [t][W] or, with a chunk, [W / chunk][t][chunk]
// (row j*9*chunk + t*chunk + r holds tap t of table row j*chunk + r), and
// copies the table's own column m for its identity tap when M == N, whatever
// idx holds there (as the TPU kernel does). The TPU kernels DMA per-dy-group
// span windows of columns and select with one-hot MXU products in 128-lane
// tiles, with a host-side overflow fallback. Bound: bytes, ~90% of them the
// T-fold output write. Here one kernel serves both: a block owns 256 output
// columns of one tap and a slice of 16 or 32 table rows. Each thread loads its
// column's source of a batch of 16 rows (coalesced along the columns, 16
// gathers in flight), the batch goes through shared memory, and the block
// stores it as 16-byte vectors, a warp one 512-byte row segment per store;
// the next batch's gathers are in flight during those stores. The identity
// tap copies 16-byte vectors directly. Blocks run x fastest, then tap, so a
// slice's taps run back to back and find its table rows in L2: the wrapper
// sets the slice height so that those rows and the output the slice's taps
// write fit in L2 (ops/gather.py column_gather_rows). The chunked row
// order is stepped along the rows, not divided per row. Columns past M, an M
// that is not a multiple of 8 and pointers not aligned to 16 bytes take
// element stores in the same kernel. (Blocks that own all nine taps of a
// column range, or warps that transpose their own 32 columns, measured
// slower on the card: their writes reach DRAM less in order.)
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
// (3C, Cout) product per tap in VMEM. Here a block owns 64 output columns and
// zt output z cells (the wrapper's plan, ops/gather.py conv_t_plan); its
// index tile (64 x 9) is staged once, and a tap none of its columns reads is
// skipped. Per tap it stages the (zt+2)*C gathered table rows of its columns
// in shared memory in the table's type ([row][column], a zero column where
// the tap is missing) and multiplies on the tensor cores (mma.sync m16n8k16,
// bf16, f32 sums): warp w sums columns 8w .. 8w + 7 for every output channel
// and every z cell of the tile. The staged tile is K-major for B, so
// ldmatrix.trans reads each z cell's 3C-row window in place (no im2col
// copy); at C = 8 the depth is padded from 24 to 32 with zero weight
// columns. Where C % 16 == 0 and Cout <= 32, each staged z level is read
// once and multiplied into the three output z cells it feeds, with the
// weights of all three dz held in registers. The wrapper packs the weights
// once per call as (9, Cout16, K) in the table's type (Cout16 = max(Cout,
// 16), zero rows past Cout); each tap's slice comes in by 16-byte cp.async
// into a ring of two, the next tap's during this one's products. The
// gathered 2-byte elements cannot go by cp.async: the next tap's first rows
// are loaded into registers before this tap's products and stored after
// them, the rest in batches; the identity tap (taken first) goes by cp.async.
// The sums are rounded once to the table's type, staged in shared memory and
// written along m with 16-byte stores. f32 tables keep the staging and the
// fragment layout and multiply with FFMA. Bound: bytes at the card's rates;
// on the card the staging is bound by the latency of the 2-byte gathers, and
// at C = Cout = 64 the products by the fragments' shared-memory reads and
// the 80 f32 sums a thread keeps (2 blocks an SM).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gather_gemm.cuh"

namespace {

using gg::from_f32;
using gg::to_f32;

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

// The 16-byte chunks of a span of n elements of E bytes that starts `shift`
// elements past a 16-byte boundary: [j0, j0 + nfull) lie wholly inside it;
// the elements before chunk j0 (head) and from chunk j0 + nfull on (tail)
// are copied one by one.
template <int E>
struct Span {
  int shift, n, j0, nfull;
  __device__ Span(int shift_, int n_) : shift(shift_), n(n_) {
    constexpr int PER = 16 / E;
    j0 = shift ? 1 : 0;
    nfull = max((shift + n) / PER - j0, 0);
  }
  __device__ int head() const { return min(j0 * (16 / E) - shift, n); }
  __device__ int tail_start() const { return max((j0 + nfull) * (16 / E) - shift, head()); }
};

// Block b owns cells [b * cells, b * cells + cells) (fewer in the last
// block). Shared memory: the staged sums (cells * (c + 1) + 4 floats), then
// the staged output (cells * cpad + 16 / sizeof(T) elements).
template <typename T>
__global__ void __launch_bounds__(256) unpack_pillars_kernel(
    const float* __restrict__ sums, T* __restrict__ out, int64_t ncell, int c, int cpad,
    int cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int EO = (int)sizeof(T);
  const int row = c + 1;
  const int64_t cell0 = (int64_t)blockIdx.x * cells;
  const int n = (int)min((int64_t)cells, ncell - cell0);
  float* s_in = (float*)smem;
  T* s_out = (T*)(smem + (((size_t)cells * row + 4) * 4 + 15) / 16 * 16);

  // the run's sums in, at their offset within 16 bytes
  const float* src = sums + cell0 * row;
  const Span<4> in((int)(((uintptr_t)src & 15) >> 2), n * row);
  const float4* src4 = (const float4*)(src - in.shift);
  float4* s_in4 = (float4*)s_in;
  for (int j = threadIdx.x; j < in.nfull; j += blockDim.x)
    s_in4[in.j0 + j] = __ldg(src4 + in.j0 + j);
  for (int k = threadIdx.x; k < in.head(); k += blockDim.x)
    s_in[in.shift + k] = __ldg(src + k);
  for (int k = in.tail_start() + threadIdx.x; k < in.n; k += blockDim.x)
    s_in[in.shift + k] = __ldg(src + k);
  __syncthreads();

  // one cell a thread: its count read and rounded once, its row written out
  T* dst = out + cell0 * cpad;
  const Span<EO> os((int)(((uintptr_t)dst & 15) / EO), n * cpad);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* r = s_in + in.shift + i * row;
    const float d = fmaxf(rintf(r[c]), 1.f);
    const int e0 = os.shift + i * cpad;
    int k = 0;
    if constexpr (EO == 2) {
      // pairs of bf16 as one 4-byte store where the pair is 4-byte aligned
      uint16_t* o = (uint16_t*)s_out;
      auto bits = [&](int kk) -> uint16_t {
        return kk < c ? __bfloat16_as_ushort(__float2bfloat16(r[kk] / d)) : (uint16_t)0;
      };
      if (e0 & 1) { o[e0] = bits(0); k = 1; }
      for (; k + 1 < cpad; k += 2)
        *(uint32_t*)(o + e0 + k) = (uint32_t)bits(k) | ((uint32_t)bits(k + 1) << 16);
      if (k < cpad) o[e0 + k] = bits(k);
    } else {
      for (; k < cpad; ++k) s_out[e0 + k] = k < c ? from_f32<T>(r[k] / d) : T(0.f);
    }
  }
  __syncthreads();

  // the output span out with 16-byte stores
  uint4* dst4 = (uint4*)(dst - os.shift);
  const uint4* s_out4 = (const uint4*)s_out;
  for (int j = threadIdx.x; j < os.nfull; j += blockDim.x)
    dst4[os.j0 + j] = s_out4[os.j0 + j];
  for (int k = threadIdx.x; k < os.head(); k += blockDim.x)
    dst[k] = s_out[os.shift + k];
  for (int k = os.tail_start() + threadIdx.x; k < os.n; k += blockDim.x)
    dst[k] = s_out[os.shift + k];
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Raw words of one element (2 or 4 bytes) and of two.
template <int E> struct Raw;
template <> struct Raw<2> { using One = uint16_t; using Two = uint32_t; };
template <> struct Raw<4> { using One = uint32_t; using Two = uint2; };

__device__ __forceinline__ uint32_t pack2(uint16_t a, uint16_t b) {
  return (uint32_t)a | ((uint32_t)b << 16);
}
__device__ __forceinline__ uint2 pack2(uint32_t a, uint32_t b) { return make_uint2(a, b); }

// element k of 16 bytes (k a constant after unrolling, so nothing goes
// through local memory)
template <int E>
__device__ __forceinline__ typename Raw<E>::One elem16(const uint4& v, int k) {
  constexpr int PER_WORD = 4 / E;
  const int q = k / PER_WORD;
  const uint32_t word = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  return (typename Raw<E>::One)(word >> (8 * E * (k % PER_WORD)));
}

// Column gather of the transposed layout (K7, K8). Block (x, t, y): output
// columns [256x, 256x + 256) of tap t, table rows [rows*y, rows*y + rows)
// (rows: 16 or 32, ops/gather.py column_gather_rows), in batches of 16.
// Thread i loads column i's source of a batch's rows (coalesced along the
// columns, 16 loads in flight, a missing source none) into one of two shared
// (16, 256) buffers; after one barrier the block stores the batch as 16-byte
// vectors, a warp one 512-byte (f32: 1024) row segment a store, while the
// next batch's loads are already in flight. The identity tap, where its
// vectors are aligned, copies its rows as 16-byte vectors directly. Blocks
// run x fastest, then tap, so a slice's taps follow each other while its
// table rows are in L2. table (w, n); idx (m, ntap); the output row of tap t
// and table row r = j*ck + rr is j*ntap*ck + t*ck + rr (ck: the chunk, or w
// for the [t][W] order), stepped along the rows, not divided per row.
constexpr int kBatchRows = 16;

template <int E>
__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const void* __restrict__ table_, const int32_t* __restrict__ idx,
                   void* __restrict__ out_, int64_t n, int64_t m, int ntap, int w, int rows,
                   int ck, int identity) {
  using U = typename Raw<E>::One;
  constexpr int V = 16 / E;           // columns of a 16-byte vector
  constexpr int COLS = kThreads;      // one column a thread
  constexpr int CH = COLS / V;        // vectors of a block row
  constexpr int VR = kThreads / CH;   // rows one round of stores covers
  __shared__ __align__(16) U batch_s[2][kBatchRows][COLS];
  const U* __restrict__ table = static_cast<const U*>(table_);
  U* __restrict__ out = static_cast<U*>(out_);
  const int tid = threadIdx.x, t = blockIdx.y;
  const int64_t c0 = (int64_t)blockIdx.x * COLS, col = c0 + tid;
  const int ncols = (int)min((int64_t)COLS, m - c0);
  const int r0 = blockIdx.z * rows, r1 = min(w, r0 + rows);
  // 16-byte vectors where the block's columns are all in range and every
  // row (of the output; of the table for the identity tap) starts aligned
  const bool vec_out = ncols == COLS && m % V == 0 && (reinterpret_cast<uintptr_t>(out_) & 15) == 0;
  const bool direct = t == identity && ncols == COLS && n % V == 0 &&
                      (reinterpret_cast<uintptr_t>(table_) & 15) == 0;
  const int32_t s = direct || col >= m ? -1 : t == identity ? (int32_t)col : idx[col * ntap + t];
  // this thread's vectors: rows vr, vr + VR, ... of a batch, columns vc*V ..
  const int vr = tid / CH, vc = tid % CH;
  const bool stores = vc * V < ncols;
  // the output row of table row r0 + vr, then stepped VR rows at a time:
  // r = j*ck + rr lies at j*ntap*ck + t*ck + rr
  int rr = (r0 + vr) % ck;
  U* d = out + ((int64_t)((r0 + vr) / ck) * ntap * ck + (int64_t)t * ck + rr) * m + c0 + vc * V;
  const int64_t row_step = (int64_t)VR * m, chunk_jump = (int64_t)(ntap - 1) * ck * m;
  auto store = [&](const uint4& v) {
    if (vec_out) {
      *reinterpret_cast<uint4*>(d) = v;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (vc * V + k < ncols) d[k] = elem16<E>(v, k);
    }
    d += row_step;
    for (rr += VR; rr >= ck; rr -= ck) d += chunk_jump;
  };
  if (direct) {
    if (!stores) return;
    for (int r = r0 + vr; r < r1; r += 4 * VR) {  // 4 vectors in flight
      uint4 q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r + k * VR < r1) q[k] = __ldg(reinterpret_cast<const uint4*>(table + (int64_t)(r + k * VR) * n + c0) + vc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r + k * VR < r1) store(q[k]);
    }
    return;
  }
  // a batch's loads: 32-bit offsets from its first row (n < 2^27)
  const int n32 = (int)n;
  U v[kBatchRows];
  auto load = [&](int b0) {
    const U* base = table + (int64_t)b0 * n + s;
#pragma unroll
    for (int i = 0; i < kBatchRows; ++i) v[i] = (b0 + i < r1 && s >= 0) ? __ldg(base + i * n32) : U(0);
  };
  load(r0);
  int buf = 0;
  for (int b0 = r0; b0 < r1; b0 += kBatchRows, buf ^= 1) {
#pragma unroll
    for (int i = 0; i < kBatchRows; ++i) batch_s[buf][i][tid] = v[i];
    if (b0 + kBatchRows < r1) load(b0 + kBatchRows);  // in flight during the stores
    __syncthreads();
    if (stores) {
      for (int i = vr; i < kBatchRows && b0 + i < r1; i += VR)
        store(*reinterpret_cast<const uint4*>(&batch_s[buf][i][vc * V]));
    }
  }
}

int launch_gather_cols(const void* table, const int32_t* idx, void* out, int64_t n, int64_t m,
                       int ntap, int w, int elem_bytes, int chunk, int identity, int rows,
                       cudaStream_t stream) {
  if (m > 0 && w > 0 && ntap > 0) {
    const dim3 grid((unsigned)((m + kThreads - 1) / kThreads), (unsigned)ntap,
                    (unsigned)((w + rows - 1) / rows));
    const int ck = chunk > 0 ? chunk : w;
    if (elem_bytes == 4) {
      gather_cols_kernel<4><<<grid, kThreads, 0, stream>>>(table, idx, out, n, m, ntap, w, rows,
                                                           ck, identity);
    } else {
      gather_cols_kernel<2><<<grid, kThreads, 0, stream>>>(table, idx, out, n, m, ntap, w, rows,
                                                           ck, identity);
    }
  }
  return (int)cudaGetLastError();
}

constexpr int kConvCols = 64;            // output columns of one K10 block: 8 a warp
constexpr int kConvAcc = 20;             // 16x8 sum tiles a thread keeps (80 f32)
constexpr int kConvSrc = kConvCols + 4;  // words per tap of the index tile, off the banks

// K10's launch plan (ops/gather.py conv_t_plan, CONV_T_PLAN_FIELDS, in this
// order). coutp: Cout rounded up to 16 (the packed weights' rows); kp: 3C
// rounded up to 16; zt: the output z cells of a block, at most kConvAcc /
// (coutp / 16); rows: the staged rows of a tap, (zt+2)*C + kp - 3C.
struct ConvTPlan {
  int nz, c, cout, coutp, kp, zt, rows, grid_x, grid_y, smem;
};
constexpr int kConvPlanFields = sizeof(ConvTPlan) / sizeof(int);

// K10. Block (x, y): output columns [64x, 64x + 64), output z [zt*y, zt*y +
// zt). Warp w sums columns 8w .. 8w + 7 for every output channel (MT 16-row
// tiles) and every z cell of the tile. Dynamic shared memory: two taps'
// weights ((coutp, kp) rows each), then the staged tap ((rows, 64) in the
// table's type), which the output tile ((zt*Cout, 64) in the table's type,
// rows padded by 16 bytes) reuses at the end.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, 2)
gather9_conv_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                    const T* __restrict__ w9, T* __restrict__ out, int64_t n, int64_t m,
                    const ConvTPlan p, int identity) {
  constexpr int E = sizeof(T);
  constexpr int PER = 16 / E;  // elements per 16-byte chunk
  constexpr int P = kConvCols;
  constexpr int ZW = kConvAcc / MT;  // the most z cells of a block
  constexpr int AHEAD = 4;   // staged rows a thread loads before the products, in registers
  constexpr int BATCH = 4;   // staged rows a thread loads at once after them
  using R = typename Raw<E>::One;
  using R2 = typename Raw<E>::Two;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int32_t src_s[9 * kConvSrc];
  __shared__ unsigned present_s;
  const gg::Rows rw(p.kp * E / 16);  // weight rows: one per output channel
  const gg::Rows rb(P * E / 16);     // staged rows: one per table row
  const int wbytes = p.coutp * rw.stride * 16;
  unsigned char* wring = smem;
  unsigned char* buf = smem + 2 * wbytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * P;
  const int z0 = blockIdx.y * p.zt;
  const int ncols = (int)min((int64_t)P, m - m0);
  const int64_t wrows = (int64_t)(p.nz + 2) * p.c;
  const int nzw = min(p.zt, p.nz - z0);  // output z cells of this block
  const int nrow = p.rows / kWarps;      // staged rows of each thread: warp + 8i
  const R* tab = reinterpret_cast<const R*>(table);
  // of those, the rows inside the table (the rest stage zeros)
  const int nin = (int)max((int64_t)0, min((int64_t)nrow, (wrows - (int64_t)z0 * p.c - warp + kWarps - 1) / kWarps));
  const R* row0 = tab + ((int64_t)z0 * p.c + warp) * n;  // row warp of the tile, then + 8n a row
  const int64_t rstep = (int64_t)kWarps * n;
  // the staged pair of this lane: the same swizzled chunk in every row warp + 8i
  unsigned char* spair = buf + 16 * rb.chunk(warp, 2 * lane / PER) + (2 * lane % PER) * E;
  const int sstep = kWarps * rb.stride * 16;

  // the block's (64 x 9) index tile, and the taps any of its columns reads
  if (tid == 0) present_s = 0u;
  __syncthreads();
  unsigned mine = 0u;
  for (int e = tid; e < 9 * P; e += kThreads) {
    const int col = e / 9, t = e - col * 9;
    int32_t s = -1;
    if (col < ncols) s = t == identity ? (int32_t)(m0 + col) : idx[m0 * 9 + e];
    src_s[t * kConvSrc + col] = s;
    if (s >= 0) mine |= 1u << t;
  }
  mine = __reduce_or_sync(gg::kFull, mine);
  if (lane == 0 && mine) atomicOr(&present_s, mine);
  __syncthreads();
  unsigned left = present_s;
  // the identity tap's rows are contiguous: 16-byte cp.async where aligned
  const bool vec_ident = m0 + P <= m && n % PER == 0 &&
                         (reinterpret_cast<uintptr_t>(table) & 15) == 0;

  auto fetch_weights = [&](int t, int slot) {
    const char* src = reinterpret_cast<const char*>(w9 + (int64_t)t * p.coutp * p.kp);
    const uint32_t dst = gg::smem_u32(wring + slot * wbytes);
    for (int e = tid; e < p.coutp * rw.r; e += kThreads)
      gg::cp_async16(dst + 16 * rw.chunk(rw.row_of(e), rw.col_of(e)), src + 16 * e);
  };
  auto stage_identity = [&]() {
    const uint32_t dst = gg::smem_u32(buf);
    for (int e = tid; e < p.rows * rb.r; e += kThreads) {
      const int lr = rb.row_of(e), ch = rb.col_of(e);
      const int64_t gr = (int64_t)z0 * p.c + lr;
      if (gr < wrows) {
        gg::cp_async16(dst + 16 * rb.chunk(lr, ch), tab + gr * n + m0 + ch * PER);
      } else {
        *reinterpret_cast<uint4*>(buf + 16 * rb.chunk(lr, ch)) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  // a thread stages the pair of columns 2*lane, 2*lane + 1 (sources s) of
  // rows warp + 8i: predicated loads, no branches
  auto load_pair = [&](int i, int2 s) -> R2 {
    const R* row = row0 + i * rstep;
    const bool in = i < nin;
    const R a = in && s.x >= 0 ? __ldg(row + s.x) : R(0);
    const R b = in && s.y >= 0 ? __ldg(row + s.y) : R(0);
    return pack2(a, b);
  };
  auto store_pair = [&](int i, R2 v) { *reinterpret_cast<R2*>(spair + i * sstep) = v; };
  // load and store rows i0, i0 + 1, ... of the thread, BATCH at a time
  auto stage_rows = [&](int i0, int2 s) {
    for (; i0 < nrow; i0 += BATCH) {
      R2 v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (i0 + i < nrow) v[i] = load_pair(i0 + i, s);
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (i0 + i < nrow) store_pair(i0 + i, v[i]);
    }
  };
  auto sources = [&](int t) {
    return *reinterpret_cast<const int2*>(src_s + t * kConvSrc + 2 * lane);
  };

  float acc[ZW][MT][4];
#pragma unroll
  for (int k = 0; k < ZW; ++k)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][mt][i] = 0.f;

  // this warp's products of the staged tap with the weights in `slot`:
  // staged row zl*C + kk holds haloed z (z0 + zl) + dz, channel ci for kk =
  // dz*C + ci, output z0 + zl's input through weight column kk
  auto multiply = [&](int slot) {
    const unsigned char* wt = wring + slot * wbytes;
    if constexpr (E == 2 && MT <= 2) {
      if (p.c % 16 == 0) {
        // each staged z level once: its k-chunk kc of 16 channels feeds output
        // z cells L - dz through the weights of dz, held for all three dz
        const uint32_t wbase = gg::smem_u32(wt), bbase = gg::smem_u32(buf);
        for (int kc = 0; kc < p.c / 16; ++kc) {
          uint32_t a[3][MT][4];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              gg::ldsm_x4(a[dz][mt], wbase + 16 * rw.chunk(16 * mt + (lane & 15),
                                                          (dz * p.c + 16 * kc) / 8 + (lane >> 4)));
#pragma unroll
          for (int lv = 0; lv < ZW + 2; ++lv) {
            if (lv < nzw + 2) {
              uint32_t b0, b1;
              gg::ldsm_x2_t(b0, b1, bbase + 16 * rb.chunk(lv * p.c + 16 * kc + (lane & 15), warp));
#pragma unroll
              for (int dz = 0; dz < 3; ++dz) {
                const int zo = lv - dz;
                if (zo >= 0 && zo < ZW && zo < nzw) {
#pragma unroll
                  for (int mt = 0; mt < MT; ++mt) gg::mma_bf16(acc[zo][mt], a[dz][mt], b0, b1);
                }
              }
            }
          }
        }
        return;
      }
    }
    if constexpr (E == 2) {
      const uint32_t wbase = gg::smem_u32(wt), bbase = gg::smem_u32(buf);
      for (int ks = 0; ks < p.kp / 16; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          gg::ldsm_x4(a[mt], wbase + 16 * rw.chunk(16 * mt + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
        for (int k = 0; k < ZW; ++k) {
          if (k < nzw) {
            uint32_t b0, b1;
            gg::ldsm_x2_t(b0, b1, bbase + 16 * rb.chunk(k * p.c + 16 * ks + (lane & 15), warp));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) gg::mma_bf16(acc[k][mt], a[mt], b0, b1);
          }
        }
      }
    } else {  // f32: the same fragments, multiplied with FFMA on the CUDA cores
      const float* wf = reinterpret_cast<const float*>(wt);
      const float* bf = reinterpret_cast<const float*>(buf);
      const int g = lane >> 2, nn = 8 * warp + 2 * (lane & 3);
      for (int kk = 0; kk < 3 * p.c; ++kk) {
        float a0[MT], a1[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a0[mt] = wf[rw.elem(16 * mt + g, kk, PER)];
          a1[mt] = wf[rw.elem(16 * mt + g + 8, kk, PER)];
        }
#pragma unroll
        for (int k = 0; k < ZW; ++k) {
          if (k < nzw) {
            const int row = k * p.c + kk;
            const float b0 = bf[rb.elem(row, nn, PER)], b1 = bf[rb.elem(row, nn + 1, PER)];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              acc[k][mt][0] = fmaf(a0[mt], b0, acc[k][mt][0]);
              acc[k][mt][1] = fmaf(a0[mt], b1, acc[k][mt][1]);
              acc[k][mt][2] = fmaf(a1[mt], b0, acc[k][mt][2]);
              acc[k][mt][3] = fmaf(a1[mt], b1, acc[k][mt][3]);
            }
          }
        }
      }
    }
  };

  // the present taps, the identity tap first (its rows come by cp.async),
  // then in order. Per tap, the next one's weights (cp.async) and first
  // rows (loads into registers) start before this tap's products, and the
  // rows are stored after them.
  auto pop = [&]() -> int {
    if (!left) return -1;
    const int t = identity >= 0 && (left >> identity & 1u) ? identity : __ffs(left) - 1;
    left &= ~(1u << t);
    return t;
  };
  int t = pop(), slot = 0;
  if (t >= 0) {
    fetch_weights(t, 0);
    if (t == identity && vec_ident) stage_identity();
    gg::cp_async_commit();
    if (!(t == identity && vec_ident)) stage_rows(0, sources(t));
  }
  while (t >= 0) {
    gg::cp_async_wait<0>();
    __syncthreads();  // tap t staged, its weights in `slot`
    const int tn = pop();
    const bool tn_async = tn == identity && vec_ident;
    int2 sn = make_int2(-1, -1);
    R2 ahead[AHEAD];
    if (tn >= 0) {
      fetch_weights(tn, slot ^ 1);
      gg::cp_async_commit();
      if (!tn_async) {
        sn = sources(tn);
#pragma unroll
        for (int i = 0; i < AHEAD; ++i)
          if (i < nrow) ahead[i] = load_pair(i, sn);
      }
    }
    multiply(slot);
    __syncthreads();  // every warp is done with the staged tap
    if (tn >= 0) {
      if (tn_async) {
        stage_identity();
        gg::cp_async_commit();
      } else {
#pragma unroll
        for (int i = 0; i < AHEAD; ++i)
          if (i < nrow) store_pair(i, ahead[i]);
        stage_rows(AHEAD, sn);
      }
    }
    t = tn;
    slot ^= 1;
  }

  // the sums, rounded to T, through a shared-memory tile ((zt*Cout, 64),
  // rows padded by 16 bytes), then along m with 16-byte stores
  const int os = P * E + 16;
  {
    const int g = lane >> 2, nn = 8 * warp + 2 * (lane & 3);
#pragma unroll
    for (int k = 0; k < ZW; ++k) {
      if (k < nzw) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = 16 * mt + g + 8 * h;
            if (co < p.cout)
              gg::store2(reinterpret_cast<T*>(buf + (k * p.cout + co) * os) + nn,
                         acc[k][mt][2 * h], acc[k][mt][2 * h + 1]);
          }
      }
    }
  }
  __syncthreads();
  const int chunks = P / PER;
  const bool vec_out = m % PER == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int e = tid; e < nzw * p.cout * chunks; e += kThreads) {
    const int row = e / chunks, ch = e % chunks;
    const int c = ch * PER;
    if (c >= ncols) continue;
    const unsigned char* src = buf + row * os + ch * 16;
    T* dst = out + ((int64_t)z0 * p.cout + row) * m + m0 + c;
    if (vec_out && c + PER <= ncols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < PER && c + k < ncols; ++k) dst[k] = reinterpret_cast<const T*>(src)[k];
    }
  }
}

template <typename T, int MT>
int launch_gather9_conv(const void* table, const int32_t* idx, const void* w9, void* out,
                        int64_t n, int64_t m, const ConvTPlan& p, int identity,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gather9_conv_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0 && p.grid_x > 0 && p.grid_y > 0) {
    gather9_conv_kernel<T, MT><<<dim3(p.grid_x, p.grid_y), kThreads, p.smem, stream>>>(
        (const T*)table, idx, (const T*)w9, (T*)out, n, m, p, identity);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_gather9_conv(const void* table, const int32_t* idx, const void* w9, void* out,
                          int64_t n, int64_t m, const ConvTPlan& p, int identity,
                          cudaStream_t stream) {
  switch (p.coutp) {
    case 16: return launch_gather9_conv<T, 1>(table, idx, w9, out, n, m, p, identity, stream);
    case 32: return launch_gather9_conv<T, 2>(table, idx, w9, out, n, m, p, identity, stream);
    case 64: return launch_gather9_conv<T, 4>(table, idx, w9, out, n, m, p, identity, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// K5's launch: a block takes up to 512 cells, fewer where their staged
// rows would pass 48 KB of shared memory.
template <typename T>
int launch_unpack(const float* sums, T* out, int64_t ncell, int c, int cpad,
                  cudaStream_t stream) {
  auto smem = [&](int cells) {
    return (((size_t)cells * (c + 1) + 4) * 4 + 15) / 16 * 16 +
           ((size_t)cells * cpad + 16 / sizeof(T)) * sizeof(T);
  };
  int cells = 512;
  while (cells > 32 && smem(cells) > (48 << 10)) cells /= 2;
  const size_t bytes = smem(cells);
  if (bytes > (48 << 10)) {
    cudaError_t err = cudaFuncSetAttribute(
        unpack_pillars_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (ncell + cells - 1) / cells;
  unpack_pillars_kernel<T><<<(unsigned)blocks, kThreads, bytes, stream>>>(sums, out, ncell, c,
                                                                          cpad, cells);
  return (int)cudaGetLastError();
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
  if (ncell * cpad == 0) return (int)cudaGetLastError();
  return dtype == 0 ? launch_unpack(sums, (float*)out, ncell, c, cpad, stream)
                    : launch_unpack(sums, (__nv_bfloat16*)out, ncell, c, cpad, stream);
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

// K7 and K8. table: (w, n) of elem_bytes (2 or 4) elements; idx: (m, ntap);
// out: tap t of table row r = j*chunk + rr at row j*ntap*chunk + t*chunk + rr
// of (ntap*w, m) (chunk 0: (ntap, w, m)); identity: the tap that copies
// column m of the table (-1 for none; the caller passes it only when m ==
// n); rows: table rows a block takes, a multiple of 16.
int toda_gather_cols(const void* table, const int32_t* idx, void* out, int64_t n, int64_t m,
                     int ntap, int w, int elem_bytes, int chunk, int identity, int rows,
                     cudaStream_t stream) {
  if (ntap > 9 || rows <= 0 || rows % kBatchRows || n >= (int64_t(1) << 27))
    return (int)cudaErrorInvalidValue;
  return launch_gather_cols(table, idx, out, n, m, ntap, w, elem_bytes, chunk, identity, rows,
                            stream);
}

int toda_gather9_conv_plan_fields() { return kConvPlanFields; }

// K10. table: (w = (nz+2)*c, n) of dtype (0 = float32, 1 = bfloat16), zero z
// halo included; idx: (m, 9); w9: (9, coutp, kp) in the table's type,
// w9[t][co][dz*c + ci] = weights[dz][t/3][t%3][ci][co], zero past cout and
// 3c; out: (nz*cout, m) in the table's type; plan: kConvPlanFields ints
// (ConvTPlan); identity: the tap that reads column m itself (-1 for none;
// the caller passes it only when m == n).
int toda_gather9_conv_t(const void* table, const int32_t* idx, const void* w9, void* out,
                        int64_t n, int64_t m, const int32_t* plan, int identity, int dtype,
                        cudaStream_t stream) {
  ConvTPlan p;
  int* fields = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kConvPlanFields; ++i) fields[i] = plan[i];
  if (p.rows % kWarps || p.zt * p.coutp > 16 * kConvAcc) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_gather9_conv<float>(table, idx, w9, out, n, m, p, identity, stream);
  return dispatch_gather9_conv<__nv_bfloat16>(table, idx, w9, out, n, m, p, identity, stream);
}

}  // extern "C"
