// Backward of the fused (affine + relu) -> 3x3x3 sparse pillar convolution
// (K2, and K3 through the dW kernel with act = 0), for Hopper (sm_90a).
//
// Replaces toda_tpu/ops/pallas_fused_conv.py _bwd_kernel (launched by
// _call_bwd; the backward of fused_bnconv9_t), which computes dx, dW and the
// per-channel sums behind dscale / dshift in one kernel, and _dw_kernel
// (launched by _call_dw), which computes dW alone for a raw-input layer.
// The forward (fused_conv.cu) is
//
//   y[m, zo, co] = sum_{t<9} sum_{dz<3} sum_{c<C}
//                  a(idx[m, t], s*zo + dz - 1, c) * w[dz, t/3, t%3, c, co]
//
// with a(j, z, c) = 0 where j == -1 or z is outside [0, nz_in), else
// relu(x[j, z, c] * scale[c] + shift[c]) rounded to the activation type when
// act, else x[j, z, c]. Activations are row-major (M, nz, C).
//
// toda_bnconv9_bwd_dx: the input cotangent. Column t of the inverse table
// invf (M_in, 9) holds the output row m with idx[m, t] == j (or -1), so
//   h[j, z, c] = sum_t sum_{dz, zo: s*zo + dz - 1 == z} sum_co
//                gy[invf[j, t], zo, co] * w[dz, t/3, t%3, c, co]
// and then g = h where a(j, z, c) > 0 (act) else h; dx = g * scale[c] (act)
// or g. With act it also writes, per block, the f32 sums over its rows of
// g * x and of g for each channel: summed over blocks they are dscale and
// dshift. One block of 256 threads owns TM input pillars and a tile of ZT
// input z cells. For each tap it stages in shared memory that tap's weights,
// transposed to (3, Cout, C) f32, and the TM gathered gy columns on an
// "upsampled" z axis z' = z0 - 1 .. z0 + ZT (entry z' holds gy[., z'/s] when
// s divides z' and 0 otherwise), so that every (row, dz) pair reads the same
// shape of data; at stride 2 half the staged rows are zeros. Each thread owns
// one input channel and R = 16 rows (pillar, z) and keeps their f32 sums in
// registers across the 9 taps, reading four output channels at a time.
// The per-block channel sums are reduced in shared memory in a fixed order.
//
// toda_bnconv9_dw_partial + toda_bnconv9_dw_reduce: the weight cotangent
//   dW[dz, t, c, co] = sum_{m, zo} a(idx[m, t], s*zo + dz - 1, c) * gy[m, zo, co]
// summed deterministically. The grid is (T fixed row tiles) x (9 taps). Tile
// i walks a fixed contiguous range of chunks of TM output pillars x ZT output
// z cells; per chunk it stages the activated gathered input columns of its
// tap (as the forward does, zero z halo included) and the chunk's gy rows.
// A thread owns a 4 x 4 (c, co) tile for all three dz (48 f32 sums in
// registers); when C * Cout / 16 < 256 the chunk's rows are split among
// 256 / (C * Cout / 16) thread groups, whose sums are added in shared memory
// in group order. Each block writes its (3, C, Cout) tap slice of a per-tile
// partial dW; the reduce kernel adds the T partials in tile order. No float
// atomics anywhere, so two runs give bit-identical dW.
//
// Bound. With every neighbour present: operations, 2*27*C*Cout flops per
// output value for each of dx and dW, at the bf16 tensor-core peak. Where
// most neighbours are missing (the synthetic scenes fill ~2% of BEV cells)
// bytes bound both: x, gy and the tables are read once, dx and dW written
// once. Like the forward, these kernels multiply the empty taps' zero rows
// on the CUDA cores in f32; skipping empty taps and tensor cores
// (mma.sync / wgmma) are the next steps (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;         // dx: input rows (pillar, z) per thread
constexpr int kDwChunkRows = 128;  // dW: output rows (pillar, z) per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x * scale + shift with the product and the sum each rounded to f32 (no
// fused multiply-add), as the plain PyTorch versions compute it, so that the
// relu mask agrees with theirs bit for bit.
__device__ __forceinline__ float affine(float v, float sc, float sh) {
  return __fadd_rn(__fmul_rn(v, sc), sh);
}

// The activation the forward applies to a gathered input value.
template <typename T>
__device__ __forceinline__ float activate(float v, float sc, float sh, int act) {
  return act ? to_f32(from_f32<T>(fmaxf(affine(v, sc, sh), 0.f))) : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bnconv9_bwd_dx_kernel(const T* __restrict__ gy, const T* __restrict__ x,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      const T* __restrict__ w, const int32_t* __restrict__ invf,
                      T* __restrict__ dx, float* __restrict__ part_gx,
                      float* __restrict__ part_g, int m_in, int nz_in, int nz_out,
                      int c, int cout, int stride, int act, int tm, int zt) {
  extern __shared__ __align__(16) float smem[];
  const int nzt = zt + 2;  // staged z' rows of one z tile
  const int wtap = 3 * cout * c;
  float* ws = smem;         // (3, Cout, C): w[dz, t, c, co] transposed
  float* gs = smem + wtap;  // (TM, ZT + 2, Cout) gathered, upsampled gy

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * tm;
  const int z0 = blockIdx.y * zt;
  const int ci = tid % c;
  const int row_lanes = kThreads / c;
  const int lane_row = tid / c;
  const int nrows = tm * zt;

  int base[kRows];
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    int r = lane_row + k * row_lanes;
    if (r >= nrows) r = 0;  // computed, never stored
    const int p = r / zt;
    const int zl = r - p * zt;
    base[k] = (p * nzt + zl) * cout;
    acc[k] = 0.f;
  }

  const int ccout = c * cout;
  const int col_elems = nzt * cout;
  const int tile_elems = tm * col_elems;
  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's products are done with ws / gs
    for (int e = tid; e < wtap; e += kThreads) {
      const int dz = e / ccout;
      const int rem = e - dz * ccout;
      const int co = rem / c;
      const int cc = rem - co * c;
      ws[e] = to_f32(w[((int64_t)(dz * 9 + t) * c + cc) * cout + co]);
    }
    for (int e = tid; e < tile_elems; e += kThreads) {
      const int p = e / col_elems;
      const int rem = e - p * col_elems;
      const int u = rem / cout;
      const int co = rem - u * cout;
      const int m = m0 + p;
      const int zp = z0 - 1 + u;
      float v = 0.f;
      if (m < m_in && zp >= 0 && zp % stride == 0 && zp / stride < nz_out) {
        const int32_t j = invf[(int64_t)m * 9 + t];
        if (j >= 0) v = to_f32(gy[((int64_t)j * nz_out + zp / stride) * cout + co]);
      }
      gs[e] = v;
    }
    __syncthreads();
    for (int dz = 0; dz < 3; ++dz) {
      const float* wrow = ws + dz * ccout + ci;
      const float* grow = gs + (2 - dz) * cout;  // z' = z + 1 - dz
      for (int co4 = 0; co4 < cout; co4 += 4) {
        const float w0 = wrow[(co4 + 0) * c];
        const float w1 = wrow[(co4 + 1) * c];
        const float w2 = wrow[(co4 + 2) * c];
        const float w3 = wrow[(co4 + 3) * c];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float4 g = *reinterpret_cast<const float4*>(grow + base[k] + co4);
          float s = acc[k];
          s = fmaf(g.x, w0, s);
          s = fmaf(g.y, w1, s);
          s = fmaf(g.z, w2, s);
          s = fmaf(g.w, w3, s);
          acc[k] = s;
        }
      }
    }
  }

  const float sc = act ? scale[ci] : 1.f;
  const float sh = act ? shift[ci] : 0.f;
  float sum_gx = 0.f, sum_g = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = lane_row + k * row_lanes;
    if (r < nrows) {
      const int p = r / zt;
      const int zl = r - p * zt;
      const int m = m0 + p;
      const int z = z0 + zl;
      if (m < m_in && z < nz_in) {
        const int64_t off = ((int64_t)m * nz_in + z) * c + ci;
        float g = acc[k];
        if (act) {
          const float xv = to_f32(x[off]);
          const float a = to_f32(from_f32<T>(affine(xv, sc, sh)));
          if (!(a > 0.f)) g = 0.f;
          sum_gx += g * xv;
          sum_g += g;
          dx[off] = from_f32<T>(g * sc);
        } else {
          dx[off] = from_f32<T>(g);
        }
      }
    }
  }
  if (!act) return;
  __syncthreads();  // everyone is done with ws / gs
  float* red = smem;  // (2, kThreads)
  red[tid] = sum_gx;
  red[kThreads + tid] = sum_g;
  __syncthreads();
  if (tid < c) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < row_lanes; ++l) {
      a += red[l * c + tid];
      b += red[kThreads + l * c + tid];
    }
    const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    part_gx[blk * c + tid] = a;
    part_g[blk * c + tid] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bnconv9_dw_partial_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ shift, const int32_t* __restrict__ idx,
                          const T* __restrict__ gy, float* __restrict__ part, int m_out,
                          int nz_in, int nz_out, int c, int cout, int stride, int act,
                          int tm, int zt, int chunks_per_tile) {
  extern __shared__ __align__(16) float smem[];
  const int nzt_in = stride * (zt - 1) + 3;  // input z rows one z tile reads
  const int x_elems = tm * nzt_in * c;
  const int g_elems = tm * zt * cout;
  float* xs = smem;                      // (TM, nzt_in, C) activated inputs
  float* gys = smem + x_elems;           // (TM, ZT, Cout) gy rows
  float* red = smem + x_elems + g_elems;  // (kThreads, 16) group sums

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int t = blockIdx.y;
  const int cq = cout / 4;
  const int ntile_cc = (c / 4) * cq;
  const int ksplit = kThreads / ntile_cc;
  const int tt = tid % ntile_cc;
  const int kg = tid / ntile_cc;
  const int c4 = (tt / cq) * 4;
  const int co4 = (tt % cq) * 4;
  const int nzc = (nz_out + zt - 1) / zt;  // z chunks per pillar chunk
  const int nchunks = ((m_out + tm - 1) / tm) * nzc;
  const int nrows = tm * zt;

  float acc[3][4][4];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[dz][i][j] = 0.f;

  const int chunk_lo = tile * chunks_per_tile;
  const int chunk_hi = min(nchunks, chunk_lo + chunks_per_tile);
  const int x_col = nzt_in * c;
  const int g_col = zt * cout;
  for (int chunk = chunk_lo; chunk < chunk_hi; ++chunk) {
    const int m0 = (chunk / nzc) * tm;
    const int z0 = (chunk % nzc) * zt;
    const int zlo = stride * z0 - 1;
    __syncthreads();  // the previous chunk's products are done with xs / gys
    for (int e = tid; e < x_elems; e += kThreads) {
      const int p = e / x_col;
      const int rem = e - p * x_col;
      const int zz = rem / c;
      const int cc = rem - zz * c;
      const int m = m0 + p;
      const int z = zlo + zz;
      float v = 0.f;
      if (m < m_out && z >= 0 && z < nz_in) {
        const int32_t j = idx[(int64_t)m * 9 + t];
        if (j >= 0) {
          v = activate<T>(to_f32(x[((int64_t)j * nz_in + z) * c + cc]),
                          act ? scale[cc] : 1.f, act ? shift[cc] : 0.f, act);
        }
      }
      xs[e] = v;
    }
    for (int e = tid; e < g_elems; e += kThreads) {
      const int p = e / g_col;
      const int rem = e - p * g_col;
      const int zl = rem / cout;
      const int co = rem - zl * cout;
      const int m = m0 + p;
      const int zo = z0 + zl;
      gys[e] = (m < m_out && zo < nz_out)
                   ? to_f32(gy[((int64_t)m * nz_out + zo) * cout + co]) : 0.f;
    }
    __syncthreads();
    for (int r = kg; r < nrows; r += ksplit) {
      const int p = r / zt;
      const int zl = r - p * zt;
      const float4 g = *reinterpret_cast<const float4*>(gys + r * cout + co4);
      const float* xrow = xs + (p * nzt_in + stride * zl) * c + c4;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float4 a = *reinterpret_cast<const float4*>(xrow + dz * c);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[dz][i][0] = fmaf(av[i], g.x, acc[dz][i][0]);
          acc[dz][i][1] = fmaf(av[i], g.y, acc[dz][i][1]);
          acc[dz][i][2] = fmaf(av[i], g.z, acc[dz][i][2]);
          acc[dz][i][3] = fmaf(av[i], g.w, acc[dz][i][3]);
        }
      }
    }
  }

  // add the row groups' sums in group order and write this tap's slice
  const int64_t ccout = (int64_t)c * cout;
  float* out = part + (int64_t)tile * 27 * ccout;
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    __syncthreads();  // xs / gys products, or the previous dz's reads, are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[tid * 16 + i * 4 + j] = acc[dz][i][j];
    __syncthreads();
    float* slice = out + (int64_t)(dz * 9 + t) * ccout;
    for (int e = tid; e < ccout; e += kThreads) {
      const int cc = (int)(e / cout);
      const int co = (int)(e - (int64_t)cc * cout);
      const int q = (cc / 4) * cq + co / 4;
      const int ij = (cc % 4) * 4 + co % 4;
      float s = 0.f;
      for (int g = 0; g < ksplit; ++g) s += red[(g * ntile_cc + q) * 16 + ij];
      slice[e] = s;
    }
  }
}

__global__ void bnconv9_dw_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ dw, int64_t n, int tiles) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < tiles; ++i) s += part[(int64_t)i * n + e];
  dw[e] = s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t dx_smem(int c, int cout, int tm, int zt) {
  const size_t main = sizeof(float) * ((size_t)3 * cout * c + (size_t)tm * (zt + 2) * cout);
  const size_t red = sizeof(float) * 2 * kThreads;
  return main > red ? main : red;
}

size_t dw_smem(int c, int cout, int stride, int tm, int zt) {
  const size_t nzt_in = (size_t)stride * (zt - 1) + 3;
  return sizeof(float) * ((size_t)tm * nzt_in * c + (size_t)tm * zt * cout + 16 * kThreads);
}

template <typename T>
cudaError_t launch_dx(const void* gy, const void* x, const float* scale,
                      const float* shift, const void* w, const int32_t* invf, void* dx,
                      float* part_gx, float* part_g, int m_in, int nz_in, int nz_out,
                      int c, int cout, int stride, int act, int tm, int zt,
                      cudaStream_t stream) {
  const size_t smem = dx_smem(c, cout, tm, zt);
  cudaError_t err = set_smem(bnconv9_bwd_dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m_in + tm - 1) / tm, (nz_in + zt - 1) / zt);
  bnconv9_bwd_dx_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)gy, (const T*)x, scale, shift, (const T*)w, invf, (T*)dx, part_gx,
      part_g, m_in, nz_in, nz_out, c, cout, stride, act, tm, zt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const float* scale, const float* shift,
                      const int32_t* idx, const void* gy, float* part, float* dw,
                      int m_out, int nz_in, int nz_out, int c, int cout, int stride,
                      int act, int tm, int zt, int tiles, cudaStream_t stream) {
  const size_t smem = dw_smem(c, cout, stride, tm, zt);
  cudaError_t err = set_smem(bnconv9_dw_partial_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nzc = (nz_out + zt - 1) / zt;
  const int nchunks = ((m_out + tm - 1) / tm) * nzc;
  const int per_tile = (nchunks + tiles - 1) / tiles;
  dim3 grid(tiles, 9);
  bnconv9_dw_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, scale, shift, idx, (const T*)gy, part, m_out, nz_in, nz_out, c, cout,
      stride, act, tm, zt, per_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)27 * c * cout;
  bnconv9_dw_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                             stream>>>(part, dw, n, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per block, input rows per dx thread and output rows per dW chunk:
// the wrapper derives the tilings and the scratch sizes from them.
int toda_bnconv9_bwd_geometry(int* threads, int* dx_rows, int* dw_chunk_rows) {
  *threads = kThreads;
  *dx_rows = kRows;
  *dw_chunk_rows = kDwChunkRows;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (gy, x, w and dx share it). part_gx /
// part_g: (grid blocks, C) f32, written only when act.
int toda_bnconv9_bwd_dx(const void* gy, const void* x, const float* scale,
                        const float* shift, const void* w, const int32_t* invf, void* dx,
                        float* part_gx, float* part_g, int m_in, int nz_in, int nz_out,
                        int c, int cout, int stride, int act, int tm, int zt, int dtype,
                        cudaStream_t stream) {
  if (m_in <= 0 || nz_in <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    return (int)launch_dx<float>(gy, x, scale, shift, w, invf, dx, part_gx, part_g, m_in,
                                 nz_in, nz_out, c, cout, stride, act, tm, zt, stream);
  }
  return (int)launch_dx<__nv_bfloat16>(gy, x, scale, shift, w, invf, dx, part_gx, part_g,
                                       m_in, nz_in, nz_out, c, cout, stride, act, tm, zt,
                                       stream);
}

// dtype: 0 = float32, 1 = bfloat16 (x and gy). part: (tiles, 27, C, Cout)
// f32 scratch; dw: (27, C, Cout) f32 = (3, 3, 3, C, Cout).
int toda_bnconv9_dw(const void* x, const float* scale, const float* shift,
                    const int32_t* idx, const void* gy, float* part, float* dw, int m_out,
                    int nz_in, int nz_out, int c, int cout, int stride, int act, int tm,
                    int zt, int tiles, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    return (int)launch_dw<float>(x, scale, shift, idx, gy, part, dw, m_out, nz_in, nz_out,
                                 c, cout, stride, act, tm, zt, tiles, stream);
  }
  return (int)launch_dw<__nv_bfloat16>(x, scale, shift, idx, gy, part, dw, m_out, nz_in,
                                       nz_out, c, cout, stride, act, tm, zt, tiles, stream);
}

}  // extern "C"
