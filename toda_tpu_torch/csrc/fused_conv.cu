// Fused (affine + relu) -> 3x3x3 sparse pillar convolution, forward (K1),
// for Hopper (sm_90a).
//
// Replaces toda_tpu/ops/pallas_fused_conv.py _fwd_kernel (launched by
// _call_fwd; public fused_bnconv9_t). Same function, port layout:
//
//   y[m, zo, co] = sum_{t<9} sum_{dz<3} sum_{c<C}
//                  a(idx[m, t], s*zo + dz - 1, c) * w[dz, t/3, t%3, c, co]
//
// with a(j, z, c) = 0 where j == -1 or z is outside [0, nz_in), else
// relu(x[j, z, c] * scale[c] + shift[c]) rounded to the activation type when
// act, else x[j, z, c]. x is (M_in, nz_in, C) row-major, so one gathered
// neighbour is nz_in*C contiguous values; y is (M_out, nz_out, Cout).
//
// Design. The TPU kernel's span windows, one-hot MXU row selection, banded
// z-group weights and 128-lane alignment exist because a TPU core cannot
// gather rows cheaply; a Hopper block loads its rows directly. One block of
// 256 threads owns TM output pillars and a tile of ZT output z cells. For
// each of the 9 BEV taps it stages, in shared memory, (a) that tap's weights
// w[:, dy, dx] as f32 (3*C*Cout values: a tap row at a time, so C = Cout = 64
// needs 48 KB, not the 221 KB of all 27 taps) and (b) the TM gathered
// neighbour columns with the activation applied and the zero z halo. Every
// thread owns one output channel and R = 16 output rows (pillar, z), keeps
// their f32 sums in registers across all taps, and reads activations four
// channels at a time (one 16-byte shared load, broadcast across the threads
// of the row) against four weights. The product runs on the CUDA cores in
// f32; tensor cores (mma.sync / wgmma) and TMA staging are a later step.
// Bound: with every neighbour present, operations: 2*27*C*Cout flops per
// output value against (M_in*nz_in*C + M_out*nz_out*Cout) elements moved,
// at the bf16 tensor-core peak. Where most neighbours are missing (the
// synthetic scenes fill ~2% of BEV cells) the work the data needs is small
// and bytes bound it; this kernel still multiplies the empty taps' zero
// rows, and its CUDA-core products reach neither bound (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // output rows (pillar, z) per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_bnconv9_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ shift, const T* __restrict__ w,
                     const int32_t* __restrict__ idx, T* __restrict__ y,
                     int m_out, int nz_in, int nz_out, int c, int cout,
                     int stride, int act, int tm, int zt) {
  extern __shared__ __align__(16) float smem[];
  const int nzt_in = stride * (zt - 1) + 3;  // input z rows one z tile reads
  const int wtap = 3 * c * cout;
  float* ws = smem;          // (3, C, Cout) weights of the current tap
  float* xs = smem + wtap;   // (TM, nzt_in, C) activated neighbour rows

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * tm;
  const int z0 = blockIdx.y * zt;
  const int zlo = stride * z0 - 1;
  const int co = tid % cout;
  const int row_lanes = kThreads / cout;
  const int lane_row = tid / cout;
  const int nrows = tm * zt;

  int base[kRows];
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    int r = lane_row + k * row_lanes;
    if (r >= nrows) r = 0;  // computed, never stored
    const int p = r / zt;
    const int zl = r - p * zt;
    base[k] = (p * nzt_in + stride * zl) * c;
    acc[k] = 0.f;
  }

  const int col_elems = nzt_in * c;
  const int tile_elems = tm * col_elems;
  const int64_t ccout = (int64_t)c * cout;
  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's products are done with ws / xs
    for (int e = tid; e < wtap; e += kThreads) {
      const int dz = (int)(e / ccout);
      const int64_t rem = e - dz * ccout;
      ws[e] = to_f32(w[(int64_t)(dz * 9 + t) * ccout + rem]);
    }
    for (int e = tid; e < tile_elems; e += kThreads) {
      const int p = e / col_elems;
      const int rem = e - p * col_elems;
      const int zz = rem / c;
      const int cc = rem - zz * c;
      const int m = m0 + p;
      const int z = zlo + zz;
      float v = 0.f;
      if (m < m_out && z >= 0 && z < nz_in) {
        const int32_t j = idx[(int64_t)m * 9 + t];
        if (j >= 0) {
          v = to_f32(x[((int64_t)j * nz_in + z) * c + cc]);
          if (act) v = to_f32(from_f32<T>(fmaxf(v * scale[cc] + shift[cc], 0.f)));
        }
      }
      xs[e] = v;
    }
    __syncthreads();
    for (int dz = 0; dz < 3; ++dz) {
      const float* wrow = ws + dz * c * cout + co;
      const float* xrow = xs + dz * c;
      for (int c4 = 0; c4 < c; c4 += 4) {
        const float w0 = wrow[(c4 + 0) * cout];
        const float w1 = wrow[(c4 + 1) * cout];
        const float w2 = wrow[(c4 + 2) * cout];
        const float w3 = wrow[(c4 + 3) * cout];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(xrow + base[k] + c4);
          float s = acc[k];
          s = fmaf(a.x, w0, s);
          s = fmaf(a.y, w1, s);
          s = fmaf(a.z, w2, s);
          s = fmaf(a.w, w3, s);
          acc[k] = s;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = lane_row + k * row_lanes;
    if (r < nrows) {
      const int p = r / zt;
      const int zl = r - p * zt;
      const int m = m0 + p;
      const int zo = z0 + zl;
      if (m < m_out && zo < nz_out) {
        y[((int64_t)m * nz_out + zo) * cout + co] = from_f32<T>(acc[k]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   const void* w, const int32_t* idx, void* y, int m_out,
                   int nz_in, int nz_out, int c, int cout, int stride, int act,
                   int tm, int zt, cudaStream_t stream) {
  const int nzt_in = stride * (zt - 1) + 3;
  const size_t smem = sizeof(float) * ((size_t)3 * c * cout + (size_t)tm * nzt_in * c);
  cudaError_t err = cudaFuncSetAttribute(fused_bnconv9_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m_out + tm - 1) / tm, (nz_out + zt - 1) / zt);
  fused_bnconv9_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, scale, shift, (const T*)w, idx, (T*)y, m_out, nz_in, nz_out,
      c, cout, stride, act, tm, zt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads per block and output rows per thread: the wrapper derives the
// (TM, ZT) tiling from them.
int toda_fused_bnconv9_geometry(int* threads, int* rows) {
  *threads = kThreads;
  *rows = kRows;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it). scale/shift f32.
int toda_fused_bnconv9(const void* x, const float* scale, const float* shift,
                       const void* w, const int32_t* idx, void* y, int m_out,
                       int nz_in, int nz_out, int c, int cout, int stride,
                       int act, int tm, int zt, int dtype, cudaStream_t stream) {
  if (m_out <= 0 || nz_out <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    return (int)launch<float>(x, scale, shift, w, idx, y, m_out, nz_in, nz_out,
                              c, cout, stride, act, tm, zt, stream);
  }
  return (int)launch<__nv_bfloat16>(x, scale, shift, w, idx, y, m_out, nz_in,
                                    nz_out, c, cout, stride, act, tm, zt, stream);
}

}  // extern "C"
