// Building blocks of the fused sparse pillar convolution kernels
// (fused_conv.cu: K1; fused_conv_bwd.cu: K2's dx and dW, K3): 16-byte
// cp.async staging, shared-memory row layouts, ldmatrix + mma.sync for bf16
// and the gather-GEMM core that K1 and dx share.
//
// The gather-GEMM core. One warp owns one destination pillar (its whole z
// column and the block's slice of output channels) and keeps the f32 sums in
// registers across the pillar's taps. It reads the pillar's 9 table entries
// and loops only over the taps that are present (table entry >= 0). Per
// present tap it copies the gathered source column (n_src rows of `width`
// contiguous values) into a per-warp shared buffer with 16-byte cp.async,
// placing source row r at buffer row place*r + 1 (the zero rows around and
// between stay zero), in a ring of 2-4 buffers, so that the next present
// taps' columns load while this one multiplies. Output row i then reads the
// 3*width contiguous buffer values starting at row astride*i: the three dz
// taps are the im2col of the buffer with no copy, a (rows x 3*width) .
// (3*width x N) product per tap. The rows of a 16-row tile past the output's
// last read row 0, which is always zero.
//   K1:  source x (nz_in rows of C), place 1, astride s, N = Cout.
//   dx:  source gy (nz_out rows of Cout), place s (the upsampled z axis),
//        astride 1, N = C, the weights transposed.
// bf16 multiplies on the tensor cores (mma.sync m16n8k16, f32 sums); f32
// keeps the same staging and fragment layout and multiplies with FFMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gg {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x * scale + shift with the product and the sum each rounded to f32 (no
// fused multiply-add), as the plain PyTorch versions compute it, so that a
// relu mask agrees with theirs bit for bit.
__device__ __forceinline__ float affine(float v, float sc, float sh) {
  return __fadd_rn(__fmul_rn(v, sc), sh);
}

// The forward's activation of a gathered input value, rounded to T.
template <typename T>
__device__ __forceinline__ float activate(float v, float sc, float sh) {
  return to_f32(from_f32<T>(fmaxf(affine(v, sc, sh), 0.f)));
}

// Two adjacent values of a T row, as f32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most stages - 1 copy groups are pending (a ring of stages)
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4) {
    cp_async_wait<3>();
  } else if (stages == 3) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<1>();
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d += a . b, one 16x8x16 bf16 tile with f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rows of a staged buffer: r 16-byte chunks of data per row. Where r is
// a power of two (and `swizzle`) the chunk index is XOR-swizzled by the row's
// low three bits, so that the eight consecutive rows one ldmatrix reads fall
// in distinct banks; otherwise an even r is padded to an odd stride.
// (ops/fused_conv.py row_stride mirrors this stride.)
struct Rows {
  int r, stride, lg;  // lg: log2(r) when swizzled, else -1
  __device__ __forceinline__ explicit Rows(int chunks, bool swizzle = true) : r(chunks) {
    const bool pow2 = (chunks & (chunks - 1)) == 0;
    lg = (swizzle && pow2) ? __ffs(chunks) - 1 : -1;
    stride = (lg >= 0 || (chunks & 1)) ? chunks : chunks + 1;
  }
  __device__ __forceinline__ int swz(int row) const {
    return lg < 0 ? 0 : lg >= 3 ? (row & 7) : (row >> (3 - lg)) & (r - 1);
  }
  // 16-byte chunk offset of chunk ch of row `row`
  __device__ __forceinline__ int chunk(int row, int ch) const {
    return row * stride + (ch ^ swz(row));
  }
  // row and chunk of the e-th chunk of rows of r chunks laid end to end
  __device__ __forceinline__ int row_of(int e) const { return lg >= 0 ? e >> lg : e / r; }
  __device__ __forceinline__ int col_of(int e) const { return lg >= 0 ? e & (r - 1) : e % r; }
  // element offset of element e (of `per` per chunk) of row `row`
  __device__ __forceinline__ int elem(int row, int e, int per) const {
    return chunk(row, e / per) * per + e % per;
  }
};

// Apply the forward's activation in place to one staged 16-byte chunk whose
// first channel is c0.
__device__ __forceinline__ void activate_chunk(float* q, const float* sc, const float* sh,
                                               int c0) {
  float4 v = *reinterpret_cast<float4*>(q);
  v.x = activate<float>(v.x, sc[c0], sh[c0]);
  v.y = activate<float>(v.y, sc[c0 + 1], sh[c0 + 1]);
  v.z = activate<float>(v.z, sc[c0 + 2], sh[c0 + 2]);
  v.w = activate<float>(v.w, sc[c0 + 3], sh[c0 + 3]);
  *reinterpret_cast<float4*>(q) = v;
}
__device__ __forceinline__ void activate_chunk(__nv_bfloat16* q, const float* sc,
                                               const float* sh, int c0) {
  uint4 v = *reinterpret_cast<uint4*>(q);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    const int c = c0 + 2 * i;
    __nv_bfloat162 o = __floats2bfloat162_rn(fmaxf(affine(f.x, sc[c], sh[c]), 0.f),
                                             fmaxf(affine(f.y, sc[c + 1], sh[c + 1]), 0.f));
    w[i] = *reinterpret_cast<uint32_t*>(&o);
  }
  *reinterpret_cast<uint4*>(q) = v;
}

// Arguments of the gather-GEMM core (see the header comment).
struct ConvArgs {
  const void* src;        // (m_src, n_src, width) T, gathered by the table
  const int32_t* table;   // (m_dst, 9) int32, -1 where a tap is missing
  const void* w;          // (3, 3, 3, C, Cout) T
  const float* scale;     // (C,) f32
  const float* shift;     // (C,) f32
  const void* x;          // dx: the forward's input (m_dst, n_out, C), for the relu mask
  void* out;              // (m_dst, n_out, n_total) T
  float* part;            // dx with act: (2, gridDim.x, C) f32 channel sums
  int m_dst, n_src, width, n_out, n_total, c, cout;
  int place, astride;     // buffer row of source row r: place*r + 1; of output row i: astride*i
  int kpad;               // 3*width rounded up to 16
  int n_blk;              // output channels of one block (gridDim.y slices)
  int buf_rows;           // rows of one staged buffer
  int stages;             // staged buffers per warp (2-4)
  int act;
};

// Shared memory of the core: scale and shift, the weights of all 9 taps
// for the block's channel slice, `stages` buffers per warp.
template <typename T, bool FWD>
struct ConvSmem {
  static constexpr int E = sizeof(T);
  float* sc;
  float* sh;
  unsigned char* w;
  unsigned char* bufs;
  Rows rw, ra;
  int wrows, buf_bytes;
  __device__ ConvSmem(unsigned char* base, const ConvArgs& p)
      : rw(FWD ? p.n_blk * E / 16 : p.kpad * E / 16, FWD), ra(p.width * E / 16) {
    sc = reinterpret_cast<float*>(base);
    sh = sc + p.c;
    w = base + ((2 * p.c * 4 + 127) / 128) * 128;
    wrows = 9 * (FWD ? p.kpad : p.n_blk);
    bufs = w + wrows * rw.stride * 16;
    buf_bytes = p.buf_rows * ra.stride * 16;
  }
};

// The core, one pillar per warp. FWD: K1 (the staged source is activated,
// the weights are K-major [t][dz*C + c][co]); else dx (the weights are
// N-major [t][c][dz'*Cout + co] with dz' = 2 - dz, and the epilogue applies
// the relu mask, the scale and the channel sums).
template <typename T, int MT, int NT, bool FWD>
__global__ void __launch_bounds__(kThreads, 2)
gather_conv_kernel(const ConvArgs p) {
  constexpr int E = sizeof(T);
  constexpr int PER = 16 / E;  // elements per chunk
  extern __shared__ __align__(128) unsigned char smem[];
  ConvSmem<T, FWD> s(smem, p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * p.n_blk;

  for (int i = tid; i < p.c; i += kThreads) {
    s.sc[i] = p.scale[i];
    s.sh[i] = p.shift[i];
  }
  // the weights of all 9 taps for this block's channels, once
  const char* wg = static_cast<const char*>(p.w);
  const int wchunks = s.wrows * s.rw.r;
  for (int e = tid; e < wchunks; e += kThreads) {
    const int row = s.rw.row_of(e), ch = s.rw.col_of(e);
    unsigned char* dst = s.w + 16 * s.rw.chunk(row, ch);
    const char* src = nullptr;
    if (FWD) {  // row = t*kpad + kk, kk = dz*C + c; chunk ch: 8 (4) output channels
      const int t = row / p.kpad, kk = row % p.kpad;
      if (kk < 3 * p.c) {
        const int dz = kk / p.c, c = kk % p.c;
        src = wg + ((((int64_t)(dz * 9 + t) * p.c + c) * p.cout + n0) * E + 16 * ch);
      }
    } else {  // row = t*n_blk + (c - n0); chunk ch: k = dz'*Cout + co
      const int t = row / p.n_blk, c = n0 + row % p.n_blk;
      const int cz = p.cout * E / 16, dzp = ch / cz, cc = ch % cz;
      if (dzp < 3) src = wg + (((int64_t)((2 - dzp) * 9 + t) * p.c + c) * p.cout * E + 16 * cc);
    }
    if (src) {
      cp_async16(smem_u32(dst), src);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
  // this warp's buffers to zero: the halo, gap and tail rows stay so
  unsigned char* mine = s.bufs + (int64_t)warp * p.stages * s.buf_bytes;
  for (int i = lane; i < p.stages * s.buf_bytes / 16; i += 32)
    reinterpret_cast<uint4*>(mine)[i] = make_uint4(0, 0, 0, 0);
  cp_async_wait<0>();
  __syncthreads();

  const char* srcg = static_cast<const char*>(p.src);
  const int64_t col_bytes = (int64_t)p.n_src * p.width * E;
  const int col_chunks = p.n_src * s.ra.r;
  auto issue = [&](int j, int b) {
    const char* col = srcg + (int64_t)j * col_bytes;
    const uint32_t base = smem_u32(mine + b * s.buf_bytes);
    for (int e = lane; e < col_chunks; e += 32)
      cp_async16(base + 16 * s.ra.chunk(p.place * s.ra.row_of(e) + 1, s.ra.col_of(e)),
                 col + 16 * e);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int g = lane >> 2, q = lane & 3;

  auto multiply = [&](int b, int t) {
    unsigned char* buf = mine + b * s.buf_bytes;
    if constexpr (E == 2) {
      // this lane's ldmatrix offsets: A's base row for each 16-row tile (-1
      // past n_out: those rows read the zero row 0), and the B offsets within a
      // 16-row k step of a tap (the swizzle repeats every 8 rows)
      int arow[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int i = mt * 16 + (lane & 15);
        arow[mt] = i < p.n_out ? p.astride * i : -1;
      }
      const int arl = s.ra.lg;  // the A rows are a power of two of chunks
      uint32_t boff[NT / 2 + 1];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        boff[np] = FWD ? 16 * s.rw.chunk(lane & 15, 2 * np + (lane >> 4))
                       : 16 * ((np * 16 + (lane & 7) + 8 * (lane >> 4)) * s.rw.stride +
                               ((lane >> 3) & 1));
      boff[NT / 2] = FWD ? 16 * s.rw.chunk(lane & 15, NT - 1)
                         : 16 * (((NT - 1) * 8 + (lane & 7)) * s.rw.stride + ((lane >> 3) & 1));

      const uint32_t abase = smem_u32(buf);
      const uint32_t wtap = smem_u32(s.w) + 16 * (FWD ? t * p.kpad * s.rw.stride
                                                     : t * p.n_blk * s.rw.stride);
      for (int ks = 0; ks < p.kpad / 16; ++ks) {
        uint32_t a[MT][4];
        const int q8 = 2 * ks + (lane >> 4);  // this lane's 8-value k chunk
        const int roff = q8 >> arl, ach = q8 & (s.ra.r - 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = arow[mt] < 0 ? 0 : arow[mt] + roff;
          ldsm_x4(a[mt], abase + 16 * s.ra.chunk(row, ach));
        }
        const uint32_t wk = wtap + (FWD ? 16 * 16 * ks * s.rw.stride : 32 * ks);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b4[4];
          if (FWD) {
            ldsm_x4_t(b4, wk + boff[np]);
          } else {
            ldsm_x4(b4, wk + boff[np]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b4[0], b4[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b4[2], b4[3]);
          }
        }
        if (NT & 1) {
          uint32_t b0, b1;
          if (FWD) {
            ldsm_x2_t(b0, b1, wk + boff[NT / 2]);
          } else {
            ldsm_x2(b0, b1, wk + boff[NT / 2]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b0, b1);
        }
      }
    } else {  // f32: the same fragments, multiplied with FFMA on the CUDA cores
      const float* af = reinterpret_cast<const float*>(buf);
      const float* wf = reinterpret_cast<const float*>(s.w);
      for (int kk = 0; kk < 3 * p.width; ++kk) {
        const int roff = kk / p.width, col = kk % p.width;
        float a0[MT], a1[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int i0 = mt * 16 + g, i1 = i0 + 8;
          a0[mt] = af[s.ra.elem(i0 < p.n_out ? p.astride * i0 + roff : 0, col, PER)];
          a1[mt] = af[s.ra.elem(i1 < p.n_out ? p.astride * i1 + roff : 0, col, PER)];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + 2 * q;
          float b0, b1;
          if (FWD) {
            const int row = t * p.kpad + kk;
            b0 = wf[s.rw.elem(row, n, PER)];
            b1 = wf[s.rw.elem(row, n + 1, PER)];
          } else {
            b0 = wf[s.rw.elem(t * p.n_blk + n, kk, PER)];
            b1 = wf[s.rw.elem(t * p.n_blk + n + 1, kk, PER)];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][0] = fmaf(a0[mt], b0, acc[mt][nt][0]);
            acc[mt][nt][1] = fmaf(a0[mt], b1, acc[mt][nt][1]);
            acc[mt][nt][2] = fmaf(a1[mt], b0, acc[mt][nt][2]);
            acc[mt][nt][3] = fmaf(a1[mt], b1, acc[mt][nt][3]);
          }
        }
      }
    }
  };

  // dx with act: this thread's f32 channel sums of g*x and g
  float sgx[NT][2], sg[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) sgx[nt][0] = sgx[nt][1] = sg[nt][0] = sg[nt][1] = 0.f;

  auto epilogue = [&](int pil) {
    const int64_t row0 = (int64_t)pil * p.n_out * p.n_total;
    T* out = static_cast<T*>(p.out) + row0;
    const T* xin = FWD ? nullptr : static_cast<const T*>(p.x) + row0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = mt * 16 + g + 8 * h;
        if (i >= p.n_out) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + nt * 8 + 2 * q;
          float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (!FWD && p.act) {
            const float2 xv = load2(xin + (int64_t)i * p.n_total + n);
            const float sc0 = s.sc[n], sc1 = s.sc[n + 1];
            if (!(to_f32(from_f32<T>(affine(xv.x, sc0, s.sh[n]))) > 0.f)) v0 = 0.f;
            if (!(to_f32(from_f32<T>(affine(xv.y, sc1, s.sh[n + 1]))) > 0.f)) v1 = 0.f;
            sgx[nt][0] += v0 * xv.x;
            sgx[nt][1] += v1 * xv.y;
            sg[nt][0] += v0;
            sg[nt][1] += v1;
            v0 *= sc0;
            v1 *= sc1;
          }
          store2(out + (int64_t)i * p.n_total + n, v0, v1);
        }
      }
  };

  // walk this warp's pillars: pil, pil + nw, ...; the items are the present
  // taps of each pillar, in tap order, and a pillar with none is one item
  // that only writes. A producer walk issues the copies stages - 1 items
  // ahead of the consumer walk, which multiplies; each walk loads a
  // pillar's table row one pillar ahead.
  const int nw = gridDim.x * kWarps;
  auto load_tab = [&](int r) -> int {
    return (r < p.m_dst && lane < 9) ? __ldg(p.table + (int64_t)r * 9 + lane) : -1;
  };
  struct Walk {
    int pil, tab, tab_next, t;
    unsigned rem;
  };
  auto take = [&](Walk& w, unsigned m) {
    w.t = m ? __ffs(m) - 1 : -1;
    w.rem = m ? m & (m - 1) : 0u;
  };
  auto start = [&](Walk& w, int pil) {
    w.pil = pil;
    w.tab = w.tab_next;
    w.tab_next = load_tab(pil + nw);
    take(w, __ballot_sync(kFull, w.tab >= 0));
  };
  auto advance = [&](Walk& w) {
    if (w.rem) {
      take(w, w.rem);
    } else {
      start(w, w.pil + nw);
    }
  };
  const int pil0 = blockIdx.x * kWarps + warp;
  Walk pw, cw;
  pw.tab_next = cw.tab_next = load_tab(pil0);
  start(pw, pil0);
  start(cw, pil0);
  auto produce = [&](int slot) {
    const int j = __shfl_sync(kFull, pw.tab, pw.t < 0 ? 0 : pw.t);
    if (pw.pil < p.m_dst && pw.t >= 0) issue(j, slot);
    cp_async_commit();
    if (pw.pil < p.m_dst) advance(pw);
  };
  int slot_p = 0, slot_c = 0;
  for (int k = 0; k < p.stages - 1; ++k) {
    produce(slot_p);
    slot_p = slot_p + 1 == p.stages ? 0 : slot_p + 1;
  }
  while (cw.pil < p.m_dst) {
    produce(slot_p);
    slot_p = slot_p + 1 == p.stages ? 0 : slot_p + 1;
    if (cw.t >= 0) {
      cp_async_wait_ring(p.stages);
      if (FWD && p.act) {
        T* buf = reinterpret_cast<T*>(mine + slot_c * s.buf_bytes);
        for (int e = lane; e < col_chunks; e += 32) {
          const int ch = s.ra.col_of(e);
          activate_chunk(buf + PER * s.ra.chunk(s.ra.row_of(e) + 1, ch), s.sc, s.sh, ch * PER);
        }
      }
      __syncwarp();
      multiply(slot_c, cw.t);
    }
    if (cw.rem == 0) {  // the pillar's last item
      epilogue(cw.pil);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
    }
    __syncwarp();
    advance(cw);
    slot_c = slot_c + 1 == p.stages ? 0 : slot_c + 1;
  }
  cp_async_wait<0>();

  if (FWD || !p.act) return;
  // the channel sums: lanes of one q hold the same channels; add over g,
  // then over the warps in order, in shared memory (no atomics)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sgx[nt][e] += __shfl_xor_sync(kFull, sgx[nt][e], off);
        sg[nt][e] += __shfl_xor_sync(kFull, sg[nt][e], off);
      }
  __syncthreads();  // every warp is done with its buffers
  float* red = reinterpret_cast<float*>(s.bufs);  // (2, kWarps, n_blk)
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * lane + e;
        red[warp * p.n_blk + n] = sgx[nt][e];
        red[(kWarps + warp) * p.n_blk + n] = sg[nt][e];
      }
  }
  __syncthreads();
  if (tid < p.n_blk) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w * p.n_blk + tid];
      c += red[(kWarps + w) * p.n_blk + tid];
    }
    p.part[(int64_t)blockIdx.x * p.c + n0 + tid] = a;
    p.part[((int64_t)gridDim.x + blockIdx.x) * p.c + n0 + tid] = c;
  }
}

// Launch the core for one (MT, NT) pair chosen at run time.
template <typename T, bool FWD, int MT, int NT>
cudaError_t launch_conv_mt_nt(const ConvArgs& p, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kernel = gather_conv_kernel<T, MT, NT, FWD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool FWD, int MT>
cudaError_t launch_conv_mt(const ConvArgs& p, int nt, dim3 grid, size_t smem, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_conv_mt_nt<T, FWD, MT, 1>(p, grid, smem, stream);
    case 2: return launch_conv_mt_nt<T, FWD, MT, 2>(p, grid, smem, stream);
    case 4: return launch_conv_mt_nt<T, FWD, MT, 4>(p, grid, smem, stream);
    case 8: return launch_conv_mt_nt<T, FWD, MT, 8>(p, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool FWD>
cudaError_t launch_conv(const ConvArgs& p, int mt, int nt, dim3 grid, size_t smem,
                        cudaStream_t stream) {
  switch (mt) {
    case 1: return launch_conv_mt<T, FWD, 1>(p, nt, grid, smem, stream);
    case 2: return launch_conv_mt<T, FWD, 2>(p, nt, grid, smem, stream);
    case 3: return launch_conv_mt<T, FWD, 3>(p, nt, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The wrapper's plan (ops/fused_conv.py conv_plan, in this order): the
// integer fields of ConvArgs from m_dst to act, then MT, NT, the grid and the
// dynamic shared memory in bytes.
constexpr int kPlanFields = 19;

template <bool FWD>
int launch_planned(ConvArgs p, const int32_t* plan, int dtype, cudaStream_t stream) {
  int* fields[] = {&p.m_dst, &p.n_src, &p.width, &p.n_out, &p.n_total, &p.c, &p.cout,
                   &p.place, &p.astride, &p.kpad, &p.n_blk, &p.buf_rows, &p.stages, &p.act};
  for (int i = 0; i < 14; ++i) *fields[i] = plan[i];
  const int mt = plan[14], nt = plan[15];
  const dim3 grid(plan[16], plan[17]);
  const size_t smem = (size_t)plan[18];
  if (p.m_dst <= 0 || p.n_out <= 0) return (int)cudaGetLastError();
  if (dtype == 0) return (int)launch_conv<float, FWD>(p, mt, nt, grid, smem, stream);
  return (int)launch_conv<__nv_bfloat16, FWD>(p, mt, nt, grid, smem, stream);
}

}  // namespace gg
