// Backward of the fused (affine + relu) -> 3x3x3 sparse pillar convolution
// (K2's dx and dW, and K3 through the dW kernel with act = 0), for Hopper
// (sm_90a).
//
// Replaces toda_tpu/ops/pallas_fused_conv.py _bwd_kernel (:934, launched by
// _call_bwd; the backward of fused_bnconv9_t), which computes dx, dW and the
// per-channel sums behind dscale / dshift in one kernel, and _dw_kernel
// (:736, launched by _call_dw), which computes dW alone for a raw-input
// layer. The forward (fused_conv.cu) is
//
//   y[m, zo, co] = sum_{t<9} sum_{dz<3} sum_{c<C}
//                  a(idx[m, t], s*zo + dz - 1, c) * w[dz, t/3, t%3, c, co]
//
// with a(j, z, c) = 0 where j == -1 or z is outside [0, nz_in), else
// relu(x[j, z, c] * scale[c] + shift[c]) rounded to the activation type when
// act, else x[j, z, c]. Activations are row-major (M, nz, C).
//
// What bounds them on the H100. As the forward (fused_conv.cu): the work
// the data needs is the present (pillar, tap) pairs, from 1.5 of 9 a pillar
// at stage 1 to 7.5 at stage 4; bytes bound stages 1-2 (x, gy and the
// tables read once, dx and dW written once) and the bf16 operations
// stages 3-4 (C = Cout = 64).
//
// toda_bnconv9_bwd_dx: the input cotangent. Column t of the inverse table
// invf (M_in, 9) holds the output row m with idx[m, t] == j (or -1), so
//   h[j, z, c] = sum_t sum_{dz, zo: s*zo + dz - 1 == z} sum_co
//                gy[invf[j, t], zo, co] * w[dz, t/3, t%3, c, co]
// and then g = h where a(j, z, c) > 0 (act) else h; dx = g * scale[c] (act)
// or g. Design: the gather-GEMM core of gather_gemm.cuh, shared with K1.
// One warp owns one input pillar and skips its missing inverse taps; per
// present tap it cp.asyncs the gathered gy column onto the upsampled z axis
// (gy row zo at buffer row s*zo + 1; at stride 2 the odd rows between stay
// zero), so that input row z reads the 3*Cout contiguous values from buffer
// row z against the transposed weights w[2 - dz', t, c, :]: one
// (nz_in x 3 Cout) . (3 Cout x C) product per tap, bf16 on mma.sync, the
// next present taps' columns loading in a ring of up to 4 meanwhile. The
// epilogue applies the relu mask (the bit-exact affine, rounded to bf16)
// and the scale, and keeps each thread's f32 sums of g * x and g per
// channel; they are added over lanes by shuffles and over the block's
// warps in order in shared memory, one partial per block, which the
// wrapper adds in a fixed order: no float atomics.
//
// toda_bnconv9_dw + dw_reduce_kernel: the weight cotangent
//   dW[dz, t] = sum_{m: idx[m, t] >= 0} A_m^T . gy[m],
// A_m the (nz_out x 3C) im2col of the activated gathered column of x, as in
// the forward: a (3C x Cout) product whose K axis runs over the present
// (pillar, z) rows only. The wrapper builds each tap's list of present
// (m, j) pairs, m ascending, on the device with one prefix sum, padded to
// M, with the counts; the kernel reads the counts on the device (no host
// synchronisation). A fixed grid divides the concatenated lists of the 9
// taps into equal contiguous ranges, so the identity tap, which holds every
// row, does not leave blocks idle; a range that crosses a tap boundary
// writes a partial for each tap. In a block, warp groups own (3C x Cout)
// tiles of dW (WM x WN mma tiles a warp); the groups take turns over runs
// of `pairs` consecutive pairs of the range (8 pairs a block a turn, so a
// C = 64 layer, whose one group fills the block, stages 8 pairs at once). A
// group stages a run's x columns (activated in place) and gy columns with
// 16-byte cp.async, in a ring of 2-4 runs so that the next runs load while
// this one multiplies, and multiplies each transposed column
// (ldmatrix.trans) by its gy with mma.sync; the tile rows past nz_out read
// the zero row. Each group writes one f32 partial per tap it covered; the
// reduce kernel adds them in block and group order. No float atomics
// anywhere, so two runs give bit-identical dW. f32 keeps the same staging
// and fragments on FFMA.

#include "gather_gemm.cuh"

namespace {

using namespace gg;

struct DwArgs {
  const void* x;           // (M_in, nz_in, C) T
  const float* scale;      // (C,) f32
  const float* shift;      // (C,) f32
  const int2* lists;       // (9, M_out): tap t's present (output row, input row), ascending
  const int32_t* counts;   // (9,) present rows per tap
  const void* gy;          // (M_out, nz_out, Cout) T
  float* part;             // (blocks, ksplit, 9, 3C, Cout) f32 partials
  int m_out, nz_in, nz_out, c, cout, stride, act;
  int kz;      // 16-row k-steps over the output z rows
  int kpad;    // 3C rounded up to 16
  int xrows;   // rows of a staged x column
  int ksplit;  // warp groups of a block
  int wpg;     // warps of a group
  int stages;  // staged items per group (2-4)
  int pairs;   // (pillar, tap) pairs of one item (at most 8)
};

__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads));
}

template <typename T, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 2) dw_kernel(const DwArgs p) {
  constexpr int E = sizeof(T);
  constexpr int PER = 16 / E;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  float* sh = sc + p.c;
  int* offs = reinterpret_cast<int*>(sh + p.c);  // exclusive prefix of counts, 10
  unsigned char* bufs = smem + ((8 * p.c + 40 + 127) / 128) * 128;
  const Rows rx(p.c * E / 16), rg(p.cout * E / 16);
  const int xbytes = p.xrows * rx.stride * 16, gbytes = p.kz * 16 * rg.stride * 16;
  const int pair_bytes = xbytes + gbytes, item_bytes = p.pairs * pair_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / p.wpg, wi = warp % p.wpg;
  const int gthreads = p.wpg * 32, gt = tid - grp * gthreads;
  const int ntn = (p.cout / 8) / WN;  // warps of a group along Cout
  const int wm0 = (wi / ntn) * WM, wn0 = (wi % ntn) * WN;
  const int g = lane >> 2, q = lane & 3;
  unsigned char* mine = bufs + (int64_t)grp * p.stages * item_bytes;

  for (int i = tid; i < p.c; i += kThreads) {
    sc[i] = p.act ? p.scale[i] : 1.f;
    sh[i] = p.act ? p.shift[i] : 0.f;
  }
  if (tid == 0) {
    int o = 0;
    for (int t = 0; t < 9; ++t) {
      offs[t] = o;
      o += p.counts[t];
    }
    offs[9] = o;
  }
  for (int i = tid; i < p.ksplit * p.stages * item_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int64_t total = offs[9];
  const int lo = (int)(blockIdx.x * total / gridDim.x);
  const int hi = (int)((blockIdx.x + 1) * total / gridDim.x);

  // this group's items: in each tap's segment of [lo, hi), the runs of
  // `pairs` pairs numbered grp, grp + ksplit, ...; a segment with no run for
  // this group is one item with no pair
  struct It {
    int t, pos, end;
  };
  const int step = p.ksplit * p.pairs;
  auto seg_from = [&](int t0) -> It {
    for (int t = t0; t < 9; ++t) {
      const int a = max(lo, offs[t]), z = min(hi, offs[t + 1]);
      if (a < z) return It{t, a + grp * p.pairs, z};
    }
    return It{-1, 0, 0};
  };
  auto next = [&](It it) -> It {
    if (it.t < 0) return it;
    if (it.pos + step < it.end) return It{it.t, it.pos + step, it.end};
    return seg_from(it.t + 1);
  };
  auto count = [&](It it) { return it.t < 0 ? 0 : max(0, min(p.pairs, it.end - it.pos)); };
  // lane k < count of every warp holds pair k's (m, j)
  auto load = [&](It it, int& m, int& j) {
    if (lane < count(it)) {
      const int2 mj = __ldg(p.lists + (int64_t)it.t * p.m_out + (it.pos + lane - offs[it.t]));
      m = mj.x;
      j = mj.y;
    }
  };

  const int nxc = p.nz_in * rx.r, ngc = p.nz_out * rg.r;
  auto issue = [&](It it, int pm, int pj, int slot) {
    const int n = count(it);
    for (int k = 0; k < n; ++k) {
      const int m = __shfl_sync(kFull, pm, k), j = __shfl_sync(kFull, pj, k);
      const uint32_t xb = smem_u32(mine + slot * item_bytes + k * pair_bytes), gb = xb + xbytes;
      const char* xc = static_cast<const char*>(p.x) + (int64_t)j * p.nz_in * p.c * E;
      const char* gc = static_cast<const char*>(p.gy) + (int64_t)m * p.nz_out * p.cout * E;
      for (int e = gt; e < nxc + ngc; e += gthreads) {
        if (e < nxc) {
          cp_async16(xb + 16 * rx.chunk(rx.row_of(e) + 1, rx.col_of(e)), xc + 16 * (int64_t)e);
        } else {
          const int f = e - nxc;
          cp_async16(gb + 16 * rg.chunk(rg.row_of(f), rg.col_of(f)), gc + 16 * (int64_t)f);
        }
      }
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int ni = 0; ni < WN; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

  auto multiply = [&](unsigned char* xb) {
    unsigned char* gb = xb + xbytes;
    if constexpr (E == 2) {
      // this lane's ldmatrix offsets: for A (the transposed x column) the row
      // offset and chunk of each 16-row kk tile, for B (gy) within a k step
      int aroff[WM], ach[WM];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const int q8 = 2 * (wm0 + mi) + ((lane >> 3) & 1);  // kk / 8
        aroff[mi] = q8 >> rx.lg;
        ach[mi] = q8 & (rx.r - 1);
      }
      uint32_t boff[WN / 2];
#pragma unroll
      for (int np = 0; np < WN / 2; ++np)
        boff[np] = 16 * rg.chunk(lane & 15, wn0 + 2 * np + (lane >> 4));
      const int zlane = (lane & 7) + 8 * (lane >> 4);

      const uint32_t xa = smem_u32(xb), ga = smem_u32(gb);
      for (int ks = 0; ks < p.kz; ++ks) {
        uint32_t a[WM][4];
        const int zo = ks * 16 + zlane;
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          const int row = zo < p.nz_out ? p.stride * zo + aroff[mi] : 0;
          ldsm_x4_t(a[mi], xa + 16 * rx.chunk(row, ach[mi]));
        }
        const uint32_t gk = ga + 16 * 16 * ks * rg.stride;
#pragma unroll
        for (int np = 0; np < WN / 2; ++np) {
          uint32_t b4[4];
          ldsm_x4_t(b4, gk + boff[np]);
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            mma_bf16(acc[mi][2 * np], a[mi], b4[0], b4[1]);
            mma_bf16(acc[mi][2 * np + 1], a[mi], b4[2], b4[3]);
          }
        }
      }
    } else {  // f32: the same fragments on FFMA
      const float* xf = reinterpret_cast<const float*>(xb);
      const float* gf = reinterpret_cast<const float*>(gb);
      for (int zo = 0; zo < p.nz_out; ++zo) {
        float a0[WM], a1[WM];
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          const int k0 = (wm0 + mi) * 16 + g, k1 = k0 + 8;
          a0[mi] = xf[rx.elem(p.stride * zo + k0 / p.c, k0 % p.c, PER)];
          a1[mi] = xf[rx.elem(p.stride * zo + k1 / p.c, k1 % p.c, PER)];
        }
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const int co = (wn0 + ni) * 8 + 2 * q;
          const float b0 = gf[rg.elem(zo, co, PER)], b1 = gf[rg.elem(zo, co + 1, PER)];
#pragma unroll
          for (int mi = 0; mi < WM; ++mi) {
            acc[mi][ni][0] = fmaf(a0[mi], b0, acc[mi][ni][0]);
            acc[mi][ni][1] = fmaf(a0[mi], b1, acc[mi][ni][1]);
            acc[mi][ni][2] = fmaf(a1[mi], b0, acc[mi][ni][2]);
            acc[mi][ni][3] = fmaf(a1[mi], b1, acc[mi][ni][3]);
          }
        }
      }
    }
  };

  const int64_t slab = 3LL * p.c * p.cout;
  auto flush = [&](int t) {
    float* dst = p.part + ((int64_t)(blockIdx.x * p.ksplit + grp) * 9 + t) * slab;
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = (wm0 + mi) * 16 + g + 8 * h;
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          if (kk < 3 * p.c) {
            const int co = (wn0 + ni) * 8 + 2 * q;
            store2(dst + (int64_t)kk * p.cout + co, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
          acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.f;
        }
      }
  };

  // a producer walk issues the copies stages - 1 items ahead of the
  // consumer walk, which multiplies; the producer loads an item's (m, j)
  // one item before it issues
  It cw = seg_from(0), pw = cw;
  int pm = 0, pj = 0;
  load(pw, pm, pj);
  auto produce = [&](int slot) {
    issue(pw, pm, pj, slot);
    cp_async_commit();
    pw = next(pw);
    load(pw, pm, pj);
  };
  int slot_p = 0, slot_c = 0;
  for (int k = 0; k < p.stages - 1; ++k) {
    produce(slot_p);
    slot_p = slot_p + 1 == p.stages ? 0 : slot_p + 1;
  }
  while (cw.t >= 0) {
    produce(slot_p);
    slot_p = slot_p + 1 == p.stages ? 0 : slot_p + 1;
    const int n = count(cw);
    if (n > 0) {
      cp_async_wait_ring(p.stages);
      unsigned char* item = mine + slot_c * item_bytes;
      if (p.act) {
        for (int k = 0; k < n; ++k) {
          T* xb = reinterpret_cast<T*>(item + k * pair_bytes);
          for (int e = gt; e < nxc; e += gthreads) {
            const int ch = rx.col_of(e);
            activate_chunk(xb + PER * rx.chunk(rx.row_of(e) + 1, ch), sc, sh, ch * PER);
          }
        }
      }
      group_sync(1 + grp, gthreads);
      for (int k = 0; k < n; ++k) multiply(item + k * pair_bytes);
    }
    if (cw.pos + step >= cw.end) flush(cw.t);
    group_sync(1 + grp, gthreads);
    cw = next(cw);
    slot_c = slot_c + 1 == p.stages ? 0 : slot_c + 1;
  }
  cp_async_wait<0>();
}

// dW[dz, t, c, co] = the partials of every (block, group) whose range
// covers tap t, added in a fixed order: one block of 8 warps for 32
// consecutive outputs (one tap); warp w adds the blocks b = w, w + 8, ...
// in block and group order, then warp 0 adds the eight warps' sums in
// order.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, const int32_t* __restrict__ counts,
                 float* __restrict__ dw, int c, int cout, int blocks, int ksplit) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = 27LL * c * cout;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  const int64_t ee = e < n ? e : n - 1;
  const int co = (int)(ee % cout);
  int64_t r = ee / cout;
  const int ci = (int)(r % c);
  r /= c;
  const int t = (int)(r % 9), dz = (int)(r / 9);
  int64_t total = 0, off = 0;
  for (int u = 0; u < 9; ++u) {
    if (u < t) off += counts[u];
    total += counts[u];
  }
  const int64_t end = off + counts[t];
  const int64_t slab = 3LL * c * cout, at = (int64_t)(dz * c + ci) * cout + co;
  float s = 0.f;
  for (int b = warp; b < blocks && end > off; b += kWarps) {
    // block b's range [b*total/blocks, (b+1)*total/blocks) meets [off, end)
    if (b * total >= end * blocks || (b + 1) * total < (off + 1) * blocks) continue;
    if (b * total / blocks == (b + 1) * total / blocks) continue;  // an empty range
    for (int g = 0; g < ksplit; ++g) s += part[((int64_t)(b * ksplit + g) * 9 + t) * slab + at];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < n) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w][lane];
    dw[e] = sum;
  }
}

template <typename T, int WM, int WN>
cudaError_t launch_dw_tile(const DwArgs& p, int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = dw_kernel<T, WM, WN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const DwArgs& p, int wm, int wn, int blocks, size_t smem,
                      cudaStream_t stream) {
  if (wm == 2 && wn == 2) return launch_dw_tile<T, 2, 2>(p, blocks, smem, stream);
  if (wm == 2 && wn == 4) return launch_dw_tile<T, 2, 4>(p, blocks, smem, stream);
  if (wm == 3 && wn == 2) return launch_dw_tile<T, 3, 2>(p, blocks, smem, stream);
  if (wm == 3 && wn == 4) return launch_dw_tile<T, 3, 4>(p, blocks, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (gy, x, w and dx share it). part:
// (2, grid blocks, C) f32, written only when act. plan: the wrapper's
// conv_plan("dx", ...) (gg::kPlanFields ints).
int toda_bnconv9_bwd_dx(const void* gy, const void* x, const float* scale, const float* shift,
                        const void* w, const int32_t* invf, void* dx, float* part,
                        const int32_t* plan, int dtype, cudaStream_t stream) {
  gg::ConvArgs p{};
  p.src = gy;
  p.table = invf;
  p.w = w;
  p.scale = scale;
  p.shift = shift;
  p.x = x;
  p.out = dx;
  p.part = part;
  return gg::launch_planned<false>(p, plan, dtype, stream);
}

// dtype: 0 = float32, 1 = bfloat16 (x and gy). pairs / counts: the
// wrapper's tap_lists(idx). part: (blocks, ksplit, 9, 3C, Cout) f32
// scratch; dw: (27, C, Cout) f32 = (3, 3, 3, C, Cout). plan: the wrapper's
// dw_plan (m_out, nz_in, nz_out, C, Cout, stride, act, kz, kpad, xrows,
// ksplit, wpg, stages, pairs, WM, WN, blocks, shared memory bytes).
int toda_bnconv9_dw(const void* x, const float* scale, const float* shift, const int32_t* pairs,
                    const int32_t* counts, const void* gy, float* part, float* dw,
                    const int32_t* plan, int dtype, cudaStream_t stream) {
  DwArgs p{x, scale, shift, reinterpret_cast<const int2*>(pairs), counts, gy, part};
  int* fields[] = {&p.m_out, &p.nz_in, &p.nz_out, &p.c, &p.cout, &p.stride, &p.act,
                   &p.kz, &p.kpad, &p.xrows, &p.ksplit, &p.wpg, &p.stages, &p.pairs};
  for (int i = 0; i < 14; ++i) *fields[i] = plan[i];
  const int wm = plan[14], wn = plan[15], blocks = plan[16];
  const size_t smem = (size_t)plan[17];
  cudaError_t err = dtype == 0 ? launch_dw<float>(p, wm, wn, blocks, smem, stream)
                               : launch_dw<__nv_bfloat16>(p, wm, wn, blocks, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = 27LL * p.c * p.cout;
  dw_reduce_kernel<<<(unsigned)((n + 31) / 32), kThreads, 0, stream>>>(part, counts, dw, p.c,
                                                                      p.cout, blocks, p.ksplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
