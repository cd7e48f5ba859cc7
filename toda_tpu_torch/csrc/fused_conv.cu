// Fused (affine + relu) -> 3x3x3 sparse pillar convolution, forward (K1),
// for Hopper (sm_90a).
//
// Replaces toda_tpu/ops/pallas_fused_conv.py _fwd_kernel (:475, launched by
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
// What bounds it on the H100. The work the data needs is the present
// (pillar, tap) pairs: on the flagship scenes a pillar has 1.5 of its 9
// taps at stage 1, 2.5 at stage 2, 5.3 at stage 3 and 7.5 at stage 4
// (chip_smoke.py logs the share per call). A pair does 2*nz_out*3C*Cout
// flops while the pillar reads its x column once and writes its y column:
// ~35 flops a byte at stage 1 (C = Cout = 16), under the ~295 at which the
// bf16 tensor cores and not memory set the pace, so bytes bound stages 1-2;
// ~500 at stage 3 (C = Cout = 64), so operations bound stages 3-4.
//
// Design (gather_gemm.cuh, the core K1 shares with K2's dx). One warp owns
// one output pillar: its whole z column and a slice of Cout. It reads the
// pillar's 9 table entries, skips the missing taps, and for each present tap
// copies the gathered column with 16-byte cp.async into its own shared
// buffer, in a ring of up to 4, so the next present taps' columns load while
// this one multiplies; it applies the activation in place (the bit-exact
// affine, rounded to bf16) to the chunks it copied. The dz taps are the
// im2col of the buffer: output row zo reads the 3C contiguous values from
// buffer row s*zo, so each tap is one (nz_out x 3C) . (3C x Cout) product,
// padded to 16-row tiles (40 -> 48, 20 -> 32, 10 and 5 -> 16; the padding
// rows read the zero row) and K to a multiple of 16 (3C = 24 at C = 8,
// against zero weight rows). bf16 runs it with ldmatrix + mma.sync m16n8k16
// (f32 sums in registers across the taps, the output written once), the
// ldmatrix offsets precomputed per lane and the buffers XOR-swizzled so
// that no two rows of one ldmatrix share a bank; f32 keeps the same staging
// and fragments on FFMA. A block of 8 warps stages the weights of all 27
// taps once, as the working type, and then walks a strided range of
// pillars; at C = Cout = 64 the 221 KB of weights are split over two blocks
// by Cout (110.6 KB each), so each such column is gathered twice.
// mma.sync and not wgmma: a 5-40-row z column does not fill wgmma's 64-row
// tiles. What it leaves (PERF.md): at stages 3-4 (C = 64, 5-8 present taps a
// pillar) the per-tap instructions, not the copies, set the pace.

#include "gather_gemm.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it); scale/shift f32.
// plan: the wrapper's conv_plan("fwd", ...) (gg::kPlanFields ints).
int toda_fused_bnconv9(const void* x, const float* scale, const float* shift, const void* w,
                       const int32_t* idx, void* y, const int32_t* plan, int dtype,
                       cudaStream_t stream) {
  gg::ConvArgs p{};
  p.src = x;
  p.table = idx;
  p.w = w;
  p.scale = scale;
  p.shift = shift;
  p.out = y;
  return gg::launch_planned<true>(p, plan, dtype, stream);
}

int toda_fused_bnconv9_plan_fields() { return gg::kPlanFields; }

}  // extern "C"
