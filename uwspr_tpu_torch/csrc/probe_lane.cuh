// The arithmetic of one lane of the served probe evaluation: the bf16
// derotation of a window sample and the tone power of one probe.
//
// Shared by the CUDA kernel (probe_lanes.cu) and by host C++ (a g++ build
// of this header, which the CPU tests hold against the plain chain of
// demod/finesync.py), so both round at the same points. What it repeats,
// operator for operator, is the plain chain at probe dtype "bf16":
//
//   - a window sample is bf16(x) of the f32 input (round to nearest even,
//     as Tensor.to(torch.bfloat16)), or 0 outside the 1 <= n < N guard;
//   - the phasor factors of symbol i are ur = bf16(cos(theta * j1)),
//     ui = bf16(sin(theta * j1)), j1 < 64, and vr, vi the same at
//     theta * 64 * j2 (_phasor_ramp_ri); the ramp at j = 64 * j2 + j1 is
//       cr = bf16(bf16(vr * ur) - bf16(vi * ui)),
//       ci = bf16(bf16(vr * ui) + bf16(vi * ur)),
//     and the derotated sample (probe_derotate)
//       zr = bf16(bf16(ar * cr) - bf16(ai * ci)),
//       zi = bf16(bf16(ar * ci) + bf16(ai * cr)),
//     each product, difference and sum in f32 and then rounded, as
//     PyTorch's bf16 elementwise operators compute in f32;
//   - a probe against tone row (br, bi) at lag offset b keeps four f32
//     sums of the 256 samples b <= j < b + 256 apart, each accumulated in
//     ascending j from +0, rr = sum zr*br, ii = sum zi*bi, ri = sum zr*bi,
//     ir = sum zi*br (a product of two bf16 values is exact in f32, so a
//     fused multiply-add rounds once, as an add of the product does), and
//     p = sqrt(re * re + im * im) with re = rr - ii, im = ri + ir, every
//     operation rounded on its own (shared_probe_eval).
//
// The derotation runs on packed bf16 pairs: on the device each product,
// sum or difference is one instruction rounded once, on the host an f32
// operation rounded to bf16, as PyTorch computes it. Both give the same
// bits, since f32 carries more than 2 * 8 + 2 bits (double rounding is
// innocuous then). The other device operations are the _rn intrinsics,
// which nvcc contracts with nothing; on the host they are plain float
// operations (g++ contracts nothing for a target without FMA
// instructions).

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#define UWSPR_PROBE_HD __host__ __device__ __forceinline__
#else
#define UWSPR_PROBE_HD inline
#endif

namespace uwspr_probe {

constexpr int kSym = 256;          // samples a symbol, and a probe's sum
constexpr int kNSym = 162;         // symbols a frame
constexpr int kPad = 4096;         // zeros in front of the padded window
constexpr int kTones = 4;

UWSPR_PROBE_HD uint32_t float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
#endif
}

UWSPR_PROBE_HD float bits_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// x rounded to bf16 (nearest, ties to even), as a float
UWSPR_PROBE_HD float bf16r(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  uint32_t u = float_bits(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return bits_float(u & 0xFFFF0000u);
#endif
}

UWSPR_PROBE_HD float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

UWSPR_PROBE_HD float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

UWSPR_PROBE_HD float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// two bf16-valued floats in one word: lo in the low half, hi in the high
UWSPR_PROBE_HD uint32_t pack2(float lo, float hi) {
  return (float_bits(lo) >> 16) | (float_bits(hi) & 0xFFFF0000u);
}

UWSPR_PROBE_HD float lo_of(uint32_t w) { return bits_float(w << 16); }

UWSPR_PROBE_HD float hi_of(uint32_t w) {
  return bits_float(w & 0xFFFF0000u);
}

// a word's bytes picked by the selector s from x (bytes 0-3) and y (4-7)
UWSPR_PROBE_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFFu)
         << (8 * i);
  return r;
#endif
}

// (bf16(lo), bf16(hi)) packed in a word, lo in the low half, as
// __nv_bfloat162 lays a pair out
UWSPR_PROBE_HD uint32_t pack_bf16x2(float lo, float hi) {
#ifdef __CUDA_ARCH__
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
#else
  return pack2(bf16r(lo), bf16r(hi));
#endif
}

// the pairs' products / sums, each rounded to bf16: on the device one
// packed instruction (rounded once), on the host in f32 and then rounded
UWSPR_PROBE_HD uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  return pack2(bf16r(lo_of(a) * lo_of(b)), bf16r(hi_of(a) * hi_of(b)));
#endif
}

UWSPR_PROBE_HD uint32_t add_bf16x2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
#else
  return pack2(bf16r(lo_of(a) + lo_of(b)), bf16r(hi_of(a) + hi_of(b)));
#endif
}

// (xr * yr - xi * yi, xr * yi + xi * yr) of packed (re, im) pairs, each
// product, difference and sum rounded to bf16
UWSPR_PROBE_HD uint32_t cmul_bf16x2(uint32_t x, uint32_t y) {
  const uint32_t p = mul_bf16x2(x, y);                        // xr yr, xi yi
  const uint32_t q = mul_bf16x2(x, byte_perm(y, 0, 0x1032));  // xr yi, xi yr
  const uint32_t lo = byte_perm(p, q, 0x5410);                // xr yr, xr yi
  const uint32_t hi = byte_perm(p, q, 0x7632);                // xi yi, xi yr
  return add_bf16x2(lo, hi ^ 0x8000u);        // x - y is x + (-y) in IEEE
}

// The derotated sample (zr, zi) of the packed bf16 sample a = (ar, ai)
// under the packed factors u = (ur, ui) at j1 and v = (vr, vi) at j2: the
// ramp c = v * u, then a * c (probe_derotate's cr, ci, zr, zi).
UWSPR_PROBE_HD uint32_t derotate(uint32_t a, uint32_t u, uint32_t v) {
  return cmul_bf16x2(a, cmul_bf16x2(v, u));
}

// acc + a * b rounded once (a, b bf16-valued, so a * b is exact in f32)
UWSPR_PROBE_HD float mac(float acc, float a, float b) {
#ifdef __CUDA_ARCH__
  return fmaf(a, b, acc);
#else
  return acc + a * b;
#endif
}

// The tone power of the four sums of one probe.
UWSPR_PROBE_HD float power(float rr, float ii, float ri, float ir) {
  const float re = sub_rn(rr, ii);
  const float im = add_rn(ri, ir);
  const float s = add_rn(mul_rn(re, re), mul_rn(im, im));
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(s);
#else
  return sqrtf(s);
#endif
}

// The offset into a lane's window of the probe at `lag`, for the window
// whose sample 0 is padded sample `base` (shared_probe_eval's b).
UWSPR_PROBE_HD int lag_offset(long long lag, long long base, int width) {
  long long b = lag + kPad - base;
  b = b < 0 ? 0 : b;
  return static_cast<int>(b > width - kSym ? width - kSym : b);
}

// One probe on the host: the tone power of the samples [b, b + 256) of a
// derotated row (zr, zi) against a tone row (br, bi), the sums in the
// kernel's order.
UWSPR_PROBE_HD float probe_power(const float* zr, const float* zi,
                                 const float* br, const float* bi, int b) {
  float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
  for (int k = b; k < b + kSym; ++k) {
    rr = mac(rr, zr[k], br[k]);
    ii = mac(ii, zi[k], bi[k]);
    ri = mac(ri, zr[k], bi[k]);
    ir = mac(ir, zi[k], br[k]);
  }
  return power(rr, ii, ri, ir);
}

}  // namespace uwspr_probe
