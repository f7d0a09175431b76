// The arithmetic of one lane of the device multipass subtraction: the
// re-encoded frame of a decoded spot, its phase-continuous replica, the
// per-symbol complex gains of the window against it, the residual
// frequency and drift, the gain boxcar and the fitted replica.
//
// Shared by the CUDA kernel (subtract_lanes.cu) and by host C++
// (subtract_lanes_host.cc, a g++ build of this header: the device
// engine's CPU twin, which the CPU tests hold against
// pipeline/multipass.py::subtract_spot). What it computes, step for step,
// is subtract_spot in float64:
//
//   - the 162 channel symbols of the 50 payload bits (fec_encode.
//     channel_symbols: the K = 32 rate-1/2 encoder over the bits and a
//     31-bit zero tail, the bit-reversal interleaver, the sync vector);
//   - the per-symbol drift offsets of the spot (spot_drift_offsets: the
//     linear ramp, or the SLM trajectory's Doppler drift);
//   - the replica exp(i phase[n]), phase[n] the sum of 2 pi tone_hz / fs
//     over the samples before n, rounded to complex64 (_replica). numpy
//     sums the phase sample by sample; here phase[256 i + k] = P_i + k d_i
//     with P_i the sum of 256 d_j over the symbols before i, which differs
//     from numpy's running sum by under 1e-9 rad over a frame;
//   - the per-symbol gain c_i = sum zz conj(ref) / max(cnt, 1) over the
//     in-window part of each symbol at a lag (_symbol_gains), its
//     captured energy sum cnt |c|^2 (the lag polish's key, first maximum
//     in ascending lag), the split-half residual frequency and drift
//     (_residual_freq_drift), the count-weighted boxcar (_smooth_gains)
//     and the fitted sample complex64(cs_i * ref[n]) (subtract_spot).
//
// Order of the sums: a symbol's sum is split as the kernel's warp splits
// it, lane j taking samples j, j + 32, ... j + 224 in ascending order with
// fused multiply-adds, the 32 partials then added in the butterfly order
// of __shfl_xor_sync (offsets 16, 8, 4, 2, 1), as lane 0 sees them. The
// host twin repeats that order (subtract_lanes_host.cc::symbol_sum), so
// the twin and the kernel differ only where nvcc fuses a multiply and an
// add that g++ keeps apart, or where their sin and cos differ in the last
// bit.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define UWSPR_SUB_HD __host__ __device__ __forceinline__
#else
#define UWSPR_SUB_HD inline
#endif

namespace uwspr_sub {

constexpr int kNSym = 162;
constexpr int kSpb = 256;
constexpr int kFrame = kNSym * kSpb;    // 41472
constexpr int kLanes = 32;               // a symbol's sum splits 32 ways
constexpr int kPerLane = kSpb / kLanes;  // 8 samples a partial
constexpr double kFs = 375.0;
constexpr double kToneSpacing = 375.0 / 256.0;
constexpr double kTwoPi = 6.283185307179586;   // 2.0 * np.pi
constexpr double kTsym = 256.0 / 375.0;
constexpr double kSoundSpeed = 1500.0;
constexpr uint32_t kPoly1 = 0xF2D05351u;
constexpr uint32_t kPoly2 = 0xE4613C47u;

// A product and a sum rounded each on its own, as numpy and g++ round
// them: nvcc would fuse a * b + c into one rounding.
UWSPR_SUB_HD double mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

UWSPR_SUB_HD double add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

// protocol._tables.SYNC_VECTOR, bit i of the 162 in word i / 32
UWSPR_SUB_HD int sync_bit(int i) {
  const uint32_t w[6] = {0x07A47103u, 0x58B340A4u, 0x56349558u,
                         0xE2CDC904u, 0x63580CA0u, 0x00000000u};
  return static_cast<int>((w[i >> 5] >> (i & 31)) & 1u);
}

UWSPR_SUB_HD int parity32(uint32_t x) {
  x ^= x >> 16;
  x ^= x >> 8;
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return static_cast<int>(x & 1u);
}

UWSPR_SUB_HD int bit_reverse8(int i) {
  i = ((i & 0xF0) >> 4) | ((i & 0x0F) << 4);
  i = ((i & 0xCC) >> 2) | ((i & 0x33) << 2);
  i = ((i & 0xAA) >> 1) | ((i & 0x55) << 1);
  return i;
}

// The 7-byte payload -> the 162 channel symbols 0..3 in transmit order
// (multipass.spot_channel_symbols).
UWSPR_SUB_HD void channel_symbols(const uint8_t* payload, uint8_t* sym) {
  uint8_t coded[kNSym];
  uint32_t state = 0;
  for (int b = 0; b < 81; ++b) {
    int bit = b < 50 ? (payload[b >> 3] >> (7 - (b & 7))) & 1 : 0;
    state = (state << 1) | static_cast<uint32_t>(bit);
    coded[2 * b] = static_cast<uint8_t>(parity32(state & kPoly1));
    coded[2 * b + 1] = static_cast<uint8_t>(parity32(state & kPoly2));
  }
  int p = 0;
  for (int i = 0; i < 256 && p < kNSym; ++i) {
    int j = bit_reverse8(i);
    if (j < kNSym) {
      sym[j] = static_cast<uint8_t>(sync_bit(j) + 2 * coded[p]);
      ++p;
    }
  }
}

// (162,) per-symbol drift offsets in Hz (multipass.spot_drift_offsets):
// mode 1 the SLM trajectory (v1, v2, p1, p2) at t = i * 111 // 162,
// else drift / 2 * (i - 81) / 81.
UWSPR_SUB_HD void drift_offsets(int mode, double drift, const float* slm,
                                double cf, double* dsym) {
  for (int i = 0; i < kNSym; ++i) {
    if (mode == 1) {
      double v1 = slm[0], v2 = slm[1], p1 = slm[2], p2 = slm[3];
      double t = static_cast<double>((i * 111) / 162);
      double q1 = add(mul(v1, t), p1);
      double q2 = add(mul(v2, t), p2);
      double num = add(mul(v1, q1), mul(v2, q2));
      double den = sqrt(add(mul(q1, q1), mul(q2, q2)));
      dsym[i] = den == 0.0 ? 0.0 : -num / den * (cf / kSoundSpeed);
    } else {
      dsym[i] = (drift / 2.0) * (static_cast<double>(i) - 81.0) / 81.0;
    }
  }
}

// The replica's phase step d_i a sample in symbol i and its phase P_i at
// the symbol's first sample.
UWSPR_SUB_HD void replica_steps(const uint8_t* sym, double freq,
                                const double* dsym, double* step,
                                double* start) {
  double p = 0.0;
  for (int i = 0; i < kNSym; ++i) {
    double tone = add(add(mul(static_cast<double>(sym[i]) - 1.5,
                              kToneSpacing), freq), dsym[i]);
    step[i] = mul(kTwoPi, tone) / kFs;
    start[i] = p;
    p = add(p, mul(256.0, step[i]));
  }
}

// The complex64 replica at samples k0, k0 + 32, ..., k0 + 224 of symbol i
// (k0 < 32): cos and sin at the first, then turned by 32 steps at a time.
UWSPR_SUB_HD void replica_lane(double step, double start, int k0, float* re,
                               float* im) {
  double c, s, c32, s32;
  sincos(add(start, mul(static_cast<double>(k0), step)), &s, &c);
  sincos(32.0 * step, &s32, &c32);
  for (int j = 0; j < kPerLane; ++j) {
    re[j] = static_cast<float>(c);
    im[j] = static_cast<float>(s);
    double cn = fma(c, c32, -s * s32);
    double sn = fma(s, c32, c * s32);
    c = cn;
    s = sn;
  }
}

// Samples of symbol i at lag `lag` that lie in a window of N: the count.
UWSPR_SUB_HD int in_window(long long lag, int i, int N) {
  long long a = lag + static_cast<long long>(kSpb) * i;
  long long lo = a < 0 ? 0 : a;
  long long hi = a + kSpb > N ? N : a + kSpb;
  return hi > lo ? static_cast<int>(hi - lo) : 0;
}

// Lane k0's partial of symbol i's sum of z[lag + n] conj(ref[n]) over its
// 8 samples, in ascending order, zero outside the window.
UWSPR_SUB_HD void partial(const float* zr, const float* zi, int N,
                          const float* rr, const float* ri, long long lag,
                          int i, int k0, double* sr, double* si) {
  double a = 0.0, b = 0.0;
  for (int j = 0; j < kPerLane; ++j) {
    int n = kSpb * i + k0 + kLanes * j;
    long long m = lag + n;
    if (m >= 0 && m < N) {
      double x = zr[m], y = zi[m];
      double u = rr[n], v = ri[n];
      a = fma(x, u, fma(y, v, a));
      b = fma(y, u, fma(-x, v, b));
    }
  }
  *sr = a;
  *si = b;
}

// The gain of a symbol from its sum and in-window count, and its captured
// energy cnt |c|^2.
UWSPR_SUB_HD void gain(double sr, double si, int cnt, double* cr, double* ci,
                       double* energy) {
  double d = cnt > 1 ? static_cast<double>(cnt) : 1.0;
  *cr = sr / d;
  *ci = si / d;
  *energy = static_cast<double>(cnt) * ((*cr) * (*cr) + (*ci) * (*ci));
}

// Residual (frequency Hz, drift Hz/frame) from the phase advance between
// consecutive gains (multipass._residual_freq_drift).
UWSPR_SUB_HD void residual_freq_drift(const double* cr, const double* ci,
                                      const int* cnt, double* dfreq,
                                      double* ddrift) {
  double f[2];
  const int half = (kNSym - 1) / 2;
  for (int h = 0; h < 2; ++h) {
    double a = 0.0, b = 0.0;
    int lo = h == 0 ? 0 : half, hi = h == 0 ? half : kNSym - 1;
    for (int k = lo; k < hi; ++k) {
      double w = static_cast<double>(cnt[k + 1] < cnt[k] ? cnt[k + 1]
                                                         : cnt[k]);
      // c[k+1] * conj(c[k]) * w
      double pr = cr[k + 1] * cr[k] + ci[k + 1] * ci[k];
      double pi = ci[k + 1] * cr[k] - cr[k + 1] * ci[k];
      a += pr * w;
      b += pi * w;
    }
    f[h] = (a != 0.0 || b != 0.0) ? atan2(b, a) / (kTwoPi * kTsym) : 0.0;
  }
  *dfreq = (f[0] + f[1]) / 2.0;
  *ddrift = 2.0 * (f[1] - f[0]);
}

// The count-weighted boxcar of width nfilt over the gains
// (multipass._smooth_gains: np.convolve(.., ones(nfilt), "same")).
UWSPR_SUB_HD void smooth_gains(const double* cr, const double* ci,
                               const int* cnt, int nfilt, double* sr,
                               double* si) {
  const int left = nfilt / 2;
  for (int i = 0; i < kNSym; ++i) {
    double a = 0.0, b = 0.0, d = 0.0;
    for (int j = i - left; j < i - left + nfilt; ++j) {
      if (j < 0 || j >= kNSym) continue;
      a += cr[j] * cnt[j];
      b += ci[j] * cnt[j];
      d += cnt[j];
    }
    double den = d > 1.0 ? d : 1.0;
    sr[i] = a / den;
    si[i] = b / den;
  }
}

// The fitted sample complex64(cs * ref): the complex128 product, each part
// rounded to float.
UWSPR_SUB_HD void fitted(double cr, double ci, float rr, float ri, float* fr,
                         float* fi) {
  *fr = static_cast<float>(cr * rr - ci * ri);
  *fi = static_cast<float>(cr * ri + ci * rr);
}

}  // namespace uwspr_sub
