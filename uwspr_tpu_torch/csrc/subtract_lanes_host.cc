// The CPU twin of csrc/subtract_lanes.cu: the same lanes, in the same
// order within a window, through the same lane arithmetic
// (subtract_lane.cuh), one window at a time on each OpenMP thread. A
// symbol's sum is taken as the kernel's warp takes it (32 partials of 8
// samples, added in the butterfly order of its shuffles), so the twin and
// the kernel differ only where nvcc fuses a multiply and an add that g++
// keeps apart, or their sin and cos differ in the last bit.
//
// Built by g++ (utils/gxx_build.py) from this file with the header's text
// in front of it (ops/subtract.py writes the pair into the build
// directory), and called through ctypes on CPU tensors: the device
// engine's plain version of the kernel.

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "subtract_lane.cuh"

namespace {

using namespace uwspr_sub;

// symbol i's sum at `lag`, in the kernel's order
void symbol_sum(const float* zr, const float* zi, int N, const float* rr,
                const float* ri, long long lag, int i, double* sr,
                double* si) {
  double a[kLanes], b[kLanes];
  for (int k = 0; k < kLanes; ++k)
    partial(zr, zi, N, rr, ri, lag, i, k, &a[k], &b[k]);
  for (int off = 16; off > 0; off >>= 1) {
    double a2[kLanes], b2[kLanes];
    for (int k = 0; k < kLanes; ++k) {
      a2[k] = a[k] + a[k ^ off];
      b2[k] = b[k] + b[k ^ off];
    }
    memcpy(a, a2, sizeof a);
    memcpy(b, b2, sizeof b);
  }
  *sr = a[0];
  *si = b[0];
}

struct Lane {
  const float* zr;
  const float* zi;
  float* rr;
  float* ri;
  int N;
  uint8_t sym[kNSym];
  double dsym[kNSym], step[kNSym], start[kNSym];
  double cr[kNSym], ci[kNSym];
  int cnt[kNSym];
  double freq;

  void build() {
    replica_steps(sym, freq, dsym, step, start);
    for (int i = 0; i < kNSym; ++i)
      for (int k = 0; k < kLanes; ++k) {
        float re[kPerLane], im[kPerLane];
        replica_lane(step[i], start[i], k, re, im);
        for (int j = 0; j < kPerLane; ++j) {
          int n = kSpb * i + k + kLanes * j;
          rr[n] = re[j];
          ri[n] = im[j];
        }
      }
  }

  void gains(long long lag) {
    for (int i = 0; i < kNSym; ++i) {
      double sr, si, e;
      symbol_sum(zr, zi, N, rr, ri, lag, i, &sr, &si);
      cnt[i] = in_window(lag, i, N);
      gain(sr, si, cnt[i], &cr[i], &ci[i], &e);
    }
  }

  long long polish(long long lag, int lag_search) {
    const long long lag0 = lag - lag_search;
    long long best = lag0;
    double best_e = 0.0;
    std::vector<double> energy(kNSym);
    for (int g = 0; g < 2 * lag_search + 1; ++g) {
      for (int i = 0; i < kNSym; ++i) {
        double sr, si, c1, c2;
        symbol_sum(zr, zi, N, rr, ri, lag0 + g, i, &sr, &si);
        gain(sr, si, in_window(lag0 + g, i, N), &c1, &c2, &energy[i]);
      }
      double t = 0.0;
      for (int i = 0; i < kNSym; ++i) t += energy[i];
      if (g == 0 || t > best_e) {
        best_e = t;
        best = lag0 + g;
      }
    }
    return best;
  }
};

}  // namespace

extern "C" {

// (n, 7) payloads -> (n, 162) channel symbols, the lanes' re-encoding.
int uwspr_subtract_symbols_host(const uint8_t* payload, int n,
                                uint8_t* out) {
  for (int k = 0; k < n; ++k)
    channel_symbols(payload + 7 * k, out + kNSym * k);
  return 0;
}

// The arguments of uwspr_subtract_lanes (csrc/subtract_lanes.cu) on host
// memory, with no stream. Returns 0, or -1 for what it does not take.
int uwspr_subtract_lanes_host(float* ri, int W, int N, int L,
                              const long long* widx, const uint8_t* active,
                              const uint8_t* payload, const float* freq,
                              const long long* lag, const long long* mode,
                              const float* drift, const float* slm,
                              double cf, int nfilt, int freq_iters,
                              int lag_search, float* scratch, double* info) {
  if (W < 1 || N < 1 || L < 0 || nfilt < 1 || freq_iters < 0 ||
      lag_search < 0)
    return -1;
#pragma omp parallel for schedule(dynamic, 1)
  for (int w = 0; w < W; ++w) {
    Lane s;
    s.zr = ri + static_cast<size_t>(w) * 2 * N;
    s.zi = s.zr + N;
    s.rr = scratch + static_cast<size_t>(w) * 2 * kFrame;
    s.ri = s.rr + kFrame;
    s.N = N;
    float* zr = ri + static_cast<size_t>(w) * 2 * N;
    float* zi = zr + N;
    for (int l = 0; l < L; ++l) {
      if (widx[l] != w || !active[l]) continue;
      channel_symbols(payload + 7 * l, s.sym);
      drift_offsets(static_cast<int>(mode[l]), drift[l], slm + 4 * l, cf,
                    s.dsym);
      s.freq = freq[l];
      long long lg = lag[l];
      int iters = 0;
      s.build();
      if (lag_search > 0) lg = s.polish(lg, lag_search);
      const long long lag1 = lg;
      bool fresh = true;
      for (int it = 0; it < freq_iters; ++it) {
        if (!fresh) s.build();
        s.gains(lg);
        double df, dd;
        residual_freq_drift(s.cr, s.ci, s.cnt, &df, &dd);
        if (fabs(df) < 1e-4 && fabs(dd) < 1e-3) break;
        s.freq += df;
        for (int i = 0; i < kNSym; ++i)
          s.dsym[i] += dd * ((static_cast<double>(i) - 81.0) / 162.0);
        iters = it + 1;
        fresh = false;
      }
      if (!fresh) s.build();
      if (lag_search > 0) lg = s.polish(lg, lag_search);
      s.gains(lg);
      double sr[kNSym], si[kNSym];
      smooth_gains(s.cr, s.ci, s.cnt, nfilt, sr, si);
      for (int n = 0; n < kFrame; ++n) {
        long long m = lg + n;
        if (m < 0 || m >= N) continue;
        float fr, fi;
        fitted(sr[n / kSpb], si[n / kSpb], s.rr[n], s.ri[n], &fr, &fi);
        zr[m] -= fr;
        zi[m] -= fi;
      }
      if (info != nullptr) {
        info[4 * l] = static_cast<double>(lag1);
        info[4 * l + 1] = static_cast<double>(lg);
        info[4 * l + 2] = s.freq;
        info[4 * l + 3] = static_cast<double>(iters);
      }
    }
  }
  return 0;
}

}  // extern "C"
