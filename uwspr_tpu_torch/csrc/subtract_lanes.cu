// The device multipass subtraction: every decoded frame a pass hands it,
// re-encoded, fitted and subtracted from its window in place, one launch
// for a whole batch.
//
// For lane l (a spot of window widx[l], active[l] set), in lane order
// within each window, exactly as pipeline/multipass.py::subtract_spot
// does it in float64 (subtract_lane.cuh says step for step):
//
//   1. re-encode the 7-byte payload into its 162 channel symbols;
//   2. the replica at the spot's freq and drift (or SLM) offsets, from
//      lag = shift + the decoding jiggle's offset;
//   3. polish the lag over +-lag_search samples (the maximum captured
//      energy sum cnt |c|^2, first maximum in ascending lag);
//   4. up to freq_iters times: the gains at the lag, the split-half
//      residual frequency and drift, folded into the replica (stop once
//      both are under 1e-4 Hz and 1e-3 Hz a frame);
//   5. polish the lag again on the final replica;
//   6. the gains, their count-weighted boxcar of nfilt symbols, and the
//      fitted replica complex64(cs_i * ref[n]) subtracted from the
//      window's float32 samples.
//
// Replaces no Pallas kernel: the JAX package subtracts on the host in
// numpy (uwspr_tpu/pipeline/multipass.py), between single-window decodes.
// A library form would be worse than the host: the lag polish alone is 33
// lags x 41,472 complex products a lane, twice, and as tensors over the
// lanes it would materialise gigabytes.
//
// What bounds it: the float64 multiply-adds of the two lag polishes, 4 a
// complex product, 2 x 33 x 41,472 x 4 = 11 M a lane at lag_search 16,
// and the gains at one lag once a frequency polish and once at the end.
// float64 keeps the polish's argmax and the fitted replica to numpy's
// bits but for the last ulp (the phase is a float64 sum over 41,472
// samples: a float32 phase ramp is 1e-4 rad off by the frame's end).
//
// What the design does about it: one block of 512 threads a window, so
// the lanes of a window run in order (a later frame is fitted against the
// residual of the earlier ones, as the host's loop does) and the windows
// in parallel. A warp owns a symbol at a time; its lane j takes samples j,
// j + 32, ... of it, so every load of the window and of the replica is a
// coalesced 128-byte line, and adds the 32 partials in a butterfly of
// shuffles. The replica lives in a float32 scratch of the window's size
// (the complex64 values numpy builds), rebuilt only when the frequency or
// drift moved; its phase is computed once a lane-sample by sincos and
// then turned by 32 samples a step. The 33 lags' energies of each symbol
// sit in shared memory, and the argmax is taken over their sums in
// ascending lag.
//
// Build: nvcc without --use_fast_math (IEEE float64 divisions, sqrt,
// atan2 and sincos).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "subtract_lane.cuh"

namespace {

using namespace uwspr_sub;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

struct Args {
  float* ri;                 // (W, 2, N), in place
  int N;
  int L;
  const long long* widx;     // (L,)
  const uint8_t* active;     // (L,)
  const uint8_t* payload;    // (L, 7)
  const float* freq;         // (L,)
  const long long* lag;      // (L,)
  const long long* mode;     // (L,)
  const float* drift;        // (L,)
  const float* slm;          // (L, 4)
  double cf;
  int nfilt;
  int freq_iters;
  int lag_search;
  float* scratch;            // (W, 2, kFrame)
  double* info;              // (L, 4)
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
subtract_lanes_kernel(Args a) {
  extern __shared__ double s_energy[];        // (2 lag_search + 1, 162)
  __shared__ uint8_t s_sym[kNSym];
  __shared__ double s_dsym[kNSym], s_step[kNSym], s_start[kNSym];
  __shared__ double s_cr[kNSym], s_ci[kNSym], s_sr[kNSym], s_si[kNSym];
  __shared__ int s_cnt[kNSym];
  __shared__ double s_freq;
  __shared__ long long s_lag, s_lag1;
  __shared__ int s_go, s_iters;

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int N = a.N;
  const int NL = 2 * a.lag_search + 1;
  float* zr = a.ri + static_cast<size_t>(w) * 2 * N;
  float* zi = zr + N;
  float* rr = a.scratch + static_cast<size_t>(w) * 2 * kFrame;
  float* ri = rr + kFrame;

  auto build = [&]() {
    if (tid == 0) replica_steps(s_sym, s_freq, s_dsym, s_step, s_start);
    __syncthreads();
    for (int i = warp; i < kNSym; i += kWarps) {
      float re[kPerLane], im[kPerLane];
      replica_lane(s_step[i], s_start[i], lane, re, im);
      for (int j = 0; j < kPerLane; ++j) {
        int n = kSpb * i + lane + kLanes * j;
        rr[n] = re[j];
        ri[n] = im[j];
      }
    }
    __syncthreads();
  };

  auto gains = [&](long long lag) {
    for (int i = warp; i < kNSym; i += kWarps) {
      double sr, si;
      partial(zr, zi, N, rr, ri, lag, i, lane, &sr, &si);
      sr = warp_sum(sr);
      si = warp_sum(si);
      if (lane == 0) {
        int cnt = in_window(lag, i, N);
        double e;
        gain(sr, si, cnt, &s_cr[i], &s_ci[i], &e);
        s_cnt[i] = cnt;
      }
    }
    __syncthreads();
  };

  auto polish = [&]() {
    const long long lag0 = s_lag - a.lag_search;
    for (int i = warp; i < kNSym; i += kWarps) {
      for (int g = 0; g < NL; ++g) {
        double sr, si;
        partial(zr, zi, N, rr, ri, lag0 + g, i, lane, &sr, &si);
        sr = warp_sum(sr);
        si = warp_sum(si);
        if (lane == 0) {
          double cr, ci, e;
          gain(sr, si, in_window(lag0 + g, i, N), &cr, &ci, &e);
          s_energy[g * kNSym + i] = e;
        }
      }
    }
    __syncthreads();
    // each lag's captured energy, summed in ascending symbol order into
    // the lag's first entry
    for (int g = tid; g < NL; g += kThreads) {
      double t = 0.0;
      for (int i = 0; i < kNSym; ++i) t += s_energy[g * kNSym + i];
      s_energy[g * kNSym] = t;
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      for (int g = 1; g < NL; ++g)
        if (s_energy[g * kNSym] > s_energy[best * kNSym]) best = g;
      s_lag = lag0 + best;
    }
    __syncthreads();
  };

  for (int l = 0; l < a.L; ++l) {
    if (a.widx[l] != w || !a.active[l]) continue;      // block-uniform
    if (tid == 0) {
      channel_symbols(a.payload + 7 * l, s_sym);
      drift_offsets(static_cast<int>(a.mode[l]), a.drift[l], a.slm + 4 * l,
                    a.cf, s_dsym);
      s_freq = a.freq[l];
      s_lag = a.lag[l];
      s_iters = 0;
    }
    __syncthreads();
    build();
    if (a.lag_search > 0) polish();
    if (tid == 0) s_lag1 = s_lag;
    bool fresh = true;          // the scratch holds the current replica
    for (int it = 0; it < a.freq_iters; ++it) {
      if (!fresh) build();
      gains(s_lag);
      if (tid == 0) {
        double df, dd;
        residual_freq_drift(s_cr, s_ci, s_cnt, &df, &dd);
        s_go = !(fabs(df) < 1e-4 && fabs(dd) < 1e-3);
        if (s_go) {
          s_freq += df;
          for (int i = 0; i < kNSym; ++i)
            s_dsym[i] += dd * ((static_cast<double>(i) - 81.0) / 162.0);
          s_iters = it + 1;
        }
      }
      __syncthreads();
      if (!s_go) break;
      fresh = false;
    }
    if (!fresh) build();
    if (a.lag_search > 0) polish();
    gains(s_lag);
    if (tid == 0) smooth_gains(s_cr, s_ci, s_cnt, a.nfilt, s_sr, s_si);
    __syncthreads();
    const long long lag = s_lag;
    for (int n = tid; n < kFrame; n += kThreads) {
      long long m = lag + n;
      if (m < 0 || m >= N) continue;
      int i = n / kSpb;
      float fr, fi;
      fitted(s_sr[i], s_si[i], rr[n], ri[n], &fr, &fi);
      zr[m] -= fr;
      zi[m] -= fi;
    }
    if (tid == 0 && a.info != nullptr) {
      a.info[4 * l] = static_cast<double>(s_lag1);
      a.info[4 * l + 1] = static_cast<double>(lag);
      a.info[4 * l + 2] = s_freq;
      a.info[4 * l + 3] = static_cast<double>(s_iters);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The dynamic shared memory of a launch at lag_search, bytes.
int uwspr_subtract_lanes_smem(int lag_search) {
  return (2 * lag_search + 1) * kNSym * static_cast<int>(sizeof(double));
}

// ri: (W, 2, N) f32, changed in place; widx, lag, mode: (L,) int64;
// active: (L,) u8; payload: (L, 7) u8; freq, drift: (L,) f32; slm: (L, 4)
// f32; scratch: (W, 2, 41472) f32; info: (L, 4) f64 or null, written for
// the active lanes (the first polish's lag, the final lag, the final
// frequency, the frequency polishes that moved it). Launches W blocks on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching for what it does not take).
int uwspr_subtract_lanes(float* ri, int W, int N, int L,
                         const long long* widx, const uint8_t* active,
                         const uint8_t* payload, const float* freq,
                         const long long* lag, const long long* mode,
                         const float* drift, const float* slm, double cf,
                         int nfilt, int freq_iters, int lag_search,
                         float* scratch, double* info, void* stream) {
  const int smem = uwspr_subtract_lanes_smem(lag_search);
  if (W < 1 || N < 1 || L < 0 || nfilt < 1 || freq_iters < 0 ||
      lag_search < 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaSuccess);
  // the attribute is set once per device and size (it is a device's own
  // setting): the static arrays and the energies together pass the 48 KB
  // a block has without it
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  {
    static std::mutex mu;
    static int granted[kMaxDevices] = {};
    std::lock_guard<std::mutex> hold(mu);
    if (smem > granted[dev]) {
      e = cudaFuncSetAttribute(subtract_lanes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      granted[dev] = smem;
    }
  }
  Args a;
  a.ri = ri;
  a.N = N;
  a.L = L;
  a.widx = widx;
  a.active = active;
  a.payload = payload;
  a.freq = freq;
  a.lag = lag;
  a.mode = mode;
  a.drift = drift;
  a.slm = slm;
  a.cf = cf;
  a.nfilt = nfilt;
  a.freq_iters = freq_iters;
  a.lag_search = lag_search;
  a.scratch = scratch;
  a.info = info;
  subtract_lanes_kernel<<<W, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
