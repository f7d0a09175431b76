// Probe tone powers |corr| for every (candidate, freq, lag, symbol, tone).
//
// Replaces: uwspr_tpu/ops/probe_pallas.py::probe_powers_pallas (kernel
// `_probe_kernel`, probe_pallas.py:48-119), with the semantics of its XLA
// twin demod/finesync.py::_probe_powers_xla (finesync.py:103-154):
//
//   p[c, f, l, i, t] = | sum_{k<256} zp(n) * e^{i a_d} * e^{i a_b} |,
//   n   = off[c, l] + 256*i + k          (sample index; 0 outside 1 <= n < N,
//                                         the reference's 0 < n < N guard)
//   j'  = b[c, l] + k                    (index in the candidate's aligned
//                                         window, where the phases are taken)
//   a_d = (phase * drift[c, i]) * j'
//   a_b = (phase * (freq[c, f] + tone_t)) * j',   phase = -2*pi/fs in f32.
//
// The wrapper (ops/probe.py) computes off = base + b - PAD and b with the
// JAX wrapper's clipping, so kernel and plain version read the same samples
// and take every angle as the same f32 products; they differ only in the
// order of the 256-term sums and in sincosf against torch's cos/sin.
//
// What bounds it on the card: transcendentals. A block owns one (candidate,
// lag) and a tile of S symbols; it derotates S*256 samples and builds the
// 4F*256 tone bank (one sincosf each), then every thread accumulates 256
// complex products for one (symbol, freq, tone). Reads are small (the tile's
// S*256 samples, once), and outputs are 4*F*S floats per block.
//
// What the design does about it: the Mosaic alignment trick of the TPU
// kernel (256-aligned loads, masked rows) is gone: each block reads its lag's
// samples at their true offset, staged in shared memory in 64-sample chunks
// together with the chunk's tone bank, so sincosf runs once per (symbol,
// sample) and once per (probe, sample) instead of once per product. Rows are
// padded by one element against shared-memory bank conflicts.
//
// Build: nvcc without --use_fast_math, so sincosf keeps full range reduction.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSym = 256;          // samples per symbol
constexpr int kNSym = 162;         // symbols per frame
constexpr int kChunk = 64;         // samples per shared-memory chunk
constexpr int kRow = kChunk + 1;   // padded row stride (float2 elements)
constexpr int kMaxSym = 32;        // symbols per block, at most
constexpr int kThreads = 256;      // target threads per block
constexpr int kMaxF = 16;          // probe freqs per candidate, at most
// tone offsets in Hz: (t - 1.5) * 375/256, exact in f32
__device__ __forceinline__ float tone_hz(int t) {
  return (static_cast<float>(t) - 1.5f) * 1.46484375f;
}

__global__ void probe_powers_kernel(const float* __restrict__ z, int N,
                                    const int32_t* __restrict__ off,
                                    const int32_t* __restrict__ bsh,
                                    const float* __restrict__ freqs,
                                    const float* __restrict__ drift,
                                    int L, int F, int S, float phase,
                                    float* __restrict__ out) {
  extern __shared__ float2 smem[];
  float2* zd = smem;                 // [S][kRow] derotated samples
  float2* bank = smem + S * kRow;    // [4F][kRow] tone bank
  const int nm = 4 * F;
  const int cl = blockIdx.x;         // c * L + l
  const int c = cl / L;
  const int l = cl - c * L;
  const int i0 = blockIdx.y * S;
  const int tid = threadIdx.x;
  const int s = tid / nm;
  const int m = tid - s * nm;        // f * 4 + t
  const int i = i0 + s;
  const int o = off[cl];
  const int b = bsh[cl];
  float are = 0.f, aim = 0.f;
  for (int k0 = 0; k0 < kSym; k0 += kChunk) {
    for (int e = tid; e < S * kChunk; e += blockDim.x) {
      const int ss = e / kChunk;
      const int kk = e - ss * kChunk;
      const int ii = i0 + ss;
      float2 v = make_float2(0.f, 0.f);
      if (ii < kNSym) {
        const int n = o + kSym * ii + k0 + kk;
        if (n >= 1 && n < N) {
          const float zr = z[n];
          const float zi = z[N + n];
          const float jf = static_cast<float>(b + k0 + kk);
          const float ang = __fmul_rn(__fmul_rn(phase, drift[c * kNSym + ii]),
                                      jf);
          float sn, cs;
          sincosf(ang, &sn, &cs);
          v.x = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
          v.y = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));
        }
      }
      zd[ss * kRow + kk] = v;
    }
    for (int e = tid; e < nm * kChunk; e += blockDim.x) {
      const int mm = e / kChunk;
      const int kk = e - mm * kChunk;
      const float ft = __fadd_rn(freqs[c * F + (mm >> 2)], tone_hz(mm & 3));
      const float ang = __fmul_rn(__fmul_rn(phase, ft),
                                  static_cast<float>(b + k0 + kk));
      float sn, cs;
      sincosf(ang, &sn, &cs);
      bank[mm * kRow + kk] = make_float2(cs, sn);
    }
    __syncthreads();
    if (i < kNSym) {
      const float2* zrow = zd + s * kRow;
      const float2* brow = bank + m * kRow;
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        const float2 a = zrow[kk];
        const float2 w = brow[kk];
        are += a.x * w.x - a.y * w.y;
        aim += a.x * w.y + a.y * w.x;
      }
    }
    __syncthreads();
  }
  if (i < kNSym) {
    const int f = m >> 2;
    const int t = m & 3;
    out[((static_cast<size_t>(c * F + f) * L + l) * kNSym + i) * 4 + t] =
        sqrtf(are * are + aim * aim);
  }
}

}  // namespace

extern "C" {

// z: (2, N) f32 real/imag planes; off, b: (C, L) int32 (see above);
// freqs: (C, F) f32; drift: (C, 162) f32; out: (C, F, L, 162, 4) f32,
// written. Launches on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue without launching when F is out of range).
int uwspr_probe_powers(const float* z, int N, const int32_t* off,
                       const int32_t* b, const float* freqs,
                       const float* drift, int C, int L, int F, float phase,
                       float* out, void* stream) {
  if (F < 1 || F > kMaxF) return static_cast<int>(cudaErrorInvalidValue);
  if (C > 0 && L > 0) {
    const int nm = 4 * F;
    int S = kThreads / nm;
    if (S > kMaxSym) S = kMaxSym;
    if (S < 1) S = 1;
    const dim3 block(S * nm);
    const dim3 blocks(C * L, (kNSym + S - 1) / S);
    const size_t shmem = sizeof(float2) * static_cast<size_t>(S + nm) * kRow;
    probe_powers_kernel<<<blocks, block, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
        z, N, off, b, freqs, drift, L, F, S, phase, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
