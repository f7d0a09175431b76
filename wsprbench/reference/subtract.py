"""The plain reference of the device multipass's subtraction: one decoded
frame fitted and taken out of its window, in float64 numpy, written from
the description of WSJT-X's successive cancellation as the port states it
(a decoded message re-encoded, its phase-continuous replica built at the
decode's frequency, drift and lag, a complex gain a symbol fitted and
smoothed, the fitted replica subtracted), with nothing of the program
imported.

For a spot (7-byte payload, frequency f in Hz, first sample ``lag``, drift
model) on a window z:

- symbols: the 162 channel symbols of the payload (``protocol``);
- drift: per symbol d_i in Hz, the linear ramp drift / 2 * (i - 81) / 81,
  or for an SLM trajectory (v1, v2, p1, p2) the Doppler drift
  -(v1 q1 + v2 q2) / |q| * cf / 1500 at t = floor(111 i / 162) with
  q = (v1 t + p1, v2 t + p2), 0 where |q| is 0;
- replica: at sample n = 256 i + k of symbol i the tone
  (s_i - 1.5) 375/256 + f + d_i Hz, a phase step d_i = 2 pi tone / 375
  a sample; the phase is continuous from 0 at the first sample, so it is
  P_i + k d_i with P_i the sum of 256 d_j over the symbols before i; the
  replica exp(i phase) is rounded to complex64 (``phase`` "f32" takes the
  steps and sums in float32 instead: the control's one step down);
- gains at a lag: c_i = sum over the symbol's samples inside the window
  of z[lag + n] conj(ref[n]), over the count of them (1 at least); the
  captured energy is sum cnt_i |c_i|^2;
- lag polish: the lag of the most captured energy over lag +- ``search``,
  the lowest on a tie;
- frequency polish, at most ``iters`` times: from the gains at the lag,
  r_k = c_{k+1} conj(c_k) min(cnt_k, cnt_{k+1}); the angles of the sums of
  r_0..r_79 and r_80..r_160 over 2 pi 256/375 give the residual
  frequencies e and l of the two halves; stop when |(e + l) / 2| < 1e-4 Hz
  and |2 (l - e)| < 1e-3 Hz; else f += (e + l) / 2 and
  d_i += 2 (l - e) (i - 81) / 162;
- the lag polished again on the final replica, the gains at it, their
  count-weighted moving sum over ``nfilt`` symbols centred on each (numpy
  ``convolve(.., "same")``), and the fitted frame complex64(cs_i ref[n])
  subtracted from the window's complex64 samples inside it.
"""

from __future__ import annotations

import numpy as np

from wsprbench.reference import protocol as P

SOUND_SPEED = 1500.0
# the subtraction's settings, as the configuration states them: the gains'
# boxcar in symbols, the frequency polishes, the lag polish in +- samples
NFILT, ITERS, SEARCH = 5, 3, 16
_FRAME = P.FRAME_SAMPLES
_TSYM = P.SPB / P.SAMPLE_RATE


def drift_hz(mode: int, drift: float, slm, cf: float) -> np.ndarray:
    i = np.arange(P.N_SYMBOLS, dtype=np.float64)
    if mode != 1:
        return (float(drift) / 2.0) * (i - 81.0) / 81.0
    v1, v2, p1, p2 = (float(x) for x in slm)
    t = np.floor(i * 111.0 / 162.0)
    q1, q2 = v1 * t + p1, v2 * t + p2
    den = np.sqrt(q1 * q1 + q2 * q2)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = -(v1 * q1 + v2 * q2) / den * (cf / SOUND_SPEED)
    return np.where(den == 0.0, 0.0, out)


def replica(symbols: np.ndarray, freq: float, dsym: np.ndarray,
            phase: str = "f64") -> np.ndarray:
    tone = P.TONE_OFFSETS[symbols] * P.TONE_SPACING + freq + dsym
    step = 2.0 * np.pi * tone / P.SAMPLE_RATE
    if phase == "f32":
        step = step.astype(np.float32)
    start = np.concatenate([[0], np.cumsum(P.SPB * step)[:-1]]).astype(
        step.dtype)
    k = np.arange(P.SPB, dtype=step.dtype)
    ph = (start[:, None] + k[None, :] * step[:, None]).astype(np.float64)
    return np.exp(1j * ph.reshape(-1)).astype(np.complex64)


def gains(z: np.ndarray, ref: np.ndarray, lag: int):
    n = np.arange(_FRAME)
    m = lag + n
    inside = (m >= 0) & (m < len(z))
    zz = np.where(inside, z[np.clip(m, 0, len(z) - 1)], 0).astype(
        np.complex128)
    prod = (zz * np.conj(ref.astype(np.complex128))).reshape(P.N_SYMBOLS,
                                                              P.SPB)
    cnt = inside.reshape(P.N_SYMBOLS, P.SPB).sum(axis=1).astype(np.float64)
    return prod.sum(axis=1) / np.maximum(cnt, 1.0), cnt


def energy(z: np.ndarray, ref: np.ndarray, lag: int) -> float:
    c, cnt = gains(z, ref, lag)
    return float(np.sum(cnt * (c.real ** 2 + c.imag ** 2)))


def polish_lag(z, ref, lag: int, search: int) -> int:
    best, best_e = lag - search, -1.0
    for lg in range(lag - search, lag + search + 1):
        e = energy(z, ref, lg)
        if e > best_e:
            best, best_e = lg, e
    return best


def residual(c: np.ndarray, cnt: np.ndarray) -> tuple[float, float]:
    r = c[1:] * np.conj(c[:-1]) * np.minimum(cnt[1:], cnt[:-1])
    half = len(r) // 2
    f = []
    for seg in (r[:half], r[half:]):
        s = seg.sum()
        f.append(float(np.angle(s)) / (2.0 * np.pi * _TSYM)
                 if abs(s) > 0 else 0.0)
    return (f[0] + f[1]) / 2.0, 2.0 * (f[1] - f[0])


def subtract(z: np.ndarray, payload: bytes, freq: float, lag: int,
             mode: int, drift: float, slm, cf: float, nfilt: int = NFILT,
             iters: int = ITERS, search: int = SEARCH,
             phase: str = "f64") -> np.ndarray:
    """A copy of the complex64 window z with the spot's fitted frame
    subtracted."""
    z = np.asarray(z, np.complex64)
    sym = P.channel_symbols(bytes(payload))
    dsym = drift_hz(mode, drift, slm, cf)
    f = float(freq)
    ramp = (np.arange(P.N_SYMBOLS) - 81.0) / 162.0
    if search > 0:
        lag = polish_lag(z, replica(sym, f, dsym, phase), lag, search)
    for _ in range(iters):
        c, cnt = gains(z, replica(sym, f, dsym, phase), lag)
        df, dd = residual(c, cnt)
        if abs(df) < 1e-4 and abs(dd) < 1e-3:
            break
        f += df
        dsym = dsym + dd * ramp
    ref = replica(sym, f, dsym, phase)
    if search > 0:
        lag = polish_lag(z, ref, lag, search)
    c, cnt = gains(z, ref, lag)
    box = np.ones(nfilt)
    cs = np.convolve(c * cnt, box, "same") / np.maximum(
        np.convolve(cnt, box, "same"), 1.0)
    fit = (np.repeat(cs, P.SPB) * ref).astype(np.complex64)
    out = z.copy()
    n = np.arange(_FRAME)
    m = lag + n
    inside = (m >= 0) & (m < len(z))
    out[m[inside]] -= fit[inside]
    return out
