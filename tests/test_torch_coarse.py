"""uwspr_tpu_torch coarse front against the JAX package: drift-model bank,
STFT power, smoothed SNR spectrum, peak pick, SLM drift, the sync grid
(on the CPU the card kernel's plain version) against the JAX conv and
einsum forms, and the whole coarse stage; for the host engine the host
peak pick, ``CoarseSearch`` and the Pallas-STFT configuration.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Tolerances, stated per comparison: the bank, peaks and integer fields
are exact; f32 reductions whose summation order differs between XLA and
torch are held to a few f32 ulps relative (rtol 1e-5); the bf16 forms of
both packages round the same operands to bf16 and accumulate in f32, so
they agree to the same f32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_copies import jax_coarse, jax_config
from uwspr_tpu.coarse import search as jsearch
from uwspr_tpu.models.slm import slm_frequency_drift_jnp
from uwspr_tpu.ops.stft import stft_power as jax_stft_host
from uwspr_tpu.ops.stft import stft_power_core as jax_stft
from uwspr_tpu.pipeline.jit_decoder import DeviceDecoder as JaxDecoder
from uwspr_tpu_torch.coarse import search as tsearch
from uwspr_tpu_torch.config import (CoarseConfig, PipelineConfig,
                                    with_serving_defaults)
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.models.slm import slm_frequency_drift_torch
from uwspr_tpu_torch.ops.stft import stft_power as torch_stft_host
from uwspr_tpu_torch.ops.stft import stft_power_core as torch_stft
from uwspr_tpu_torch.pipeline.device_decoder import DeviceDecoder
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

CFG = CoarseConfig()
M_HALF = CFG.fft_size // 2
CB0, CB1 = M_HALF - CFG.hpbm - 10, M_HALF + CFG.hpbm + 10


def _windows(n=2, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        z = synthesize_frame("K1ABC", "FN42", 37,
                             start_sample=int(rng.integers(0, 2000)),
                             freq_offset=float(rng.uniform(-5, 5)))
        out.append(awgn(z, -20, rng=rng))
    return np.stack(out)


Z = _windows()


def test_drift_models_match():
    for cfg in (CFG, CoarseConfig(maxdrift=2)):
        a = jsearch.build_drift_models(jax_coarse(cfg))
        b = tsearch.build_drift_models(cfg)
        for f in ("offsets", "is_nonlinear", "drift", "slm_params"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert jsearch.max_peaks(jax_coarse(cfg)) == tsearch.max_peaks(cfg)


@pytest.mark.parametrize("impl,col", [("fft", None), ("fft", (CB0, CB1)),
                                      ("matmul_bf16", (CB0, CB1)),
                                      ("matmul_bf16", None)])
def test_stft_power_matches(impl, col):
    ref = np.asarray(jax_stft(jnp.asarray(Z), n_ffts=CFG.n_ffts,
                              size=CFG.fft_size, hop=CFG.spb // 2, impl=impl,
                              col_window=col))
    got = torch_stft(torch.from_numpy(Z), n_ffts=CFG.n_ffts,
                     size=CFG.fft_size, hop=CFG.spb // 2, impl=impl,
                     col_window=col).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    # f32 FFT / f32-accumulated bf16 products: summation order only
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3 * ref.max())


def _ps(impl="matmul_bf16"):
    ps = jax_stft(jnp.asarray(Z), n_ffts=CFG.n_ffts, size=CFG.fft_size,
                  hop=CFG.spb // 2, impl=impl, col_window=(CB0, CB1))
    return np.array(ps)                                   # writable copy


def test_smoothed_spectrum_and_peaks_match():
    ps = _ps()
    ref = np.array(jsearch.smoothed_snr_spectrum(
        jnp.asarray(ps), hpbm=CFG.hpbm, m=M_HALF, col0=CB0))
    got = tsearch.smoothed_snr_spectrum(torch.from_numpy(ps), hpbm=CFG.hpbm,
                                        m=M_HALF, col0=CB0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)      # column sums
    cfg = PipelineConfig()
    jdec = JaxDecoder(jax_config(cfg))
    tdec = DeviceDecoder(_serving(cfg), device="cpu")
    v, i, s = tdec._peaks(torch.from_numpy(ref))
    for w in range(len(ref)):
        jv, ji, js = (np.asarray(x) for x in jdec._peaks(jnp.asarray(ref[w])))
        np.testing.assert_array_equal(v[w].numpy(), jv)   # exact on equal sm
        np.testing.assert_array_equal(i[w].numpy(), ji)
        np.testing.assert_allclose(s[w].numpy(), js, rtol=1e-6)


def test_slm_drift_matches():
    rng = np.random.default_rng(4)
    p = rng.uniform(-3, 3, size=(6, 4)).astype(np.float32)
    p[0] = 0.0                                            # ||q|| == 0 case
    t = ((np.arange(162) * 111) // 162).astype(np.float32)[None, :]
    ref = np.asarray(slm_frequency_drift_jnp(
        *(jnp.asarray(p[:, k:k + 1]) for k in range(4)), 1500.0,
        jnp.asarray(t)))
    got = slm_frequency_drift_torch(
        *(torch.from_numpy(p[:, k:k + 1]) for k in range(4)), 1500.0,
        torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_conv_grid_matches(dtype):
    ps = _ps("fft")
    bank = tsearch.build_drift_models(CFG)
    sign = 2.0 * np.asarray(jsearch.SYNC_VECTOR, np.float32) - 1.0
    if0 = np.array([[240, 245, 250], [247, 252, 258]]) - CB0
    fw = (M_HALF - CFG.hpbm - 7 - CB0, M_HALF + CFG.hpbm + 7 - CB0)
    got = tsearch.coarse_score_grid(
        torch.from_numpy(ps), torch.from_numpy(if0),
        torch.from_numpy(bank.offsets), torch.from_numpy(sign),
        f_window=fw, dtype=dtype).numpy()
    for w in range(2):
        ref = np.asarray(jsearch.coarse_score_grid(
            jnp.asarray(ps[w]), jnp.asarray(if0[w]),
            jnp.asarray(bank.offsets), jnp.asarray(sign), impl="conv",
            f_window=fw, dtype=dtype))
        assert got[w].shape == ref.shape == (3, 5, 26, len(bank.offsets))
        # 162-term f32 sums in another order: a few ulps of ss and pw
        np.testing.assert_allclose(got[w], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl, dtype", [("conv", "f32"), ("conv", "bf16"),
                                         ("einsum", "f32"),
                                         ("einsum", "bf16")])
def test_plain_grid_matches_forms(impl, dtype):
    """sync_grid_plain, the card kernel's arithmetic (162 gathers summed in
    ascending k), against the JAX coarse_score_grid's form, window by
    window: the conv at the narrowband column window, the einsum at the
    full 512 columns with a lane at bin 0 (its columns -2 and -1 wrap to
    the top) and one at the top bin (its columns past 511 clamp). Both sum
    the same 162 f32 terms of each cell in another order: a few ulps of ss
    and pw, rtol 1e-5."""
    bank = tsearch.build_drift_models(CFG)
    offs = torch.from_numpy(bank.offsets)
    sign = torch.from_numpy(2.0 * np.asarray(jsearch.SYNC_VECTOR,
                                             np.float32) - 1.0)
    if impl == "conv":
        ps = torch.from_numpy(_ps("fft"))
        if0 = torch.tensor([[240, 245, 250], [247, 252, 258]]) - CB0
        fw = (M_HALF - CFG.hpbm - 7 - CB0, M_HALF + CFG.hpbm + 7 - CB0)
    else:
        ps = torch.from_numpy(np.array(jax_stft(
            jnp.asarray(Z[:1]), n_ffts=CFG.n_ffts, size=CFG.fft_size,
            hop=CFG.spb // 2)))
        if0 = torch.tensor([[240, 0, 511]])
        fw = None
    lo, width = tsearch.grid_window(ps.shape[-1], fw)
    ifr = tsearch.grid_columns(if0, lo, width)
    if impl == "einsum":
        assert ifr[0, 1].tolist() == [510, 511, 0, 1, 2]
        assert ifr[0, 2].tolist() == [509, 510, 511, 511, 511]
    got = tsearch.sync_grid_plain(ps, ifr, offs, sign, lo=lo, width=width,
                                  dtype=dtype).numpy()
    for w in range(ps.shape[0]):
        ref = np.asarray(jsearch.coarse_score_grid(
            jnp.asarray(ps[w].numpy()), jnp.asarray(if0[w].numpy()),
            jnp.asarray(bank.offsets), jnp.asarray(sign.numpy()), impl=impl,
            f_window=fw, dtype=dtype))
        assert got[w].shape == ref.shape
        np.testing.assert_array_equal(np.isnan(got[w]), np.isnan(ref))
        np.testing.assert_allclose(got[w], ref, rtol=1e-5, atol=1e-6)


def test_plain_grid_equal_offset_rows_score_equal():
    """Two models with equal offset rows get bit-equal scores: every cell
    sums its terms in the same order whatever the model."""
    offs = torch.from_numpy(tsearch.build_drift_models(CFG).offsets).clone()
    offs[3] = offs[100]
    sign = torch.from_numpy(2.0 * np.asarray(jsearch.SYNC_VECTOR,
                                             np.float32) - 1.0)
    ps = torch.from_numpy(_ps("fft"))
    fw = (M_HALF - CFG.hpbm - 7 - CB0, M_HALF + CFG.hpbm + 7 - CB0)
    lo, width = tsearch.grid_window(ps.shape[-1], fw)
    ifr = tsearch.grid_columns(torch.tensor([[241, 249], [250, 255]]) - CB0,
                               lo, width)
    g = tsearch.sync_grid_plain(ps, ifr, offs, sign, lo=lo, width=width)
    assert torch.equal(g[..., 3].view(torch.int32),
                       g[..., 100].view(torch.int32))


def _serving(cfg):
    return with_serving_defaults(cfg, 2)


def test_coarse_stage_matches():
    """Peaks, selection and per-candidate metadata of the whole coarse
    stage under the serving config: valid, shift, mode, drift and SLM
    params exact; freq exact; snr to 1e-5 relative."""
    cfg = _serving(PipelineConfig())
    jdec = JaxDecoder(jax_config(cfg))
    ref = jax.vmap(jdec._coarse_stage)(jnp.asarray(Z.astype(np.complex64)))
    tdec = DeviceDecoder(cfg, device="cpu")
    with torch.no_grad():
        got = tdec._coarse_stage(torch.from_numpy(Z.astype(np.complex64)))
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.any()
    for key in ("shift", "mode", "drift", "slm_params", "freq"):
        np.testing.assert_array_equal(got[key].numpy()[valid],
                                      np.asarray(ref[key])[valid],
                                      err_msg=key)
    np.testing.assert_allclose(got["snr"].numpy(), np.asarray(ref["snr"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# host engine: full-width grid, peak pick, CoarseSearch, the Pallas STFT config
# ---------------------------------------------------------------------------

SCENES = np.stack([Z[0], _windows(1, seed=8)[0]])
HOST_CFG = CoarseConfig(maxfreqs=13)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_einsum_grid_matches(dtype):
    """The port's CPU grid at full 512-column width, as the host
    CoarseSearch calls it, against the JAX einsum form: 162-term f32 sums
    in another order, rtol 1e-5."""
    ps = np.array(jax_stft(jnp.asarray(Z), n_ffts=CFG.n_ffts,
                           size=CFG.fft_size, hop=CFG.spb // 2))
    bank = tsearch.build_drift_models(CFG)
    sign = 2.0 * np.asarray(jsearch.SYNC_VECTOR, np.float32) - 1.0
    if0 = np.array([[240, 245, 250, 0], [247, 252, 258, 270]], np.int32)
    got = tsearch.coarse_score_grid(
        torch.from_numpy(ps), torch.from_numpy(if0),
        torch.from_numpy(bank.offsets), torch.from_numpy(sign),
        dtype=dtype).numpy()
    for w in range(2):
        ref = np.asarray(jsearch.coarse_score_grid(
            jnp.asarray(ps[w]), jnp.asarray(if0[w]),
            jnp.asarray(bank.offsets), jnp.asarray(sign), impl="einsum",
            dtype=dtype))
        assert got[w].shape == ref.shape == (4, 5, 26, len(bank.offsets))
        np.testing.assert_allclose(got[w], ref, rtol=1e-5, atol=1e-6)


def test_detect_peaks_exact():
    """Same smoothed spectrum in, same peaks out; including a spectrum with
    more peaks than maxfreqs and one tie in SNR (stable order)."""
    rng = np.random.default_rng(12)
    ps = np.asarray(jax_stft(jnp.asarray(SCENES), n_ffts=CFG.n_ffts,
                             size=CFG.fft_size, hop=CFG.spb // 2))
    sms = [np.asarray(jsearch.smoothed_snr_spectrum(
        jnp.asarray(p), hpbm=CFG.hpbm, m=M_HALF)) for p in ps]
    ragged = rng.uniform(0.1, 5.0, 2 * CFG.hpbm).astype(np.float32)
    ragged[4] = ragged[10] = 9.0
    ragged[3] = ragged[5] = ragged[9] = ragged[11] = 0.05
    for sm in sms + [ragged]:
        for cfg in (CFG, CoarseConfig(maxfreqs=4)):
            for a, b in zip(tsearch.detect_peaks(sm, cfg),
                            jsearch.detect_peaks(sm, jax_coarse(cfg))):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _cands_equal(a, b):
    assert a.n == b.n
    for f in ("valid", "freq", "shift", "mode", "drift", "slm_params"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    # 6 Hz SNR from f32 FFT power sums; the coarse sync from 162-term sums
    np.testing.assert_allclose(a.snr, b.snr, rtol=1e-5)
    np.testing.assert_allclose(a.sync, b.sync, rtol=1e-5)


@pytest.mark.parametrize("w", [0, 1])
def test_coarse_search_matches(w):
    """Host CoarseSearch candidates of two scenes: fields exact, snr and
    sync to 1e-5 relative."""
    got = tsearch.CoarseSearch(HOST_CFG, device="cpu")(SCENES[w])
    ref = jsearch.CoarseSearch(jax_coarse(HOST_CFG))(SCENES[w])
    assert got.n > 0
    _cands_equal(got, ref)


def test_host_stft_power_matches():
    got = torch_stft_host(SCENES[0], n_ffts=CFG.n_ffts, size=CFG.fft_size,
                          hop=CFG.spb // 2, device="cpu").numpy()
    ref = np.asarray(jax_stft_host(SCENES[0], n_ffts=CFG.n_ffts,
                                   size=CFG.fft_size, hop=CFG.spb // 2))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3 * ref.max())


@pytest.mark.parametrize("col", [None, (CB0, CB1)])
def test_pallas_stft_plain_matches_jax_kernel(col):
    """impl="pallas" on a CPU tensor runs the matmul_bf16 plain version;
    against the interpreted Pallas kernel: the same bf16 roundings and f32
    sums in another order, so 1e-5 of each window's peak power."""
    from uwspr_tpu.ops.stft_pallas import stft_power_pallas
    from uwspr_tpu_torch.ops import stft as tstft
    before = tstft.PLAIN_CALLS
    got = torch_stft(torch.from_numpy(Z.astype(np.complex64)),
                     n_ffts=CFG.n_ffts, size=CFG.fft_size,
                     hop=CFG.spb // 2, impl="pallas", col_window=col).numpy()
    assert tstft.PLAIN_CALLS == before + 1
    for w in range(2):
        ref = np.asarray(stft_power_pallas(jnp.asarray(Z[w]),
                                           interpret=True))
        if col is not None:
            ref = ref[:, col[0]:col[1]]
        assert got[w].shape == ref.shape
        assert np.abs(got[w] - ref).max() <= 1e-5 * ref.max()


def _stft_gemm_emulation(z, consts, n_ffts, size, hop):
    """The CUDA kernel's GEMM in plain torch. B' is rebuilt from
    consts["frag"] as lane (g, t) = (lane // 4, lane % 4) of the kernel
    reads it: register m of n8 tile i in k16 step s holds B'[16s + k, n],
    k = (2t, 2t+1, 2t+8, 2t+9)[m], n = 8 * (block * nt + i) + g. A' holds
    the windowed frames rounded to bf16 with K taken as the kernel takes
    it: step s is the real parts of samples 8s..8s+7, then their imaginary
    parts. D = A' B' with exact bf16 products and f32 sums; the power is
    D[:, 2c]^2 + D[:, 2c+1]^2."""
    frag = consts["frag"]
    n_blocks, steps, nt = frag.shape[:3]
    ncols = consts["cos"].shape[1]
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    k = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=-1)
    Bp = torch.full((16 * steps, 8 * n_blocks * nt), float("nan"))
    for nb in range(n_blocks):
        for s in range(steps):
            for i in range(nt):
                n = 8 * (nb * nt + i) + g
                Bp[16 * s + k, n[:, None].expand(32, 4)] = (
                    frag[nb, s, i].float())
    assert not torch.isnan(Bp).any()             # every entry read once
    w = consts["window"]
    fl = z.shape[-1]
    pad = torch.nn.functional.pad(z, (0, n_ffts * hop + size - fl))
    idx = torch.arange(n_ffts)[:, None] * hop + torch.arange(size)
    frames = pad[..., idx]                                   # (B, n, size)
    fr = (frames.real * w).to(torch.bfloat16).float()
    fi = (frames.imag * w).to(torch.bfloat16).float()
    A = torch.stack([fr.reshape(fr.shape[:-1] + (steps, 8)),
                     fi.reshape(fi.shape[:-1] + (steps, 8))], dim=-2)
    D = A.reshape(A.shape[:-3] + (16 * steps,)) @ Bp
    power = D[..., 0::2] ** 2 + D[..., 1::2] ** 2
    assert (D[..., 2 * ncols:] == 0).all()        # zero padding columns
    return power[..., :ncols]


@pytest.mark.parametrize("col", [None, (CB0, CB1)])
def test_stft_gemm_formulation_matches_plain(col):
    """The tensor-core GEMM of csrc/stft_power.cu (interleaved
    [[C, S], [-S, C]] B in fragment order, [fr | fi] A, power of adjacent
    columns) against impl="matmul_bf16": the same bf16 products, f32 sums in
    another order, so 1e-5 of each window's peak power."""
    from uwspr_tpu_torch.ops import stft as tstft
    z = torch.from_numpy(Z.astype(np.complex64))
    consts = tstft.stft_constants(CFG.fft_size, col, z.device)
    kw = dict(n_ffts=CFG.n_ffts, size=CFG.fft_size, hop=CFG.spb // 2)
    want = torch_stft(z, impl="matmul_bf16", col_window=col, consts=consts,
                      **kw)
    got = _stft_gemm_emulation(z, consts, **kw)
    assert got.shape == want.shape
    peak = want.amax(dim=(-2, -1), keepdim=True)
    assert float(((got - want).abs() / peak).max()) <= 1e-5


@pytest.mark.parametrize("ncols,nt,n_blocks", [(48, 12, 1), (512, 16, 8),
                                                (1, 4, 1), (17, 8, 1),
                                                (40, 12, 1), (100, 16, 2)])
def test_dft_fragment_shapes(ncols, nt, n_blocks):
    from uwspr_tpu_torch.ops import stft as tstft
    assert tstft.mma_tiles(ncols) == nt
    c = torch.zeros((64, ncols))
    frag = tstft.dft_fragments(c, c)
    assert tuple(frag.shape) == (n_blocks, 8, nt, 32, 4)
    assert frag.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("col", [None, (CB0, CB1)])
def test_stft_kernel_matches_plain_on_card(col):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    from uwspr_tpu_torch.ops import stft as tstft
    z = torch.from_numpy(Z.astype(np.complex64)).cuda()
    kw = dict(n_ffts=CFG.n_ffts, size=CFG.fft_size, hop=CFG.spb // 2,
              col_window=col)
    before = tstft.KERNEL_LAUNCHES
    pk = torch_stft(z, impl="pallas", **kw)
    pp = torch_stft(z, impl="matmul_bf16", **kw)
    torch.cuda.synchronize()
    assert tstft.KERNEL_LAUNCHES == before + 1
    peak = pp.amax(dim=(-2, -1), keepdim=True)
    assert float(((pk - pp).abs() / peak).max()) <= 1e-5
