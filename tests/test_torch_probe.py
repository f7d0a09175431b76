"""uwspr_tpu_torch.ops.probe and the host probe grid against the JAX package.

The port's plain probe powers are held against the JAX engine's
``_probe_powers_xla`` and against the Pallas kernel ``probe_powers_pallas``
(interpret mode on the CPU), at the shapes of tests/test_probe_pallas.py
plus the edge lags -200 and 3400, with nonzero drift. Inputs are made with
numpy from a seed.

Tolerances: the plain version is a transcription of ``_probe_powers_xla``
(same window, same f32 angles), so it differs only by the cos/sin of two
libraries and the order of the 1024-term complex sums: |corr| to 1e-5
relative plus 1e-3 absolute (powers reach ~300). Against the Pallas
kernel, which takes its sums and phases in another order, the JAX test's
own rtol 2e-4, atol 2e-2. Sync scores, ratios of 162-symbol sums, to 1e-5.
The CUDA kernel is held against the plain version on the card by the test
marked ``cuda``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uwspr_tpu.demod import finesync as jfs
from uwspr_tpu.ops.probe_pallas import pad_window_ri, probe_powers_pallas
from uwspr_tpu_torch.demod import finesync as tfs
from uwspr_tpu_torch.io.channel import awgn
from uwspr_tpu_torch.ops import probe
from uwspr_tpu_torch.protocol.modulate import synthesize_frame

RTOL_XLA, ATOL_XLA = 1e-5, 1e-3
RTOL_PALLAS, ATOL_PALLAS = 2e-4, 2e-2
SYNC_ATOL = 1e-5


def _window():
    rng = np.random.default_rng(0)
    z = synthesize_frame("VE3EMB", "FN25", 30, start_sample=700,
                         freq_offset=1.3)
    return awgn(z, -15, rng=rng).astype(np.complex64)


Z = _window()


def _case(C, F, L, edge=False):
    """(lags (C, L) int32, freqs (C, F) f32, drift (C, 162) f32): lane 0 on
    the frame, the others off it with a drift ramp; ``edge`` moves lanes 1
    and 2 to lags -200 and 3400, which read zero padding."""
    lags = np.stack([700 + np.arange(L) * 64 - 64,
                     *[np.arange(L) * 32 + 600] * (C - 1)]).astype(np.int32)
    if edge:
        lags[1] = -200 + np.arange(L) * 32
        lags[2] = 3400 + np.arange(L) * 32
    freqs = (1.3 + 0.25 * (np.arange(F) - F // 2)
             )[None, :].repeat(C, 0).astype(np.float32)
    drift = np.zeros((C, 162), np.float32)
    drift[1:] = np.linspace(-0.5, 0.5, 162)[None, :]
    return lags, freqs, drift


CASES = {"3x1x5": (3, 1, 5, False), "2x5x1": (2, 5, 1, False),
         "2x1x3": (2, 1, 3, False), "edge_3x1x5": (3, 1, 5, True),
         "edge_3x2x1": (3, 2, 1, True)}


def _port(lags, freqs, drift, L):
    z_ri = torch.from_numpy(tfs.complex_to_ri(Z))
    return probe.probe_powers(z_ri, torch.from_numpy(lags),
                              torch.from_numpy(freqs),
                              torch.from_numpy(drift), n_lags=L).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_xla_and_pallas(name):
    C, F, L, edge = CASES[name]
    lags, freqs, drift = _case(C, F, L, edge)
    before = probe.PLAIN_CALLS
    got = _port(lags, freqs, drift, L)
    assert probe.PLAIN_CALLS == before + 1          # CPU tensor -> plain
    assert got.shape == (C, F, L, 162, 4) and got.dtype == np.float32
    ref = np.asarray(jfs._probe_powers_xla(
        jnp.asarray(Z), jnp.asarray(lags), jnp.asarray(freqs),
        jnp.asarray(drift), n_lags=L))
    np.testing.assert_allclose(got, ref, rtol=RTOL_XLA, atol=ATOL_XLA)
    pal = np.asarray(probe_powers_pallas(
        pad_window_ri(jnp.asarray(tfs.complex_to_ri(Z))), jnp.asarray(lags),
        jnp.asarray(freqs), jnp.asarray(drift), n_lags=L, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=RTOL_PALLAS, atol=ATOL_PALLAS)


def test_lags_past_the_padding_clip_as_xla():
    """Lags beyond the zero padding are clipped to the padded window as
    _probe_powers_xla clips them (finesync.py:127-130), not zeroed."""
    lags = np.array([[-50000, -4000], [50000, 9000]], np.int32)
    freqs = np.full((2, 1), 1.3, np.float32)
    drift = np.zeros((2, 162), np.float32)
    got = _port(lags, freqs, drift, 2)
    ref = np.asarray(jfs._probe_powers_xla(
        jnp.asarray(Z), jnp.asarray(lags), jnp.asarray(freqs),
        jnp.asarray(drift), n_lags=2))
    assert got.any()
    np.testing.assert_allclose(got, ref, rtol=RTOL_XLA, atol=ATOL_XLA)


@pytest.mark.parametrize("name", ["3x1x5", "2x5x1", "edge_3x1x5"])
def test_probe_grid_sync_matches_jax(name):
    C, F, L, edge = CASES[name]
    lags, freqs, drift = _case(C, F, L, edge)
    js, jp = jfs.eval_probe_grid(Z, lags, freqs, drift, n_lags=L,
                                 want_symbols=True)
    ts, tp = tfs.eval_probe_grid(Z, lags, freqs, drift, n_lags=L,
                                 want_symbols=True)
    assert ts.shape == (C, F, L) and tp.shape == (C, F, L, 162, 4)
    np.testing.assert_allclose(ts, np.asarray(js), atol=SYNC_ATOL)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=RTOL_XLA,
                               atol=ATOL_XLA)
    core = tfs.eval_probe_grid_core(
        torch.from_numpy(tfs.complex_to_ri(Z)), torch.from_numpy(lags),
        torch.from_numpy(freqs), torch.from_numpy(drift), n_lags=L)
    np.testing.assert_array_equal(core.numpy(), ts)


def test_host_helpers_match_jax():
    from uwspr_tpu.coarse.search import Candidates as JCands
    rng = np.random.default_rng(4)
    C = 6
    kw = dict(valid=np.ones(C, bool), freq=np.zeros(C, np.float32),
              snr=np.zeros(C, np.float32), sync=np.zeros(C, np.float32),
              shift=np.zeros(C, np.int32),
              mode=np.array([0, 1, 0, 1, 1, 0], np.int32),
              drift=rng.uniform(-2, 2, C).astype(np.float32),
              slm_params=rng.uniform(-1, 1, (C, 4)).astype(np.float32))
    d1 = rng.uniform(-2, 2, C).astype(np.float32)
    np.testing.assert_array_equal(
        tfs.drift_offsets(tfs.Candidates(**kw), d1, 1500.0),
        jfs.drift_offsets(JCands(**kw), d1, 1500.0))
    np.testing.assert_array_equal(tfs.complex_to_ri(Z), jfs.complex_to_ri(Z))
    sync = rng.normal(size=(C, 5, 3)).astype(np.float32)
    sync[0, 1, 2] = sync[0, 3, 0] = sync[0].max() + 1.0      # tie: first wins
    for a, b in zip(tfs._first_argmax(sync), jfs._first_argmax(sync)):
        np.testing.assert_array_equal(a, b)


def _lag_shared_emulation(z_ri, lags, freqs, drift, n_lags):
    """The CUDA kernel's formulation in plain torch: per candidate one
    derotated window zd[i, j'] over the span [min b, max b + 256) of window
    indices its lags reach and one tone bank T[f, t, j'] over the same span,
    each built once with the kernel's f32 angles; every lag sums its slice
    [b, b + 256) of zd * T. The sample index is o + 256*i + j' with
    o = base - PAD, zero outside 1 <= n < N (sample 0 is zeroed)."""
    N = z_ri.shape[1]
    base, b = probe.lag_offsets(lags, N)
    C, F = freqs.shape
    z = torch.complex(z_ri[0], z_ri[1])
    phase = torch.tensor(probe.PHASE)
    tones = torch.from_numpy(probe.TONES_HZ)
    out = torch.empty((C, F, n_lags, 162, 4))
    for c in range(C):
        lo, hi = int(b[c].min()), int(b[c].max()) + 256
        jp = torch.arange(lo, hi)
        n = int(base[c]) - probe.PAD + 256 * torch.arange(162)[:, None] + jp
        x = torch.where((n >= 1) & (n < N), z[n.clamp(0, N - 1)], 0)
        ad = (phase * drift[c])[:, None] * jp.float()
        zd = x * torch.complex(torch.cos(ad), torch.sin(ad))    # (162, W')
        ab = (phase * (freqs[c][:, None] + tones))[..., None] * jp.float()
        bank = torch.complex(torch.cos(ab), torch.sin(ab))      # (F, 4, W')
        for lag in range(n_lags):
            k = int(b[c, lag]) - lo
            prod = (zd[None, :, None, k:k + 256]
                    * bank[:, None, :, k:k + 256])              # (F,162,4,256)
            out[c, :, lag] = prod.sum(-1).abs()
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["jiggles_4x1x17",
                                                  "freqs_2x16x2"])
def test_lag_shared_formulation_matches_plain(name):
    """The lag-shared probe (one derotated window per (c, i), one bank per
    c, sliced per lag) against probe_powers_plain, with edge lags and
    nonzero drift; the sums are taken in another order, so the plain
    version's own tolerance against _probe_powers_xla."""
    if name == "jiggles_4x1x17":
        lags, freqs, drift = _case(4, 1, 17, edge=True)
        lags[0] = 700 + 8 * np.array([0, -1, 1, -2, 2, -3, 3, -4, 4, -5, 5,
                                      -6, 6, -7, 7, -8, 8])
    elif name == "freqs_2x16x2":
        lags, freqs, drift = _case(2, 16, 2)
    else:
        C, F, L, edge = CASES[name]
        lags, freqs, drift = _case(C, F, L, edge)
    L = lags.shape[1]
    args = [torch.from_numpy(a) for a in (tfs.complex_to_ri(Z), lags, freqs,
                                          drift)]
    want = probe.probe_powers_plain(*args, n_lags=L).numpy()
    got = _lag_shared_emulation(*args, n_lags=L).numpy()
    assert want.max() > 50.0
    np.testing.assert_allclose(got, want, rtol=RTOL_XLA, atol=ATOL_XLA)
    sign = tfs.probe_constants("cpu")["sign"]
    np.testing.assert_allclose(
        tfs.sync_of_powers(torch.from_numpy(got), sign).numpy(),
        tfs.sync_of_powers(torch.from_numpy(want), sign).numpy(),
        atol=SYNC_ATOL)


@pytest.mark.parametrize("L,F", [(5, 1), (1, 5), (17, 1), (1, 16), (2, 16),
                                 (1, 1), (40, 16)])
def test_kernel_tiling(L, F):
    """Every thread owns one (lag, freq) and 2 symbols of a tile: the block
    covers L * F * S / 2 outputs, the tiles cover the 162 symbols, and the
    shared memory fits a block of the card (227 KB)."""
    S, threads, smem = probe.kernel_tiling(L, F)
    assert S % 2 == 0 and 2 <= S <= 64
    assert max(128, L * F * S // 2) <= threads <= 1024
    assert threads % 32 == 0
    tiles = -(-162 // S)
    assert tiles * S >= 162 and (tiles - 1) * S < 162
    assert smem == 8 * (S + 4 * F) * 129 <= 227 * 1024
    if L * F <= 256:
        assert threads <= 256 + 31


def test_wrapper_rejects_bad_input():
    lags, freqs, drift = _case(2, 1, 3)
    z_ri = torch.from_numpy(tfs.complex_to_ri(Z))
    with pytest.raises(ValueError, match="lags"):
        probe.probe_powers(z_ri, torch.from_numpy(lags), torch.from_numpy(
            freqs), torch.from_numpy(drift), n_lags=2)
    with pytest.raises(ValueError, match="z_ri"):
        probe.probe_powers(z_ri.double(), torch.from_numpy(lags),
                           torch.from_numpy(freqs), torch.from_numpy(drift),
                           n_lags=3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel-against-plain check)")
    C, F, L, edge = CASES[name]
    lags, freqs, drift = _case(C, F, L, edge)
    args = [torch.from_numpy(a).cuda()
            for a in (tfs.complex_to_ri(Z), lags, freqs, drift)]
    before = probe.KERNEL_LAUNCHES
    pk = probe.probe_powers(*args, n_lags=L)
    pp = probe.probe_powers_plain(*args, n_lags=L)
    torch.cuda.synchronize()
    assert probe.KERNEL_LAUNCHES == before + 1
    np.testing.assert_allclose(pk.cpu().numpy(), pp.cpu().numpy(),
                               rtol=RTOL_PALLAS, atol=ATOL_PALLAS)


def test_build_log_readers():
    """chip_smoke.py reports registers, shared memory and tensor-core
    instructions from the nvcc build: the readers on canned tool output."""
    from uwspr_tpu_torch.utils import cuda_build
    log = ("ptxas info    : Compiling entry function '_Z3fooPf' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info    : Used 95 registers, 16 bytes smem, 392 bytes "
           "cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z3barv' for "
           "'sm_90a'\n"
           "ptxas info    : Used 12 registers, 352 bytes cmem[0]\n")
    assert cuda_build.kernel_resources(log) == {
        "_Z3fooPf": {"registers": 95, "smem_bytes": 16, "spill_bytes": 8},
        "_Z3barv": {"registers": 12, "smem_bytes": 0, "spill_bytes": 0}}
    sass = ("\t\tFunction : _Z3fooPf\n"
            "        /*0a30*/                   HMMA.16816.F32.BF16 R24, R44,"
            " R52, R24 ;  /* 0x000000342c18723c */\n"
            "        /*0a40*/               @P0 HMMA.16816.F32.BF16 R28, R44,"
            " R54, R28 ;  /* 0x000000362c1c723c */\n"
            "        /*0a50*/                   LDS.64 R2, [R3] ;\n"
            "\t\tFunction : _Z3barv\n"
            "        /*0010*/                   FFMA R1, R2, R3, R4 ;\n")
    assert cuda_build.parse_sass(sass, "HMMA") == {
        "_Z3fooPf": {"HMMA.16816.F32.BF16": 2}, "_Z3barv": {}}
