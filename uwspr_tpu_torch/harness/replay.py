"""The kernels of a path, held to their plain versions on the path's own
inputs: the wrappers' launch and plain-call counts, and ``KernelReplay``,
which records every selection, Fano and probe call a decode makes and
replays each against its oracle afterwards.

    with KernelReplay() as calls:
        reset_counters()
        out = decoder.decode_windows_ri(ri)
        launches, plain = counters()
    res = calls.replay()        # res["ok"], res["failures"]

The oracles: ``select_best_plain`` on the call's device (best bitwise,
index equal); the native C++ Fano decoder (fec/fano_native.cc) at the
call's metric table, delta and budget on the active lanes (success, data,
metric, cycles and maxnp equal), and the kernel's contract on the inactive
lanes (no success, data, metric and maxnp 0, cycles 1);
``probe_powers_plain`` on the call's device, within PROBE_RTOL and
PROBE_ATOL a power and SYNC_ATOL on the sync derived from the powers.
"""

from __future__ import annotations

import numpy as np
import torch

from uwspr_tpu_torch.harness.bench import COUNTED

PROBE_RTOL, PROBE_ATOL = 2e-4, 2e-2
SYNC_ATOL = 1e-5
FANO_FIELDS = ("success", "data", "metric", "cycles", "maxnp")


def reset_counters() -> None:
    for _, m in COUNTED:
        m.reset_counters()


def counters() -> tuple[dict, dict]:
    """(kernel launches, plain calls) by kernel, from the wrappers."""
    return ({k: m.KERNEL_LAUNCHES for k, m in COUNTED},
            {k: m.PLAIN_CALLS for k, m in COUNTED})


def fano_difference(a: dict, b: dict) -> tuple[float, list[str]]:
    """(the largest absolute difference over the Fano result fields, the
    fields whose shape or values differ) of two results by field."""
    err, bad = 0.0, []
    for key in FANO_FIELDS:
        x = np.asarray(a[key].cpu() if hasattr(a[key], "cpu") else a[key])
        y = np.asarray(b[key].cpu() if hasattr(b[key], "cpu") else b[key])
        if x.shape != y.shape:
            bad.append(f"{key} shape {x.shape} != {y.shape}")
            continue
        err = max(err, float(np.abs(x.astype(np.int64)
                                    - y.astype(np.int64)).max(initial=0)))
        if not np.array_equal(x, y):
            bad.append(f"{key} differs")
    return err, bad


def probe_difference(pk: torch.Tensor, pp: torch.Tensor
                     ) -> tuple[float, list[str]]:
    """(max |pk - pp|, what breaks PROBE_RTOL/PROBE_ATOL or SYNC_ATOL) of a
    probe kernel's powers ``pk`` against its plain version's ``pp``."""
    from uwspr_tpu_torch.demod.finesync import probe_constants, sync_of_powers
    if pk.shape != pp.shape:
        return float("inf"), [f"shape {tuple(pk.shape)} != "
                              f"{tuple(pp.shape)}"]
    if not bool(torch.isfinite(pk).all()):
        return float("inf"), ["non-finite powers"]
    d = (pk - pp).abs()
    bad = []
    n_off = int((d > PROBE_ATOL + PROBE_RTOL * pp.abs()).sum())
    if n_off:
        bad.append(f"{n_off} powers off, max |diff| {float(d.max()):.3g}")
    sign = probe_constants(pk.device)["sign"]
    ds = float((sync_of_powers(pk, sign) - sync_of_powers(pp, sign)).abs()
               .max())
    if ds > SYNC_ATOL:
        bad.append(f"sync differs by {ds:.3g}")
    return float(d.max()), bad


class KernelReplay:
    """While active, keeps a host copy of the inputs and outputs of every
    select_best and fano_decode_batch call that the device engine makes
    (pipeline/device_decoder.py binds both names), and of every select_best
    and probe_powers call of the host engine (coarse/search.py and
    demod/finesync.py bind them), so that ``replay()`` can hold each call
    against its oracle afterwards. Host copies leave the card's peak
    memory as the path alone has it."""

    def __enter__(self):
        from uwspr_tpu_torch.coarse import search
        from uwspr_tpu_torch.demod import finesync
        from uwspr_tpu_torch.pipeline import device_decoder as ddm
        self.ddm, self.search, self.finesync = ddm, search, finesync
        self.orig = (ddm.select_best, ddm.fano_decode_batch,
                     search.select_best, finesync.probe_powers)
        self.select, self.fano, self.probe = [], [], []
        select_k, fano_k, host_select_k, probe_k = self.orig
        if select_k is not host_select_k:
            raise RuntimeError("the engines bind different select_best "
                               "functions")

        def select(grid, is_nl, *, threshold):
            best, idx = select_k(grid, is_nl, threshold=threshold)
            self.select.append((grid.cpu(), is_nl.cpu(), threshold,
                                best.cpu(), idx.cpu(), grid.device))
            return best, idx

        def fano(symbols, mettab, active=None, *, delta=60, maxcycles=10000):
            out = fano_k(symbols, mettab, active, delta=delta,
                         maxcycles=maxcycles)
            self.fano.append((symbols.to(torch.uint8).cpu(), mettab.cpu(),
                              None if active is None else
                              (active != 0).cpu(), delta, maxcycles,
                              {k: v.cpu() for k, v in out.items()}))
            return out

        def probe(z_ri, lags, freqs, drift_sym, *, n_lags):
            p = probe_k(z_ri, lags, freqs, drift_sym, n_lags=n_lags)
            self.probe.append((z_ri.cpu(), lags.cpu(), freqs.cpu(),
                               drift_sym.cpu(), n_lags, p.cpu(),
                               z_ri.device))
            return p
        ddm.select_best, ddm.fano_decode_batch = select, fano
        search.select_best, finesync.probe_powers = select, probe
        return self

    def __exit__(self, *exc):
        (self.ddm.select_best, self.ddm.fano_decode_batch,
         self.search.select_best, self.finesync.probe_powers) = self.orig

    def replay(self) -> dict:
        """Every recorded call against its oracle (the module doc): the
        calls and lanes replayed, the full-budget Fano timeouts, the
        largest Fano field and probe power differences, every failure
        found, and ``ok`` (no failure: the selection and Fano calls
        bit-exact, the probe calls within tolerance)."""
        from uwspr_tpu_torch.device import exact_f32
        from uwspr_tpu_torch.fec.host import fano_decode_batch_host
        from uwspr_tpu_torch.ops.probe import probe_powers_plain
        from uwspr_tpu_torch.ops.select import select_best_plain
        failures, n_sel = [], 0
        for grid, is_nl, thr, best, idx, dev in self.select:
            bp, ip = select_best_plain(grid.to(dev), is_nl.to(dev),
                                       threshold=thr)
            if not (torch.equal(best.view(torch.int32),
                                bp.cpu().view(torch.int32))
                    and torch.equal(idx, ip.cpu())):
                failures.append(f"select_best differs from its plain "
                                f"version on the grid {tuple(grid.shape)}")
            n_sel += grid.shape[0]
        err, n_act, n_timeout = 0.0, 0, 0
        for sym, met, act, delta, mc, out in self.fano:
            a = np.ones(sym.shape[0], bool) if act is None else act.numpy()
            ref = fano_decode_batch_host(sym.numpy(), a, backend="native",
                                         device="cpu", mettab=met.numpy(),
                                         delta=delta, maxcycles=mc)
            k = {f: out[f].numpy() for f in FANO_FIELDS}
            e, bad = fano_difference({f: v[a] for f, v in k.items()},
                                     {f: np.asarray(v)[a]
                                      for f, v in zip(FANO_FIELDS, ref)})
            err = max(err, e)
            failures += [f"fano_decode (maxcycles={mc}) vs native: {b}"
                         for b in bad]
            i = ~a
            if not (not k["success"][i].any() and (k["data"][i] == 0).all()
                    and (k["metric"][i] == 0).all()
                    and (k["cycles"][i] == 1).all()
                    and (k["maxnp"][i] == 0).all()):
                failures.append("inactive Fano lanes break the contract")
            n_act += int(a.sum())
            n_timeout += int((k["cycles"][a] >= mc * 81).sum())
        perr, n_cand = 0.0, 0
        for z_ri, lags, freqs, dsym, n_lags, pk, dev in self.probe:
            with torch.no_grad(), exact_f32():
                pp = probe_powers_plain(z_ri.to(dev), lags.to(dev),
                                        freqs.to(dev), dsym.to(dev),
                                        n_lags=n_lags)
            e, bad = probe_difference(pk.to(dev), pp)
            perr = max(perr, e)
            failures += [f"probe_powers {tuple(pk.shape)}: {b}" for b in bad]
            n_cand += freqs.shape[0]
        return {"select_calls": len(self.select), "select_lanes": n_sel,
                "fano_calls": len(self.fano), "fano_active_lanes": n_act,
                "fano_timeouts": n_timeout, "fano_max_abs_err": err,
                "probe_calls": len(self.probe), "probe_candidates": n_cand,
                "probe_max_abs_err": perr, "failures": failures,
                "ok": not failures}


def merged(replays: list[dict]) -> dict:
    """Replays of one path's several runs (or ranks) as one: the counts
    summed, the largest differences, every failure, ``ok`` of them all."""
    out = {k: sum(r[k] for r in replays) for k in (
        "select_calls", "select_lanes", "fano_calls", "fano_active_lanes",
        "fano_timeouts", "probe_calls", "probe_candidates")}
    for k in ("fano_max_abs_err", "probe_max_abs_err"):
        out[k] = max((r[k] for r in replays), default=0.0)
    out["failures"] = [f for r in replays for f in r["failures"]]
    out["ok"] = all(r["ok"] for r in replays)
    return out


def combined(runs: list[dict]) -> dict:
    """Recorded runs of one path ({"launches", "plain", "replay"} each) as
    one: launches and plain calls summed by kernel, the replays merged."""
    return {"launches": {k: sum(r["launches"][k] for r in runs)
                         for k in runs[0]["launches"]},
            "plain": {k: sum(r["plain"][k] for r in runs)
                      for k in runs[0]["plain"]},
            "replay": merged([r["replay"] for r in runs])}


__all__ = ["FANO_FIELDS", "KernelReplay", "PROBE_ATOL", "PROBE_RTOL",
           "SYNC_ATOL", "combined", "counters", "fano_difference", "merged",
           "probe_difference", "reset_counters"]
