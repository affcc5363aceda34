"""The plain reference agrees with the port's plain CPU path (float64, small
sizes) for each entry point, and its pieces hold their own identities."""

import math

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark.manifest import Manifest
from benchmark.tests.small import OVERRIDES


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_reference_matches_the_port_in_float64(cell, monkeypatch):
    man = Manifest()
    c = man.cell(cell)
    cfg = dict(man.config(c["config"]), dtype="float64")
    traffic = dict(man.traffic(c["traffic"]), **OVERRIDES[cell])
    job = man.entry(traffic["entry"]).Job(cfg, traffic, 2**31 + 17, "cpu")
    kept = job.keep(job.call(1))
    ref = job.reference(1)
    readings = job.compare(kept, ref, 1)
    assert max(readings.values()) < 1e-8, readings
    for key in kept:
        assert kept[key].shape == ref[key].shape


@pytest.mark.parametrize("lib", ["numpy", "torch"])
def test_sweep_libraries_agree(lib):
    man = Manifest()
    w = man.config("gtnmf_music_m32")["weights"]["piano"]
    model = man.config("gtnmf_music_m32")["model"]
    from benchmark import inputs

    y = inputs.prior_signal(inputs.stream(3, 0), model, w, 200)[None]
    obs = np.ones_like(y, bool)
    obs[0, 50:80] = False
    kw = dict(ep_itts=2, ep_fraction=0.75, damping=(0.1,))
    a = R.ep([w], model, y, obs, sweep=lib, **kw)
    b = R.ep([w], model, y, obs, sweep="torch" if lib == "numpy" else "numpy", **kw)
    for x, z in zip(a, b):
        torch.testing.assert_close(x, z, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [3, 9])
def test_ut9_is_exact_to_degree_9(n):
    w, x = R.ut9(n)
    assert len(w) == {3: 77, 9: 3973}[n]
    moments = {(): 1.0, (2,): 1.0, (4,): 3.0, (6,): 15.0, (8,): 105.0, (2, 2): 1.0,
               (4, 2): 3.0, (2, 2, 2): 1.0, (4, 4): 9.0, (6, 2): 15.0}
    for powers, want in moments.items():
        f = np.ones(len(w))
        for i, p in enumerate(powers):
            f = f * x[:, i] ** p
        assert (w * f).sum() == pytest.approx(want, rel=1e-10, abs=1e-10)
    assert abs((w * x[:, 0] ** 3).sum()) < 1e-12


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-12, -3.3e-7])
    got = R.tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 2.0**-9
    assert got[3] == 1.0
    assert abs(got[4] / x[4] - 1.0) <= 2.0**-11
    np.testing.assert_array_equal(R.tf32_round(x.numpy()), got.numpy())


def test_scans_match_a_plain_recursion():
    """The associative filter and smoother against the textbook recursions."""
    man = Manifest()
    cfg = man.config("gtnmf_mix3_exp")
    w = cfg["weights"]["M60"]
    ssm = R.SSM([w], cfg["model"]["kernel1"], cfg["model"]["kernel2"], R.F64, "cpu")
    T, (B, C, bs) = 37, ssm.H.shape
    g = torch.Generator().manual_seed(0)
    tt = torch.rand((T, B, C), generator=g, dtype=torch.float64) * 5
    tt[5:9] = 0.0
    tn = torch.randn((T, B, C), generator=g, dtype=torch.float64)
    ms, Ps = R.scan_filter(ssm, tt, tn, R.F64)
    sm, sP = R.scan_smoother(ssm, ms, Ps, R.F64)
    A, Q, H = ssm.A[0], ssm.Q[0], ssm.H[0]
    m, P = torch.zeros((C, bs), dtype=torch.float64), ssm.Pinf[0]
    fm, fP = [], []
    for t in range(T):
        mp, Pp = (A @ m[..., None])[..., 0], A @ P @ A.transpose(-1, -2) + Q
        PH = (Pp @ H[..., None])[..., 0]
        HPH, fmu = (H * PH).sum(-1), (H * mp).sum(-1)
        z = tt[t, 0] * HPH + 1
        m = mp - PH * ((tt[t, 0] * fmu - tn[t, 0]) / z)[:, None]
        P = Pp - (tt[t, 0] / z)[:, None, None] * PH[:, :, None] * PH[:, None, :]
        fm.append(m)
        fP.append(P)
    torch.testing.assert_close(ms[:, 0], torch.stack(fm), rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(Ps[:, 0], torch.stack(fP), rtol=1e-9, atol=1e-12)
    mn, Pn = fm[-1], fP[-1]
    pad = torch.diag_embed(ssm.pad[0])
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.transpose(-1, -2) + Q
        G = torch.linalg.solve(Pp + pad, A @ fP[t]).transpose(-1, -2)
        mn = fm[t] + (G @ (mn - (A @ fm[t][..., None])[..., 0])[..., None])[..., 0]
        Pn = fP[t] + G @ (Pn - Pp) @ G.transpose(-1, -2)
        torch.testing.assert_close(sm[t, 0], mn, rtol=1e-8, atol=1e-12)
        torch.testing.assert_close(sP[t, 0], Pn, rtol=1e-8, atol=1e-12)


def test_limits_are_finite_and_named():
    man = Manifest()
    for cell in man.cells:
        lim = man.limits(cell)
        assert lim and all(math.isfinite(v) and v > 0 for v in lim.values())
