"""Blocked (two-level) parallel Kalman filtering / smoothing.

Port of ``nsgp_tpu/ops/bscan.py`` without its ``time_axis`` sharding:

  pass 1: split T into nc chunks of L steps; L combines compose every
          chunk's total element, vectorised over all nc chunks;
  pass 2: compose the chunk totals across the nc chunks (an exclusive
          prefix; here a loop over nc, which is small);
  pass 3: re-walk each chunk from its cross-chunk prefix and emit the
          filtered / smoothed moments, flattened to (T, C*bs[*bs]).

The elements are built on the fly from the (T, C) site rows / flattened
filtered moments; sequential depth is 2L + nc instead of T.  Element algebra:
``ops.pscan``.  These are plain PyTorch: the design the blocked kernels of
``csrc/fused_kalman.cuh`` follow (``ops.fused_kalman`` holds the kernels' own
plain versions), and the parallel path of ``backend="seq"``.
"""

from __future__ import annotations

import torch

from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.pscan import (_filter_combine, _make_filter_elem, _mv,
                                      _smoother_combine, _sym)
from nsgp_tpu_torch.ops.ssm import BlockSSM


def _identity(n, C, bs, like, parts):
    """The neutral element with ``parts`` = 'MvMvM' (filter) or 'MvM'
    (smoother): identity, then zeros, batched as (n, C, ...)."""
    kw = dict(dtype=like.dtype, device=like.device)
    out = []
    for i, p in enumerate(parts):
        if p == "v":
            out.append(torch.zeros((n, C, bs), **kw))
        elif i == 0:
            out.append(torch.eye(bs, **kw).expand(n, C, bs, bs).clone())
        else:
            out.append(torch.zeros((n, C, bs, bs), **kw))
    return tuple(out)


def _exclusive_scan(combine, totals, ident, reverse=False):
    """Element k of the result composes the totals before k (after k when
    ``reverse``), the neutral element first; a loop over the chunk axis."""
    nc = totals[0].shape[0]
    acc = ident
    out = [None] * nc
    order = range(nc - 1, -1, -1) if reverse else range(nc)
    for k in order:
        out[k] = acc
        acc = combine(acc, tuple(x[k:k + 1] for x in totals))
    return tuple(torch.cat(xs, dim=0) for xs in zip(*out))


def blocked_filter_with_sites(ssm: BlockSSM, sites: Sites, chunk: int = 512):
    """Parallel-in-time forward filter with fixed sites; O(2L + T/L) depth.
    Returns flattened filtered moments (ms (T, C*bs), Ps (T, C*bs*bs))."""
    C, bs = ssm.H.shape
    L = int(chunk)
    T = sites.ttau.shape[0]
    nc = -(-T // L)
    pad = nc * L - T  # zero-padded sites at the end: inert steps, trimmed
    tt = torch.nn.functional.pad(sites.ttau, (0, 0, 0, pad)).reshape(nc, L, C)
    tn = torch.nn.functional.pad(sites.tnu, (0, 0, 0, pad)).reshape(nc, L, C)
    first_chunk = (torch.arange(nc, device=tt.device) == 0)[:, None, None, None]
    never = torch.zeros_like(first_chunk)
    elem = lambda i: _make_filter_elem(ssm, tt[:, i], tn[:, i], first_chunk if i == 0 else never)

    totals = _identity(nc, C, bs, ssm.A, "MvMvM")
    for i in range(L):
        totals = _filter_combine(totals, elem(i))
    carry = _exclusive_scan(_filter_combine, totals, _identity(1, C, bs, ssm.A, "MvMvM"))
    ms, Ps = [], []
    for i in range(L):
        carry = _filter_combine(carry, elem(i))
        ms.append(carry[1].reshape(nc, -1))
        Ps.append(carry[2].reshape(nc, -1))
    # (L, nc, K) -> (nc, L, K) -> (nc*L, K) -> trim the padding
    ms = torch.stack(ms, dim=1).reshape(nc * L, -1)[:T]
    Ps = torch.stack(Ps, dim=1).reshape(nc * L, -1)[:T]
    return ms, Ps


def _make_smoother_elem(ssm: BlockSSM, ms_row, Ps_row, is_last):
    """Smoothing element for a batch of steps from flattened filtered
    moments: ms_row (nc, C*bs), Ps_row (nc, C*bs*bs); ``is_last`` selects the
    global step T-1 element (E = 0, g = m, L = P)."""
    C, bs = ssm.H.shape
    nc = ms_row.shape[0]
    m = ms_row.reshape(nc, C, bs)
    P = Ps_row.reshape(nc, C, bs, bs)
    A, Q = ssm.A, ssm.Q
    At = A.transpose(-1, -2)
    Pp = _sym(A @ P @ At + Q)
    PA = P @ At
    E = torch.linalg.solve((Pp + ssm.pad_eye).transpose(-1, -2),
                           PA.transpose(-1, -2)).transpose(-1, -2)
    g = m - _mv(E, _mv(A, m))
    Lm = _sym(P - E @ Pp @ E.transpose(-1, -2))
    m1, m2 = is_last, is_last[..., 0]
    zero = torch.zeros((), dtype=E.dtype, device=E.device)
    return torch.where(m1, zero, E), torch.where(m2, m, g), _sym(torch.where(m1, P, Lm))


def blocked_rts_smoother(ssm: BlockSSM, ms, Ps, chunk: int = 512):
    """Parallel-in-time RTS smoother over flattened filtered moments.
    Returns flattened smoothed (ms (T, C*bs), Ps (T, C*bs*bs))."""
    C, bs = ssm.H.shape
    L = int(chunk)
    T = ms.shape[0]
    # Pad at the front so the global last step stays last; the padded rows
    # carry Pinf (any PSD value works) and are trimmed after.
    pad = (-T) % L
    if pad:
        ms = torch.cat([ms.new_zeros((pad, ms.shape[1])), ms], dim=0)
        Ps = torch.cat([ssm.Pinf.reshape(1, -1).expand(pad, -1), Ps], dim=0)
    nc = ms.shape[0] // L
    msc = ms.reshape(nc, L, -1)
    Psc = Ps.reshape(nc, L, -1)
    last_chunk = (torch.arange(nc, device=ms.device) == nc - 1)[:, None, None, None]
    never = torch.zeros_like(last_chunk)
    elem = lambda i: _make_smoother_elem(ssm, msc[:, i], Psc[:, i],
                                         last_chunk if i == L - 1 else never)

    # reverse walks: i = L-1 .. 0 (suffix compositions)
    totals = _identity(nc, C, bs, ssm.A, "MvM")
    for i in range(L - 1, -1, -1):
        totals = _smoother_combine(totals, elem(i))
    carry = _exclusive_scan(_smoother_combine, totals, _identity(1, C, bs, ssm.A, "MvM"),
                            reverse=True)
    sm, sP = [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        carry = _smoother_combine(carry, elem(i))
        sm[i] = carry[1].reshape(nc, -1)
        sP[i] = carry[2].reshape(nc, -1)
    sm = torch.stack(sm, dim=1).reshape(nc * L, -1)[pad:]
    sP = torch.stack(sP, dim=1).reshape(nc * L, -1)[pad:]
    return sm, sP


def blocked_filter_smoother(ssm: BlockSSM, sites: Sites, chunk: int = 512,
                            jitter: float = 0.0):
    """One full linear-Gaussian forward/backward pass, blocked-parallel."""
    del jitter  # pad_eye regularises the smoother-gain solves
    ms, Ps = blocked_filter_with_sites(ssm, sites, chunk)
    return blocked_rts_smoother(ssm, ms, Ps, chunk)
