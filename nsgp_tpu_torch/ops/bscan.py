"""Blocked (two-level) parallel Kalman filtering / smoothing.

Port of ``nsgp_tpu/ops/bscan.py``:

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

Split over a mesh axis (``axis``, the counterpart of JAX's ``time_axis``):
each rank holds the rows of its contiguous run of chunks
(``axis.split(nc)``) and runs passes 1 and 3 on them alone; pass 2 gathers
the nc chunk totals (one collective a pass, nc x C elements) and every rank
composes all of them and keeps its own prefixes.  Both passes pad the last
chunk at the end, so that the filter's and the smoother's chunks hold the
same rows: the smoother's element of the global last step has E = 0, which
cancels whatever padding follows it.
"""

from __future__ import annotations

import torch

from nsgp_tpu_torch.ops.kalman import Sites
from nsgp_tpu_torch.ops.pscan import (_filter_combine, _make_filter_elem, _mv,
                                      _smoother_combine, _sym)
from nsgp_tpu_torch.ops.ssm import BlockSSM
from nsgp_tpu_torch.parallel.collectives import gather


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


def _chunks(n: int, L: int, axis, T):
    """(first chunk, chunks here, chunks in all) of this rank's ``n`` rows:
    all ``-(-n // L)`` chunks without ``axis``, else its run of a ``T``-step
    signal's."""
    if axis is None:
        nc = -(-n // L)
        return 0, nc, nc
    nc = -(-T // L)
    k0, k1 = axis.split(nc)
    return k0, k1 - k0, nc


def _all_totals(totals, axis, k0: int, nc: int):
    """Every chunk's total on every rank, from each rank's run starting at
    chunk ``k0``: one gather of the parts packed side by side."""
    if axis is None:
        return totals
    n = totals[0].shape[0]
    full = gather(torch.cat([x.reshape(n, -1) for x in totals], 1), axis, 0, k0, nc,
                  kind="chunk_totals")
    out, o = [], 0
    for x in totals:
        w = x[0].numel()
        out.append(full[:, o:o + w].reshape((nc,) + x.shape[1:]))
        o += w
    return tuple(out)


def blocked_filter_with_sites(ssm: BlockSSM, sites: Sites, chunk: int = 512, axis=None,
                              T=None):
    """Parallel-in-time forward filter with fixed sites; O(2L + T/L) depth.
    Returns flattened filtered moments (ms (T, C*bs), Ps (T, C*bs*bs)).
    With ``axis``, ``sites`` hold this rank's rows of a ``T``-step signal and
    so do the results (module docstring)."""
    C, bs = ssm.H.shape
    L = int(chunk)
    n = sites.ttau.shape[0]
    k0, ncl, nc = _chunks(n, L, axis, T)
    pad = ncl * L - n  # zero-padded sites at the end: inert steps, trimmed
    tt = torch.nn.functional.pad(sites.ttau, (0, 0, 0, pad)).reshape(ncl, L, C)
    tn = torch.nn.functional.pad(sites.tnu, (0, 0, 0, pad)).reshape(ncl, L, C)
    first_chunk = (torch.arange(k0, k0 + ncl, device=tt.device) == 0)[:, None, None, None]
    never = torch.zeros_like(first_chunk)
    elem = lambda i: _make_filter_elem(ssm, tt[:, i], tn[:, i], first_chunk if i == 0 else never)

    totals = _identity(ncl, C, bs, ssm.A, "MvMvM")
    for i in range(L):
        totals = _filter_combine(totals, elem(i))
    totals = _all_totals(totals, axis, k0, nc)
    carry = _exclusive_scan(_filter_combine, totals, _identity(1, C, bs, ssm.A, "MvMvM"))
    carry = tuple(x[k0:k0 + ncl] for x in carry)
    ms, Ps = [], []
    for i in range(L):
        carry = _filter_combine(carry, elem(i))
        ms.append(carry[1].reshape(ncl, -1))
        Ps.append(carry[2].reshape(ncl, -1))
    # (L, nc, K) -> (nc, L, K) -> (nc*L, K) -> trim the padding
    ms = torch.stack(ms, dim=1).reshape(ncl * L, -1)[:n]
    Ps = torch.stack(Ps, dim=1).reshape(ncl * L, -1)[:n]
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


def blocked_rts_smoother(ssm: BlockSSM, ms, Ps, chunk: int = 512, axis=None, T=None):
    """Parallel-in-time RTS smoother over flattened filtered moments.
    Returns flattened smoothed (ms (T, C*bs), Ps (T, C*bs*bs)); with
    ``axis``, this rank's rows of a ``T``-step signal in and out."""
    C, bs = ssm.H.shape
    L = int(chunk)
    n = ms.shape[0]
    k0, ncl, nc = _chunks(n, L, axis, T)
    T = n if axis is None else T
    # The padded rows go at the end of the last chunk, after the global last
    # step, whose element (E = 0) cancels them; they carry Pinf (any PSD
    # value works) and are trimmed after.
    pad = ncl * L - n
    ms = torch.cat([ms, ms.new_zeros((pad, ms.shape[1]))])
    Ps = torch.cat([Ps, ssm.Pinf.reshape(1, -1).expand(pad, -1)])
    last_step = (T - 1) % L
    msc = ms.reshape(ncl, L, -1)
    Psc = Ps.reshape(ncl, L, -1)
    last_chunk = (torch.arange(k0, k0 + ncl, device=ms.device) == nc - 1)[:, None, None, None]
    never = torch.zeros_like(last_chunk)
    elem = lambda i: _make_smoother_elem(ssm, msc[:, i], Psc[:, i],
                                         last_chunk if i == last_step else never)

    # reverse walks: i = L-1 .. 0 (suffix compositions)
    totals = _identity(ncl, C, bs, ssm.A, "MvM")
    for i in range(L - 1, -1, -1):
        totals = _smoother_combine(totals, elem(i))
    totals = _all_totals(totals, axis, k0, nc)
    carry = _exclusive_scan(_smoother_combine, totals, _identity(1, C, bs, ssm.A, "MvM"),
                            reverse=True)
    carry = tuple(x[k0:k0 + ncl] for x in carry)
    sm, sP = [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        carry = _smoother_combine(carry, elem(i))
        sm[i] = carry[1].reshape(ncl, -1)
        sP[i] = carry[2].reshape(ncl, -1)
    sm = torch.stack(sm, dim=1).reshape(ncl * L, -1)[:n]
    sP = torch.stack(sP, dim=1).reshape(ncl * L, -1)[:n]
    return sm, sP


def blocked_filter_smoother(ssm: BlockSSM, sites: Sites, chunk: int = 512,
                            jitter: float = 0.0, axis=None, T=None):
    """One full linear-Gaussian forward/backward pass, blocked-parallel
    (split over ``axis`` as the two passes are)."""
    del jitter  # pad_eye regularises the smoother-gain solves
    ms, Ps = blocked_filter_with_sites(ssm, sites, chunk, axis, T)
    return blocked_rts_smoother(ssm, ms, Ps, chunk, axis, T)
