"""``nsgp_tpu_torch.inference.ihgp.ihgp_infer`` on one signal with gaps.

Traffic keys: ``file`` (which of the configuration's weights), ``T``,
``inputs`` (signals drawn at set-up and cycled), ``gap_lengths`` (cycled),
``n_gaps``, ``gap_starts`` (the first and last gap's start as shares of T,
the rest evenly between), ``ep_itts``, ``ep_fraction``, ``damping``,
``parallel``, ``keep_best``; the grid is the configuration's ``ihgp``
block.  Every sample of a gap is NaN in the signal the program is given.
Compared: the smoothed marginals Eft and Varft, the per-sweep energies nlZ,
and the steady-state tables that ``build_tables`` gives on the cell's
parameters, computed once at set-up by the function the timed path calls.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts, counts_ihgp, inputs, job
from benchmark import reference as R
from benchmark import reference_ihgp as RI


def gap_mask(traffic: dict) -> np.ndarray:
    """(T,) bool, False inside the gaps."""
    T, n = traffic["T"], traffic["n_gaps"]
    lengths = traffic["gap_lengths"]
    obs = np.ones(T, bool)
    for i, start in enumerate((np.linspace(*traffic["gap_starts"], n) * T).astype(int)):
        obs[start:start + lengths[i % len(lengths)]] = False
    return obs


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nsgp_tpu_torch.inference import ihgp

        self.model = config["model"]
        g = config["ihgp"]
        self.grid = RI.Grid(g["grid_lo"], g["grid_hi"], g["grid_coarse"], g["grid_fine"])
        self.w = job.as_float32(config["weights"][traffic["file"]])
        self.traffic = traffic
        self.device = device
        self.samples = traffic["T"]
        self.n_inputs = traffic["inputs"]
        self.obs = gap_mask(traffic)
        self.ys = [inputs.prior_signal(inputs.stream(seed, k), self.model, self.w, traffic["T"])
                   .astype(np.float32) for k in range(self.n_inputs)]
        dtype = getattr(torch, config["dtype"])
        self.pm = job.program_model(self.model, self.model["D"], self.model["N"])
        self.params = job.program_params(self.w, device, dtype)
        self.y_dev = [torch.as_tensor(np.where(self.obs, y, np.nan), device=device).to(dtype)
                      for y in self.ys]
        self.cfg = ihgp.IHGPConfig(
            ep_itts=traffic["ep_itts"], ep_fraction=traffic["ep_fraction"],
            damping=tuple(traffic["damping"]), grid_lo=g["grid_lo"], grid_hi=g["grid_hi"],
            grid_coarse=g["grid_coarse"], grid_fine=g["grid_fine"], pf_correct=g["pf_correct"],
            parallel=traffic["parallel"], keep_best=traffic["keep_best"])
        tables = ihgp.build_tables(self.pm.build_ssm(self.params), self.cfg)
        job.sync(device)
        self.tables = {f: getattr(tables, f) for f in RI.TABLE_FIELDS}

    def call(self, i: int):
        from nsgp_tpu_torch.inference.ihgp import ihgp_infer

        out = ihgp_infer(self.pm, self.params, self.y_dev[i % self.n_inputs], None, self.cfg,
                         device=self.device)
        job.sync(self.device)
        return out

    def keep(self, out) -> dict:
        """The outputs compared, still on the device (no copy in the window),
        and the set-up's tables."""
        return dict({k: getattr(out, k) for k in ("Eft", "Varft", "nlZ")}, **self.tables)

    def reference(self, i: int, ar=R.F64) -> dict:
        """The plain reference's outputs on input ``i``, as ``keep`` gives them."""
        t = self.traffic
        Eft, Varft, nlZ, _, bk = RI.ihgp(self.w, self.model, self.ys[i % self.n_inputs],
                                          self.obs, ep_itts=t["ep_itts"],
                                          ep_fraction=t["ep_fraction"], damping=t["damping"],
                                          grid=self.grid, ar=ar, device=self.device)
        return dict(Eft=Eft, Varft=Varft, nlZ=nlZ,
                    **{f: torch.as_tensor(getattr(bk, f)) for f in RI.TABLE_FIELDS})

    def compare(self, kept: dict, ref: dict, i: int) -> dict:
        var = job.prior_var([self.w], self.model)[0]
        return {"eft": job.widest(kept["Eft"], ref["Eft"], var.sqrt()),
                "varft": job.widest(kept["Varft"], ref["Varft"], var),
                "nlz": job.nlz_gap(kept["nlZ"], ref["nlZ"]),
                "tables": max(job.widest(kept[f], ref[f], ref[f].abs().max())
                              for f in RI.TABLE_FIELDS)}

    def work(self) -> dict:
        """K5 a sweep (sweep 1 matches every observed step, each later sweep
        the last), K6 a sweep, a re-site between sweeps, the bank once."""
        m, t = self.model, self.traffic
        T, itts = t["T"], t["ep_itts"]
        D, N, S, bs = m["D"], m["N"], m["sigma_points"], m["block_size"]
        C, G = D + N, self.grid.fine
        observed = int(self.obs.sum())
        k5 = [counts_ihgp.ihgp_adf(T, D, N, S, bs, G, observed)] \
            + [counts_ihgp.ihgp_adf(T, D, N, S, bs, G, int(self.obs[-1]))] * (itts - 1)
        k6 = counts_ihgp.ihgp_smooth(T, C, bs, C * G)
        flops = sum(f for _, f in k5) + itts * k6[1] \
            + (itts - 1) * counts.resite_flops(D, N, S, int(self.obs[:-1].sum())) \
            + counts_ihgp.bank_flops(C, self.grid.coarse, bs)
        return {"K5": k5, "K6": (*k6, itts), "flops": flops}
