"""``nsgp_tpu_torch.inference.ep.ep_infer`` on one signal, fused backend.

Traffic keys: ``file`` (which of the configuration's weights), ``T``,
``inputs`` (signals drawn at set-up and cycled), ``ep_itts``,
``ep_fraction``, ``damping``.  Compared: the smoothed marginals Eft, Varft
and the per-sweep energies nlZ.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, job
from benchmark import reference as R


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nsgp_tpu_torch.inference.ep import EPConfig

        self.model = config["model"]
        self.w = job.as_float32(config["weights"][traffic["file"]])
        self.traffic = traffic
        self.device = device
        T = traffic["T"]
        self.samples = T
        self.n_inputs = traffic["inputs"]
        self.ys = [inputs.prior_signal(inputs.stream(seed, k), self.model, self.w, T)
                   .astype(np.float32) for k in range(self.n_inputs)]
        dtype = getattr(torch, config["dtype"])
        self.pm = job.program_model(self.model, self.model["D"], self.model["N"])
        self.params = job.program_params(self.w, device, dtype)
        self.y_dev = [torch.as_tensor(y, device=device).to(dtype) for y in self.ys]
        self.cfg = EPConfig(backend="fused", ep_itts=traffic["ep_itts"],
                            ep_fraction=traffic["ep_fraction"],
                            damping=tuple(traffic["damping"]))

    def call(self, i: int):
        from nsgp_tpu_torch.inference.ep import ep_infer

        out = ep_infer(self.pm, self.params, self.y_dev[i % self.n_inputs], None, self.cfg,
                       device=self.device)
        job.sync(self.device)
        return out

    def keep(self, out) -> dict:
        """The outputs compared, still on the device (no copy in the window)."""
        return {k: getattr(out, k) for k in ("Eft", "Varft", "nlZ")}

    def reference(self, i: int, ar=R.F64) -> dict:
        """The plain reference's outputs on input ``i``, as ``keep`` gives them."""
        t, m = self.traffic, self.model
        y = self.ys[i % self.n_inputs].astype(np.float64)
        Eft, Varft, nlZ = R.ep([self.w], m, y[None], np.ones((1, y.shape[0]), bool),
                               ep_itts=t["ep_itts"], ep_fraction=t["ep_fraction"],
                               damping=t["damping"], ar=ar, device=self.device,
                               sweep=job.sweep_lib(m))
        return {"Eft": Eft[0], "Varft": Varft[0], "nlZ": nlZ[0]}

    def compare(self, kept: dict, ref: dict, i: int) -> dict:
        var = job.prior_var([self.w], self.model)[0]
        return {"eft": job.widest(kept["Eft"], ref["Eft"], var.sqrt()),
                "varft": job.widest(kept["Varft"], ref["Varft"], var),
                "nlz": job.nlz_gap(kept["nlZ"], ref["nlZ"])}

    def work(self) -> dict:
        m, T = self.model, self.traffic["T"]
        C = m["D"] + m["N"]
        return job.ep_counts(T, 1, m["D"], m["N"], m["sigma_points"], m["block_size"], T,
                             self.traffic["ep_itts"], "K3", T, C)
