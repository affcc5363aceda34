"""``nsgp_tpu_torch.apps.source_sep.separate``, engine "ep", fused backend.

The configuration names the sources (each a trained model) and the mixture
noise; the traffic keys are ``inputs`` (mixtures drawn at set-up and
cycled), ``ep_itts``, ``ep_fraction``, ``damping``, ``s_chunk``,
``moment_chunk`` and optionally ``T`` (default: the configuration's
``signal_length``).  Each mixture is the sum of one prior draw of each
source.  Compared: the joint model's Eft, Varft and nlZ and the per-source
signals of the plug-in read-out.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, job
from benchmark import reference as R


def joint_weights(ws: list, lik: float) -> dict:
    """The sources stacked block-diagonally, subbands then modulators."""
    cat = lambda k: np.concatenate([w[k] for w in ws])
    D, N = sum(len(w["sub_var"]) for w in ws), sum(len(w["mod_var"]) for w in ws)
    W = np.zeros((D, N))
    d = n = 0
    for w in ws:
        dd, nn = np.shape(w["W"])
        W[d:d + dd, n:n + nn] = w["W"]
        d, n = d + dd, n + nn
    return {"lik": np.float64(lik), "sub_var": cat("sub_var"), "sub_len": cat("sub_len"),
            "omega": cat("omega"), "mod_var": cat("mod_var"), "mod_len": cat("mod_len"),
            "W": W}


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.model = config["model"]
        self.ws = [job.as_float32(config["weights"][s]) for s in config["sources"]]
        self.lik = float(np.float32(config["mixture_lik"]))
        self.wj = joint_weights(self.ws, self.lik)
        self.traffic = traffic
        self.device = device
        T = traffic.get("T", config.get("signal_length"))
        self.T = self.samples = T
        self.n_inputs = traffic["inputs"]
        self.ys = [sum(inputs.prior_signal(inputs.stream(seed, k, j), self.model, w, T)
                       for j, w in enumerate(self.ws)).astype(np.float32)
                   for k in range(self.n_inputs)]
        dtype = getattr(torch, config["dtype"])
        self.pms = [job.program_model(self.model, len(w["sub_var"]), len(w["mod_var"]))
                    for w in self.ws]
        self.params = [job.program_params(w, device, dtype) for w in self.ws]
        self.y_dev = [torch.as_tensor(y, device=device).to(dtype) for y in self.ys]
        self.kw = dict(backend="fused", ep_itts=traffic["ep_itts"],
                       ep_fraction=traffic["ep_fraction"], damping=tuple(traffic["damping"]),
                       s_chunk=traffic["s_chunk"], moment_chunk=traffic["moment_chunk"])

    def call(self, i: int):
        from nsgp_tpu_torch.apps.source_sep import separate

        out = separate(self.pms, self.params, self.y_dev[i % self.n_inputs], engine="ep",
                       n_samples=0, mixture_lik=self.lik, device=self.device, **self.kw)
        job.sync(self.device)
        return out

    def keep(self, out) -> dict:
        """The outputs compared, still on the device (no copy in the window)."""
        r = out.result
        return {"sources": out.sources, "Eft": r.Eft,
                "Varft": r.Varft, "nlZ": r.nlZ}

    def reference(self, i: int, ar=R.F64) -> dict:
        """The plain reference's outputs on input ``i``, as ``keep`` gives them."""
        t, m = self.traffic, self.model
        y = self.ys[i % self.n_inputs].astype(np.float64)
        Eft, Varft, nlZ = R.ep([self.wj], m, y[None], np.ones((1, y.shape[0]), bool),
                               ep_itts=t["ep_itts"], ep_fraction=t["ep_fraction"],
                               damping=t["damping"], ar=ar, device=self.device,
                               sweep=job.sweep_lib(m))
        contrib = R.plug_in([self.wj], m, Eft)[0]  # (T, D)
        bounds = np.cumsum([0] + [len(w["sub_var"]) for w in self.ws])
        sources = torch.stack([contrib[:, lo:hi].sum(-1)
                               for lo, hi in zip(bounds[:-1], bounds[1:])], -1)
        return {"sources": sources, "Eft": Eft[0], "Varft": Varft[0], "nlZ": nlZ[0]}

    def compare(self, kept: dict, ref: dict, i: int) -> dict:
        var = job.prior_var([self.wj], self.model)[0]
        scale = float(np.std(self.ys[i % self.n_inputs]))
        return {"eft": job.widest(kept["Eft"], ref["Eft"], var.sqrt()),
                "varft": job.widest(kept["Varft"], ref["Varft"], var),
                "nlz": job.nlz_gap(kept["nlZ"], ref["nlZ"]),
                "sources": job.widest(kept["sources"], ref["sources"], scale)}

    def work(self) -> dict:
        m, T = self.model, self.T
        C = m["D"] + m["N"]
        return job.ep_counts(T, 1, m["D"], m["N"], m["sigma_points"], m["block_size"], T,
                             self.traffic["ep_itts"], "K4", T, C)
