"""``nsgp_tpu_torch.apps.missing_data.fill_gaps_batch``, engine "ep", fused.

Traffic keys: ``files`` (of the configuration's weights), their
``lengths``, the common ``pad_T``, ``gap_half`` and the 1-based
``gap_centres`` of each file, ``inputs`` (batches drawn at set-up and
cycled), ``ep_itts``, ``ep_fraction``, ``damping``.  Each file is a prior
draw of its own model at its own length, zero-padded; the padding is
unobserved and not scored.  A call completes the files' own samples.
Compared: Eft and Varft over each file's own samples (widest gap, and the
median over files of each file's widest Eft gap), nlZ of every file, the
plug-in read-out y_hat over each file's own samples, and each file's SNR
inside its gaps.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, job
from benchmark import reference as R


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.model = config["model"]
        self.files = traffic["files"]
        self.ws = [job.as_float32(config["weights"][f]) for f in self.files]
        self.traffic = traffic
        self.device = device
        BF, T = len(self.files), traffic["pad_T"]
        self.lengths = traffic["lengths"]
        self.samples = int(sum(self.lengths))
        self.n_inputs = traffic["inputs"]
        own = np.zeros((BF, T), bool)
        gaps = np.zeros((BF, T), bool)
        h = traffic["gap_half"]
        for b, (f, n) in enumerate(zip(self.files, self.lengths)):
            own[b, :n] = True
            for p in traffic["gap_centres"][f]:
                gaps[b, p - 1 - h: p + h] = True
        self.own, self.gaps, self.mask = own, gaps, own & ~gaps
        self.ys = []
        for k in range(self.n_inputs):
            y = np.zeros((BF, T), np.float32)
            for b, (w, n) in enumerate(zip(self.ws, self.lengths)):
                y[b, :n] = inputs.prior_signal(inputs.stream(seed, k, b), self.model, w, n)
            self.ys.append(y)
        dtype = getattr(torch, config["dtype"])
        self.pm = job.program_model(self.model, self.model["D"], self.model["N"])
        self.params = job.program_params(self.ws, device, dtype)
        self.y_dev = [torch.as_tensor(y, device=device).to(dtype) for y in self.ys]
        self.mask_dev = torch.as_tensor(self.mask, device=device)
        self.gaps_dev = torch.as_tensor(self.gaps, device=device)
        self.kw = dict(backend="fused", ep_itts=traffic["ep_itts"],
                       ep_fraction=traffic["ep_fraction"], damping=tuple(traffic["damping"]))

    def call(self, i: int):
        from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch

        out = fill_gaps_batch(self.pm, self.params, self.y_dev[i % self.n_inputs],
                              self.mask_dev, engine="ep", n_samples=0,
                              metric_gapsB=self.gaps_dev, device=self.device, **self.kw)
        job.sync(self.device)
        return out

    def keep(self, out) -> dict:
        """The outputs compared, still on the device (no copy in the window)."""
        r = out.result
        return {"y_hat": out.y_hat, "snr": out.snr_gaps,
                "Eft": r.Eft, "Varft": r.Varft,
                "nlZ": r.nlZ}

    def reference(self, i: int, ar=R.F64) -> dict:
        """The plain reference's outputs on input ``i``, as ``keep`` gives them."""
        t, m = self.traffic, self.model
        y = self.ys[i % self.n_inputs].astype(np.float64)
        Eft, Varft, nlZ = R.ep(self.ws, m, y, self.mask, ep_itts=t["ep_itts"],
                               ep_fraction=t["ep_fraction"], damping=t["damping"], ar=ar,
                               device=self.device, sweep=job.sweep_lib(m))
        y_hat = R.plug_in(self.ws, m, Eft).sum(-1).cpu()  # (BF, T)
        yt, g = torch.as_tensor(y), torch.as_tensor(self.gaps)
        snr = 10.0 * torch.log10((torch.where(g, yt, 0.0) ** 2).sum(-1)
                                 / (torch.where(g, yt - y_hat, 0.0) ** 2).sum(-1))
        return {"y_hat": y_hat, "snr": snr, "Eft": Eft, "Varft": Varft, "nlZ": nlZ}

    def compare(self, kept: dict, ref: dict, i: int) -> dict:
        var = job.prior_var(self.ws, self.model)[:, None, :]  # (BF, 1, C)
        own = torch.as_tensor(self.own)
        y = self.ys[i % self.n_inputs].astype(np.float64)
        scale = torch.as_tensor(y.std(1, where=self.own))[:, None]
        eft_files = [job.widest(kept["Eft"][b], ref["Eft"][b], var[b].sqrt(), own[b, :, None])
                     for b in range(len(self.files))]
        return {"eft": max(eft_files),
                "eft_median_file": float(np.median(eft_files)),
                "varft": job.widest(kept["Varft"], ref["Varft"], var, own[..., None]),
                "nlz": job.nlz_gap(kept["nlZ"], ref["nlZ"]),
                "y_hat": job.widest(kept["y_hat"], ref["y_hat"], scale, own),
                "snr_db": float((kept["snr"].double() - ref["snr"].double().cpu()).abs().max())}

    def work(self) -> dict:
        m, T, BF = self.model, self.traffic["pad_T"], len(self.files)
        C = m["D"] + m["N"]
        return job.ep_counts(T, BF, m["D"], m["N"], m["sigma_points"], m["block_size"],
                             int(self.mask.sum()), self.traffic["ep_itts"], "K4", T, BF * C)
