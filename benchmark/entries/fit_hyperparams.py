"""``nsgp_tpu_torch.inference.learn.fit_hyperparams`` on one signal, as
``experiments/train_hyperopt.py:run_file`` calls it: EP's ADF energy
(``ep_itts``), the reference's constrained groups (``SPECS``), Adam.

Traffic keys: ``file`` (which of the configuration's weights), ``T``,
``inputs`` (signals drawn at set-up and cycled), ``steps``,
``learning_rate``, ``ep_itts``, ``damping`` (the energy's, for the
reference: the program keeps its own default), ``w_lik_train``, ``specs``
(the program's ``SPECS``, for the reference).  Each call is a fresh fit from
the same start.  The optimiser is ``torch.optim.Adam`` through
``fit_hyperparams``'s ``optimizer`` argument, recording at each step the
unconstrained parameters before the update and the gradient after the
closure.  Compared at the call's last step: the energy and the gradient,
against the plain reference (``reference_train.py``) at the recorded
parameters, and the final parameters against Adam's updates recomputed in
float64 from the recorded gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts, counts_train, inputs, job
from benchmark import reference as R
from benchmark import reference_train as RT


class Recorded(torch.optim.Adam):
    """Adam that keeps, at each step, its parameters before the update (``u``)
    and their gradient after the closure (``g``), flattened, on the device."""

    def __init__(self, params, lr: float):
        super().__init__(params, lr=lr)
        self.u, self.g = [], []

    def flat(self, grad: bool = False) -> torch.Tensor:
        ps = self.param_groups[0]["params"]
        return torch.cat([(p.grad if grad else p).detach().reshape(-1) for p in ps])

    def step(self, closure):
        self.u.append(self.flat())

        def recorded():
            loss = closure()
            self.g.append(self.flat(grad=True))
            return loss

        return super().step(recorded)


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nsgp_tpu_torch.experiments import train_hyperopt, with_lik
        from nsgp_tpu_torch.inference.learn import GROUPS

        self.model = config["model"]
        self.w = job.as_float32(config["weights"][traffic["file"]])
        self.traffic = traffic
        self.device = device
        self.specs = {g: tuple(v) if isinstance(v, list) else v
                      for g, v in traffic["specs"].items()}
        if self.specs != train_hyperopt.SPECS:
            raise ValueError(f"the traffic's specs {self.specs} are not the program's "
                             f"{train_hyperopt.SPECS}")
        self.program_specs = train_hyperopt.SPECS
        self.groups = [g for g in GROUPS if self.specs[g] != "fixed"]
        T = traffic["T"]
        self.samples = T * traffic["steps"]
        self.n_inputs = traffic["inputs"]
        self.ys = [inputs.prior_signal(inputs.stream(seed, k), self.model, self.w, T)
                   .astype(np.float32) for k in range(self.n_inputs)]
        dtype = getattr(torch, config["dtype"])
        self.pm = job.program_model(self.model, self.model["D"], self.model["N"])
        params = job.program_params(self.w, device, dtype)
        self.init = train_hyperopt._clip_into(with_lik(params, traffic["w_lik_train"]))
        self.fixed = {k: np.asarray(v.detach().cpu(), np.float64)
                      for k, v in zip(job.LEAVES, self.init.leaves())}
        self.y_dev = [torch.as_tensor(y, device=device).to(dtype) for y in self.ys]
        self.kept = {}  # input -> what ``keep`` returned for its last call

    def call(self, i: int):
        from nsgp_tpu_torch.inference import learn

        t = self.traffic
        opts = []

        def adam(ps):
            opts.append(Recorded(ps, lr=t["learning_rate"]))
            return opts[-1]

        fit = learn.fit_hyperparams(self.pm, self.init, self.y_dev[i % self.n_inputs],
                                    engine="ep", specs=self.program_specs, steps=t["steps"],
                                    learning_rate=t["learning_rate"], optimizer=adam,
                                    device=self.device, ep_itts=t["ep_itts"])
        job.sync(self.device)
        return i, fit, opts[0]

    def keep(self, out) -> dict:
        """The last step's energy and gradient, the parameters before it, and
        the whole trajectory's start, gradients and end, still on the
        device."""
        i, fit, opt = out
        u = torch.stack(opt.u)
        kept = {"energy": fit.energies[-1], "grad": opt.g[-1], "u_last": u[-1],
                "u_first": u[0], "grads": torch.stack(opt.g), "u_final": opt.flat()}
        self.kept[i % self.n_inputs] = kept
        return kept

    def split(self, flat) -> dict:
        """A flat vector of the tuned groups -> {group: float64 numpy}."""
        shapes = {g: np.shape(self.fixed[g]) for g in self.groups}
        out, k = {}, 0
        for g in self.groups:
            n = int(np.prod(shapes[g]))
            out[g] = np.asarray(flat[k:k + n], np.float64).reshape(shapes[g])
            k += n
        return out

    def reference(self, i: int, ar=R.F64) -> dict:
        """The plain reference at the parameters the program recorded before
        its last step on input ``i`` (the start, where no call has run), and
        Adam's updates recomputed in float64 from the recorded gradients."""
        t = self.traffic
        rec = self.kept.get(i % self.n_inputs)
        if rec is None:
            u0 = np.concatenate([RT.to_unconstrained(self.fixed[g], *self.specs[g]).reshape(-1)
                                 for g in self.groups])
            rec = {"u_last": u0, "u_first": u0, "grads": np.zeros((0, u0.size))}
        rec = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float64)
               for k, v in rec.items() if k in ("u_last", "u_first", "grads")}
        y = self.ys[i % self.n_inputs].astype(np.float64)
        E, g = RT.energy_and_grad(self.split(rec["u_last"]), self.fixed, self.specs,
                                  self.model, y, t["damping"], ar)
        return {"energy": torch.tensor(E, dtype=torch.float64),
                "grad": torch.as_tensor(np.concatenate([g[k].reshape(-1) for k in self.groups])),
                "u_final": torch.as_tensor(RT.adam(rec["u_first"], rec["grads"],
                                                   t["learning_rate"]))}

    def compare(self, kept: dict, ref: dict, i: int) -> dict:
        """``energy``: the relative gap of the last step's energy; ``grad``:
        the widest over the tuned groups of max |g - g_ref| over max |g_ref|
        in the group; ``update``: max |u_final - u_ref| over the learning
        rate (one Adam step moves a parameter by about that)."""
        E, E_ref = float(kept["energy"]), float(ref["energy"])
        g, g_ref = self.split(kept["grad"].double()), self.split(ref["grad"].double())
        grad = max(float(np.abs(g[k] - g_ref[k]).max() / np.abs(g_ref[k]).max())
                   for k in self.groups)
        gap = (kept["u_final"].double().cpu() - ref["u_final"].double().cpu()).abs().max()
        nan = lambda x: x if np.isfinite(x) else float("inf")
        return {"energy": nan(abs(E - E_ref) / abs(E_ref)), "grad": nan(grad),
                "update": nan(float(gap) / self.traffic["learning_rate"])}

    def work(self) -> dict:
        """A step is K3 (the energy's sweep) and K7 (its adjoint), each once."""
        m, t = self.model, self.traffic
        T, steps = t["T"], t["steps"]
        D, N, S, bs = m["D"], m["N"], m["sigma_points"], m["block_size"]
        k3 = counts.adf(T, 1, D, N, S, bs, T)
        k7 = counts_train.adf_vjp(T, D, N, S, bs, T, T)
        return {"K3": (*k3, steps), "K7": (*k7, steps), "flops": steps * (k3[1] + k7[1])}
