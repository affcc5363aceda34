"""Port parity: the device mesh (``nsgp_tpu_torch/parallel/mesh.py``) and EP
sharded by channel and by time, float64 on the CPU in gloo worlds.

The cases of ``tests/test_mesh.py`` on its toy model (D=6, N=2, so C=8;
p_cubature=7):

- channel-sharded EP (``backend="seq"``, T=300, 3 sweeps) at 2 and 4 ranks
  and at 3 (an uneven split of the 8 channels: 3, 3, 2);
- time-sharded blocked EP at 4 ranks and at 3 (T=2000, chunk 256: 8 chunks
  split 2 a rank and 3, 3, 2, the last one of 208 rows, so the split
  smoother's end padding is reached);
- the 2-D mesh time 2 x channel 2 on the same signal and config;
- the data-parallel step at 4 ranks against 1 (B=4, T=128, 2 sweeps,
  ``SGD(1e-2)``), and against JAX's one-device step with ``optax.sgd(1e-2)``;
- positivity after an ``SGD(0.5)`` step at 2 ranks;
- ``ep_energy`` under ``channel_axis`` (through ``batched_ep_energy``): value
  and gradient over the unconstrained leaves, at 4 ranks.

Each sharded result is held against the port's unsharded call at 1e-10
relative (summation order only) and against JAX's unsharded function at
1e-8; ``tests/test_mesh.py`` holds JAX's sharded functions equal to its
unsharded ones, so they are not run here.  Every rank of a mesh must return
the same result.  Two worlds (4 and 3 ranks) are spawned once for the module,
with a file rendezvous under the test's temporary directory and one intra-op
thread a rank; they run while this process computes the references.  JAX
runs ``unroll=1`` (compile time only).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_worker as worker
from torch_threads import one_torch_thread  # noqa: F401
from nsgp_tpu.inference import ep as jep
from nsgp_tpu.inference import learn as jlearn
from nsgp_tpu.models.gtnmf import GTNMFModel as JModel
from nsgp_tpu.models.gtnmf import GTNMFParams as JParams
from nsgp_tpu.parallel import mesh as jmesh
from nsgp_tpu_torch.inference import ep as tep
from nsgp_tpu_torch.inference.learn import GROUPS
from nsgp_tpu_torch.models.gtnmf import sample_prior
from nsgp_tpu_torch.parallel import collectives
from nsgp_tpu_torch.parallel import mesh as pmesh

D, N = 6, 2
TOL_PORT, TOL_JAX = 1e-10, 1e-8
PARAMS = dict(lik=np.float64(0.05), sub_var=np.linspace(0.5, 1.5, D),
              sub_len=np.linspace(30.0, 90.0, D), omega=np.linspace(0.2, 1.6, D),
              mod_var=np.full(N, 1.5), mod_len=np.linspace(250.0, 450.0, N),
              W=np.random.default_rng(0).uniform(0.2, 1.0, (D, N)))
CONFIGS = {  # name: (T, seed, EPConfig fields)
    "channel": (300, 3, dict(ep_itts=3)),
    "time": (2000, 5, dict(ep_itts=3, parallel=True, chunk=256)),
}
TRAIN = dict(B=4, T=128, seed=10, config=dict(ep_itts=2))
POSITIVE = dict(B=2, T=96, seed=20, config=dict(ep_itts=1))


def _signal(T, seed):
    model, params = worker.toy(PARAMS)
    return sample_prior(torch.Generator().manual_seed(seed), model, params, T)[0].numpy()


def _batch(B, T, seed):
    ys = np.stack([_signal(T, seed + b) for b in range(B)])
    return ys, np.ones_like(ys, dtype=bool)


def _cases():
    sig = {k: _signal(T, seed) for k, (T, seed, _) in CONFIGS.items()}
    case = lambda kind, name, mesh, **kw: dict(kind=kind, mesh=mesh, params=PARAMS,
                                               y=sig[name], config=CONFIGS[name][2], **kw)
    ys, masks = _batch(TRAIN["B"], TRAIN["T"], TRAIN["seed"])
    train = dict(params=PARAMS, ys=ys, masks=masks, config=TRAIN["config"])
    ys2, masks2 = _batch(POSITIVE["B"], POSITIVE["T"], POSITIVE["seed"])
    four = {
        "channel4": case("channel", "channel", {"channel": 4}),
        "time4": case("time", "time", {"time": 4}, chunk=256),
        "2d": case("2d", "time", {"time": 2, "channel": 2}),
        "train4": dict(train, kind="train", mesh={"data": 4}, lr=1e-2),
        "energy4": dict(train, kind="energy", mesh={"channel": 4}),
    }
    three = {
        "channel2": case("channel", "channel", {"channel": 2}),
        "channel3": case("channel", "channel", {"channel": 3}),
        "time3": case("time", "time", {"time": 3}, chunk=256),
        "train1": dict(train, kind="train", mesh={"data": 1}, lr=1e-2),
        "positive": dict(kind="train", mesh={"data": 2}, params=PARAMS, ys=ys2, masks=masks2,
                         config=POSITIVE["config"], lr=0.5),
        "slices": dict(kind="slices", mesh={"data": 3}, params=PARAMS, n=10),
    }
    return sig, four, three


def _jax_refs(sig):
    jm = JModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=7)
    jp = JParams(**{k: jnp.asarray(v) for k, v in PARAMS.items()})
    out = {name: jep.ep_infer(jm, jp, jnp.asarray(sig[name]), None,
                              jep.EPConfig(unroll=1, **CONFIGS[name][2]))
           for name in CONFIGS}
    ys, masks = _batch(TRAIN["B"], TRAIN["T"], TRAIN["seed"])
    tf = jlearn.Transform({})
    u = tf.to_unconstrained(jp)
    cfg = jep.EPConfig(unroll=1, **TRAIN["config"])
    loss, g = jax.jit(jax.value_and_grad(lambda uu: jmesh.batched_ep_energy(
        jm, tf.to_params(uu, jp), jnp.asarray(ys), jnp.asarray(masks), cfg)))(u)
    opt = optax.sgd(1e-2)
    updates, _ = opt.update(g, opt.init(u), u)
    p2 = tf.to_params(optax.apply_updates(u, updates), jp)
    out["energy"] = (float(loss), np.concatenate([np.asarray(g[k]).ravel() for k in GROUPS]))
    out["train"] = ({k: np.asarray(getattr(p2, k)) for k in GROUPS}, float(loss))
    return out


def _port_refs(sig):
    model, params = worker.toy(PARAMS)
    out = {name: worker.result_arrays(tep.ep_infer(
        model, params, torch.tensor(sig[name]), None, tep.EPConfig(**CONFIGS[name][2]),
        device="cpu")) for name in CONFIGS}
    ys, masks = _batch(TRAIN["B"], TRAIN["T"], TRAIN["seed"])
    out["energy"] = worker.energy_and_grad(model, params, ys, masks,
                                           tep.EPConfig(**TRAIN["config"]))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_worlds"))
    sig, four, three = _cases()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        spawned = [pool.submit(pmesh.spawn_world, worker.run_cases, n, "gloo", (cases,), root)
                   for n, cases in ((4, four), (3, three))]
        port = pool.submit(_port_refs, sig)
        refs = dict(jax=_jax_refs(sig), port=port.result())
        ranks4, ranks3 = (f.result() for f in spawned)
    return dict(refs, ranks4=ranks4, ranks3=ranks3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _results(worlds, name):
    """The case's results from the ranks of its mesh, which must agree (all
    but the collectives' bytes: time ranks may hold different row counts)."""
    ranks = worlds["ranks4"] if name in worlds["ranks4"][0] else worlds["ranks3"]
    got = [r[name] for r in ranks if r[name] is not None]
    for other in got[1:]:
        for k, v in got[0].items():
            if k == "collectives":
                continue
            for key, a, b in (((k, g), other[k][g], v[g]) for g in v) if isinstance(v, dict) \
                    else [(k, other[k], v)]:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}: ranks differ on {key}")
    return got


def _check_ep(res, port, jax_res):
    for f in worker.FIELDS:
        a, b, c = res[f], port[f], np.asarray(getattr(jax_res, f))
        if f == "maxdiff":  # entry 0 is inf: no previous sweep
            a, b, c = a[1:], b[1:], c[1:]
        assert a.shape == c.shape, f
        assert _rel(a, b) <= TOL_PORT, (f, _rel(a, b))
        assert _rel(a, c) <= TOL_JAX, (f, _rel(a, c))
    for k, jx in (("ttau", jax_res.sites.ttau), ("tnu", jax_res.sites.tnu)):
        assert _rel(res[k], port[k]) <= TOL_PORT and _rel(res[k], np.asarray(jx)) <= TOL_JAX, k


@pytest.mark.parametrize("n", [2, 3, 4])
def test_channel_sharded_ep_matches_unsharded(worlds, n):
    got = _results(worlds, f"channel{n}")
    assert len(got) == n
    _check_ep(got[0], worlds["port"]["channel"], worlds["jax"]["channel"])
    # the marginals gathered at each of 3 sweeps, ms and Ps once at return
    assert got[0]["collectives"] == {"gather": {"count": 5, "bytes": got[0]["collectives"]
                                                ["gather"]["bytes"]}}


@pytest.mark.parametrize("n", [3, 4])
def test_time_sharded_ep_matches_unsharded(worlds, n):
    got = _results(worlds, f"time{n}")
    assert len(got) == n
    _check_ep(got[0], worlds["port"]["time"], worlds["jax"]["time"])
    stats = got[0]["collectives"]
    # two later sweeps: pass 2 of the filter and of the smoother (each one
    # gather of the 8 chunk totals) and maxdiff; two re-sites (nlZ); the
    # result gathered once (7 arrays)
    C, bs = D + N, 4
    assert stats["chunk_totals"] == {"count": 2 * 2, "bytes": 2 * 8 * C * (
        (3 * bs * bs + 2 * bs) + (2 * bs * bs + bs)) * 8}
    assert stats["gather"]["count"] == 7
    assert stats["all_reduce_max"]["count"] == 2 and stats["all_reduce_sum"]["count"] == 2


def test_time_and_channel_mesh_ep(worlds):
    got = _results(worlds, "2d")
    assert len(got) == 4
    _check_ep(got[0], worlds["port"]["time"], worlds["jax"]["time"])


def test_dp_train_step_matches_single_device(worlds):
    """One data-parallel step == the same step on one rank == JAX's step."""
    r4, r1 = _results(worlds, "train4"), _results(worlds, "train1")
    assert len(r4) == 4 and len(r1) == 1
    (p4, loss4), (p1, loss1) = ((r[0]["params"], r[0]["loss"]) for r in (r4, r1))
    pj, lossj = worlds["jax"]["train"]
    assert abs(loss4 - loss1) <= 1e-10 * abs(loss1) and abs(loss4 - lossj) <= 1e-9 * abs(lossj)
    for g in GROUPS:
        assert _rel(p4[g], p1[g]) <= 1e-10, g
        assert _rel(p4[g], pj[g]) <= 1e-9, g
    stats = r4[0]["collectives"]
    assert stats["all_reduce_sum"]["count"] == 1  # the loss and every gradient leaf, packed


def test_train_step_keeps_params_positive(worlds):
    """A large step in the unconstrained space keeps every variance,
    lengthscale and weight positive (tests/test_mesh.py's regression)."""
    got = _results(worlds, "positive")
    assert len(got) == 2
    for g in GROUPS:
        assert np.all(got[0]["params"][g] > 0), g
    assert np.isfinite(got[0]["loss"])


def test_channel_sharded_energy_and_gradient(worlds):
    got = _results(worlds, "energy4")
    assert len(got) == 4
    loss, grad = got[0]["loss"], got[0]["grad"]
    loss_p, grad_p = worlds["port"]["energy"]
    loss_j, grad_j = worlds["jax"]["energy"]
    assert abs(loss - loss_p) <= TOL_PORT * abs(loss_p)
    assert abs(loss - loss_j) <= TOL_JAX * abs(loss_j)
    assert _rel(grad, grad_p) <= TOL_PORT and _rel(grad, grad_j) <= TOL_JAX
    # the backward pass gathers too (the scattered SSM fields and trajectories)
    assert got[0]["collectives"]["gather"]["count"] > TRAIN["B"]


def test_local_slice_and_gather_slices(worlds):
    """10 rows over 3 ranks: 4, 3, 3 (``torch.tensor_split``), gathered back
    whole on every rank."""
    ranks = [r["slices"] for r in worlds["ranks3"]]
    x = np.arange(20, dtype=np.float64).reshape(10, 2)
    for r, want in zip(ranks, np.array_split(x, 3)):
        np.testing.assert_array_equal(r["own"], want)
        np.testing.assert_array_equal(r["whole"], x)


def test_nccl_world_needs_a_gpu_a_rank(tmp_path):
    """nccl runs rank r on GPU r: a world larger than the GPUs is refused
    before any rank is spawned."""
    world = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="one GPU a rank"):
        pmesh.spawn_world(worker.run_cases, world, "nccl", ({},), root=str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_axis_needs_an_ambient_mesh():
    """An axis set without a mesh raises RuntimeError, as JAX's sharding
    constraint does; ``time_axis`` without the blocked path that reads it is
    refused; the placements are DTensor's Shard(0) / Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    model, params = worker.toy(PARAMS)
    y = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="ambient mesh"):
        tep.ep_infer(model, params, y, None, tep.EPConfig(channel_axis="channel"), device="cpu")
    with pytest.raises(RuntimeError, match="ambient mesh"):
        tep.ep_energy(model, params, y, None, tep.EPConfig(channel_axis="channel"), device="cpu")
    with pytest.raises(NotImplementedError, match="time_axis"):  # set without the blocked path
        tep.ep_infer(model, params, y, None, tep.EPConfig(time_axis="time"), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh({"data": 1}, "cpu")
    assert pmesh.data_sharding(None) == [Shard(0)] and pmesh.replicated(None) == [Replicate()]
    assert collectives.Axis("t", None, 2, 3).split(8) == (6, 8)
    assert [collectives.Axis("t", None, r, 3).split(8) for r in range(3)] == [
        (a[0].item(), a[-1].item() + 1) for a in torch.arange(8).tensor_split(3)]
