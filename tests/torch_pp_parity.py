"""Helpers shared by the pipeline parity tests (test_torch_pp.py,
test_torch_pp_compose.py, test_torch_pp_moe.py): the gang of
tests/torch_mp_worker.py's pipeline legs from the perturbed flax weights
at 4 layers, one process's LMTrainer run of a leg, and the JAX
PipelineLMTrainer on a leg's mesh of the conftest's virtual devices,
its state read back through `params_from_stacked`."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_mp_parity as mp
import torch_mp_worker as worker
from torch_parity import perturbed_params, to_port

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpp = importlib.import_module("mpi_operator_tpu.train.pp_trainer")
jpipe = importlib.import_module("mpi_operator_tpu.parallel.pipeline")
j1f1b = importlib.import_module("mpi_operator_tpu.parallel.pipeline_1f1b")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")


def _cfgs(spec):
    """(JAX config, port config) of a leg's model."""
    over = {k: v for k, v in spec["cfg"].items() if k != "attention"}
    jcfg = dataclasses.replace(mp.jax_configs()[spec["model"]], **over)
    if spec["cfg"].get("attention"):
        jcfg = dataclasses.replace(jcfg, attention=spec["cfg"]["attention"])
    return jcfg, worker.config_of(spec)


def weights_for(legs):
    """{weights name: (flax tree, port state dict)} of the legs' models
    (the perturbed flax init at the leg's depth)."""
    out = {}
    for name in legs:
        spec = worker.LEGS[name]
        key = spec.get("weights", spec["model"])
        if key in out:
            continue
        jcfg, tcfg = _cfgs(spec)
        jcfg = dataclasses.replace(jcfg, attention="dense")
        tree = perturbed_params(jt.CausalLM(jcfg) if jcfg.causal
                                else jt.MaskedLM(jcfg))
        out[key] = (tree, to_port(tcfg, tree))
    return out


def run_gang(tmp, legs, world=8):
    """(each rank's results, the weights)."""
    weights = weights_for(legs)
    path = tmp / "weights.pt"
    torch.save({k: v[1] for k, v in weights.items()}, path)
    got = worker.gang(world, str(tmp / "r"), legs, "--weights", str(path))
    return got, weights


def one_process(name, weights):
    """The leg's model through the LMTrainer at one process (dense
    attention), from the same weights and global batches, no fault."""
    spec = dict(worker.LEGS[name], fault=None, kind="train")
    spec["cfg"] = {k: v for k, v in spec["cfg"].items() if k != "attention"}
    return worker.train_leg(spec, "cpu", None, weights[spec["weights"]][1])


def jax_run(name, weights):
    """The JAX PipelineLMTrainer on the leg's mesh of the virtual devices,
    from the same stacked weights: its losses and the final params, mu
    and nu as the port's whole-model flat buffers."""
    spec = worker.LEGS[name]
    jcfg, tcfg = _cfgs(spec)
    mc = jpar.MeshConfig(**spec["mesh"])
    mesh = jpar.make_mesh(mc, devices=jax.devices()[:mc.num_devices])
    pp, v = spec["mesh"]["pp"], spec["interleave"]
    tr = jpp.PipelineLMTrainer(
        jcfg, mesh, jtr.LMTrainerConfig(
            global_batch_size=spec["batch"], seq_len=spec["seq"],
            warmup_steps=2, masked_lm=not jcfg.causal,
            fused_xent=spec["fused"]),
        num_microbatches=spec["micro"], schedule=spec["schedule"],
        interleave=v)
    state = tr.init_state(jax.random.PRNGKey(0))
    stack = jpipe.stack_lm_params if jcfg.causal else jpipe.stack_mlm_params
    stacked = stack(weights[spec["weights"]][0], jcfg.num_layers,
                    num_experts=jcfg.num_experts, moe_every=jcfg.moe_every)
    if v > 1:
        stacked = dict(stacked, blocks=j1f1b.interleave_blocks(
            stacked["blocks"], pp, v))
    state = state.replace(params=jax.tree.map(
        lambda ref, x: jax.device_put(jnp.asarray(x), ref.sharding),
        state.params, stacked))
    losses = []
    for b in worker.batches(tcfg, spec["steps"], spec["seq"], spec["batch"]):
        args = [jnp.asarray(a, jnp.int32 if i < 2 else jnp.float32)
                for i, a in enumerate(b) if a is not None]
        state, m = tr.train_step(state, *tr.microbatch(*args))
        losses.append(float(m["loss"]))

    def flat(tree):
        port = convert.params_from_stacked(
            tcfg, jax.tree.map(np.asarray, tree), pp, v)
        return torch.cat([port[n].reshape(-1)
                          for n in tt.param_shapes(tcfg)])
    adam = state.opt_state[1][0]
    return {"losses": losses, "params": flat(state.params),
            "mu": flat(adam.mu), "nu": flat(adam.nu)}


def start_flat(name, weights):
    spec = worker.LEGS[name]
    tcfg = worker.config_of(spec)
    state = weights[spec["weights"]][1]
    return torch.cat([state[n].reshape(-1) for n in tt.param_shapes(tcfg)])


def check_against_jax(got, name, weights):
    """The leg's losses, params, update, mu and nu against the JAX
    PipelineLMTrainer's on the same mesh, to torch_mp_parity's limits."""
    want = jax_run(name, weights)
    r = mp.ranks(got, name)[0]
    np.testing.assert_allclose(r["losses"], want["losses"],
                               atol=mp.LOSS_ATOL)
    np.testing.assert_allclose(r["params"].numpy(), want["params"].numpy(),
                               atol=mp.JAX_PARAM_ATOL, rtol=0)
    start = start_flat(name, weights)
    err = {"update": worker.rel(r["params"] - start,
                                want["params"] - start),
           "mu": worker.rel(r["mu"], want["mu"]),
           "nu": worker.rel(r["nu"], want["nu"])}
    assert err["update"] < mp.UPDATE_REL, (name, err)
    assert max(err["mu"], err["nu"]) < mp.MOMENT_REL, (name, err)
    return err


def check_against_one_process(got, name, weights):
    """Every rank's losses, and the gathered update, mu and nu, against
    one process's LMTrainer run; every rank's gathered state and
    replicated leaves equal."""
    want = one_process(name, weights)
    ranks = mp.ranks(got, name)
    assert len(ranks) == worker.tmesh.MeshConfig(
        **worker.LEGS[name]["mesh"]).num_devices
    err = worker.compare(ranks[0], want)
    assert err["update"] < mp.UPDATE_REL, (name, err)
    assert max(err["mu"], err["nu"]) < mp.MOMENT_REL, (name, err)
    for r in ranks:
        assert max(abs(a - b) for a, b in zip(r["losses"], want["losses"])) \
            < mp.LOSS_ATOL, (name, r["losses"], want["losses"])
        assert r["count"] == worker.LEGS[name]["steps"]
        assert r["digest"] == ranks[0]["digest"]
        assert r["replicated_digest"] == ranks[0]["replicated_digest"]
    return err
