"""Helpers shared by the model-parallel parity tests
(test_torch_tp.py, test_torch_ring_attention.py, test_torch_ep.py): the
gang of tests/torch_mp_worker.py from the perturbed flax weights, one
process's run of a leg, and the JAX LMTrainer on a leg's mesh of the
conftest's virtual devices."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_mp_worker as worker
from torch_parity import perturbed_params, to_port

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")

# test_torch_lm_gang.py's limits
UPDATE_REL, MOMENT_REL, LOSS_ATOL = 1e-4, 1e-5, 1e-5
JAX_PARAM_ATOL = 5e-6
FAULT_MARGIN = 10

def jax_configs():
    common = dict(attention="dense", dtype=jnp.float32,
                  vocab_size=worker.VOCAB, max_len=32)
    return {"gpt2": jt.gpt2_config("test", **common),
            "llama": jt.llama_config("test", **common),
            "bert": jt.bert_config("test", **common),
            "moe": jt.gpt2_config("test", num_experts=4, **common)}


def flax_weights(names):
    """{name: (flax tree, port state dict)} of the perturbed flax init."""
    tcfgs = worker.model_configs("test")
    out = {}
    for name in names:
        jcfg = jax_configs()[name]
        tree = perturbed_params(jt.CausalLM(jcfg) if jcfg.causal
                                else jt.MaskedLM(jcfg))
        out[name] = (tree, to_port(tcfgs[name], tree))
    return out


def run_gang(tmp, legs, names, world=8):
    """(each rank's results, {name: (tree, state dict)})."""
    weights = flax_weights(names)
    path = tmp / "weights.pt"
    torch.save({k: v[1] for k, v in weights.items()}, path)
    got = worker.gang(world, str(tmp / "r"), legs, "--weights", str(path))
    return got, weights


def one_process(name, weights):
    """The leg at one process (dense attention: sp = 1), its faults off."""
    spec = dict(worker.LEGS[name], fault=None)
    spec["cfg"] = {k: v for k, v in spec["cfg"].items()
                   if k not in ("attention", "tp_overlap", "tp_ring")}
    return worker.train_leg(spec, "cpu", None,
                            weights[spec["model"]][1])


def jax_run(name, weights):
    """The JAX LMTrainer on the leg's mesh of the virtual devices: the
    losses and the final params, mu, nu as the port's flat buffers."""
    spec = worker.LEGS[name]
    jcfg = jax_configs()[spec["model"]]
    tcfg = worker.model_configs("test")[spec["model"]]
    if spec["cfg"].get("attention"):
        jcfg = dataclasses.replace(jcfg, attention=spec["cfg"]["attention"])
    mc = jpar.MeshConfig(**spec["mesh"])
    mesh = jpar.make_mesh(mc, devices=jax.devices()[:mc.num_devices])
    tr = jtr.LMTrainer((jt.CausalLM if jcfg.causal else jt.MaskedLM)(jcfg),
                       mesh, jtr.LMTrainerConfig(
                           global_batch_size=spec["batch"],
                           seq_len=spec["seq"], warmup_steps=2,
                           masked_lm=not jcfg.causal,
                           accum_steps=spec["accum"]))
    state = tr.init_state(jax.random.PRNGKey(0))
    tree = weights[spec["model"]][0]
    state = state.replace(params=jax.tree.map(
        lambda ref, x: jax.device_put(jnp.asarray(x), ref.sharding),
        state.params, tree))
    losses = []
    for b in worker.batches(tcfg, spec["steps"], spec["seq"]):
        args = [jax.device_put(jnp.asarray(a, jnp.int32 if i < 2
                                           else jnp.float32),
                               tr.batch_sharding)
                for i, a in enumerate(b) if a is not None]
        state, m = tr.train_step(state, *args)
        losses.append(float(m["loss"]))

    def flat(tree):
        port = to_port(tcfg, jax.tree.map(np.asarray, tree))
        return torch.cat([port[n].reshape(-1)
                          for n in tt.param_shapes(tcfg)])
    adam = state.opt_state[1][0]
    return {"losses": losses, "params": flat(state.params),
            "mu": flat(adam.mu), "nu": flat(adam.nu)}


def start_flat(name, weights):
    """The flat buffer, in `param_shapes` order, of the weights leg
    `name` starts from."""
    spec = worker.LEGS[name]
    tcfg = worker.model_configs("test")[spec["model"]]
    state = weights[spec["model"]][1]
    return torch.cat([state[n].reshape(-1) for n in tt.param_shapes(tcfg)])


def ranks(got, name):
    """The results of the ranks that took part in leg `name`."""
    return [r[name] for r in got if name in r]
