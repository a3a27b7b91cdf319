"""Helpers shared by the port's training parity tests: the same weights
and the same trainer shape on both sides (the JAX package and the
port), on the CPU in f32."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
from flax.core import meta

jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")


def perturbed_params(jm, seed=0):
    """flax params of module `jm` as nested numpy dicts, biases and norm
    scales moved off their zeros/ones init (`mlm_bias` too)."""
    params = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 4), jnp.int32)))
    rs = np.random.RandomState(seed + 1)

    def walk(node):
        out = {}
        for k, val in node.items():
            if isinstance(val, dict):
                out[k] = walk(val)
            else:
                a = np.array(val, np.float32)
                if k in ("bias", "scale", "mlm_bias"):
                    a = a + 0.1 * rs.randn(*a.shape).astype(np.float32)
                out[k] = a
        return out
    return walk(jax.tree.map(np.asarray, params["params"]))


def to_port(tcfg, tree):
    """The flax tree (or a gradient tree of its shape) as the port's
    state dict."""
    return convert.params_from_flax(tcfg, jax.tree.map(np.asarray, tree))


def jax_trainer(jm, tree, batch, seq, **kw):
    """The JAX LMTrainer over module `jm` on a one-device mesh, warmup 2,
    and a state holding `tree`."""
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=1), devices=jax.devices()[:1])
    tr = jtr.LMTrainer(jm, mesh, jtr.LMTrainerConfig(
        global_batch_size=batch, seq_len=seq, warmup_steps=2, **kw))
    state = tr.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda ref, x: jax.device_put(jnp.asarray(x),
                                                        ref.sharding),
                          state.params, tree)
    return tr, state.replace(params=params)


def port_trainer(tcfg, tree, batch, seq, **kw):
    """The port's LMTrainer on the CPU, warmup 2, from `tree`."""
    tr = ttr.LMTrainer(tcfg, ttr.LMTrainerConfig(
        global_batch_size=batch, seq_len=seq, warmup_steps=2, **kw),
        device="cpu")
    return tr, tr.init_state(state_dict=to_port(tcfg, tree))


def assert_params_match(tcfg, state, jstate, atol):
    want = to_port(tcfg, jstate.params)
    for name, p in state.named_params().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)
