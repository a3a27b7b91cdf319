"""The port's mixture of experts (`parallel/moe.py`, MoE blocks in the
LM, the aux loss in the trainer) against the JAX package's `MoeMlp`,
`CausalLM` and `LMTrainer`, on the CPU in f32.

Same weights on both sides (the flax params through the port's
converter) and the same numpy inputs. Routing is integer work and must
match exactly: the experts each (token, choice) goes to, its slot in
the expert's queue and whether it is kept. Values differ only by f32
summation order: MoeMlp outputs (|out| ~ 1e-2) atol 1e-6, aux losses
atol 1e-6, drop rates exactly; the LM's logits atol 1e-4, losses 1e-5,
gradients 2e-5, parameters after three AdamW steps 5e-6 (the tolerances
of test_torch_lm_trainer.py, for the same reasons).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from torch_parity import (assert_params_match, jax_trainer, perturbed_params,
                          port_trainer, to_port)

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jmoe = importlib.import_module("mpi_operator_tpu.parallel.moe")
jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
tmoe = importlib.import_module("mpi_operator_tpu_torch.parallel.moe")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.lm_benchmark")

OUT_ATOL, AUX_ATOL = 1e-6, 1e-6
LOGIT_ATOL, LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-4, 1e-5, 2e-5, 5e-6
V, L, B, S = 96, 64, 4, 32


def _flax_moe(seed=0, zero_router=False, **kw):
    """The reference MoeMlp at the JAX suite's shape (x [2, 16, 32], 4
    experts, mlp 64, top-2, f32), its params and x."""
    base = dict(num_experts=4, embed_dim=32, mlp_dim=64, top_k=2,
                capacity_factor=1.25, dtype=jnp.float32)
    base.update(kw)
    m = jmoe.MoeMlp(**base)
    x = jax.random.normal(jax.random.PRNGKey(seed), (2, 16, 32))
    params = meta.unbox(m.init(jax.random.PRNGKey(1), x))["params"]
    if zero_router:
        params = {**params, "router": {"kernel": jnp.zeros_like(
            params["router"]["kernel"])}}
    return m, params, x


def _port_moe(params, **kw):
    base = dict(top_k=2, capacity_factor=1.25, dropless=False,
                dtype=torch.float32)
    base.update(kw)
    e, E, M = np.asarray(params["w_in"]).shape
    m = tmoe.MoeMlp(e, E, M, **base)
    m.load_state_dict({
        "router.weight": torch.from_numpy(
            np.array(params["router"]["kernel"]).T.copy()),
        "w_in": torch.from_numpy(np.array(params["w_in"])),
        "w_out": torch.from_numpy(np.array(params["w_out"]))})
    return m


def _run_both(zero_router=False, **kw):
    m, params, x = _flax_moe(zero_router=zero_router, **kw)
    (jout, jaux), diag = m.apply({"params": params}, x,
                                 mutable=["diagnostics"])
    jrate = float(jax.tree.leaves(diag["diagnostics"])[0])
    port_kw = {k: kw[k] for k in ("capacity_factor", "dropless") if k in kw}
    pm = _port_moe(params, **port_kw)
    out, aux = pm(torch.from_numpy(np.array(x)))
    return (np.asarray(jout), float(jaux), jrate), (
        out.detach().numpy(), float(aux.detach()), float(pm.drop_rate))


@pytest.mark.parametrize("kw", [
    dict(), dict(capacity_factor=0.5), dict(dropless=True),
    dict(zero_router=True), dict(zero_router=True, dropless=True)],
    ids=["capacity", "starved", "dropless", "zero-router",
         "zero-router-dropless"])
def test_moe_mlp_matches_flax(kw):
    """Output, aux loss and drop rate against flax MoeMlp: capacity
    dispatch at the default factor and a starved one, dropless, and a
    zero router (every probability tied: lax.top_k's lower-index order
    decides every route)."""
    (jout, jaux, jrate), (out, aux, rate) = _run_both(**kw)
    np.testing.assert_allclose(out, jout, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, atol=AUX_ATOL)
    assert rate == jrate
    if kw.get("zero_router") and not kw.get("dropless"):
        assert rate > 0.3          # experts 0 and 1 take every token


def _jax_slots(probs, k, e, cap):
    """`MoeMlp.__call__`'s routing (mpi_operator_tpu/parallel/moe.py:
    73-76, 120-128), verbatim in jnp over given probabilities."""
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    N = probs.shape[0]
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = onehot.reshape(N * k, e)
    pos = jnp.cumsum(flat, axis=0) * flat
    pos = pos.reshape(N, k, e).sum(-1) - 1
    keep = (pos >= 0) & (pos < cap)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    return (np.asarray(gate_vals), np.asarray(gate_idx), np.asarray(pos),
            np.asarray(keep))


@pytest.mark.parametrize("kind", ["random", "ties", "uniform"])
def test_routes_slots_and_keep_equal_the_reference_exactly(kind):
    """The port's route / slots against the reference's top_k and
    cumsum over the same probabilities: expert ids, slot positions and
    keep equal as integers; gates to 1 ulp. "ties" draws probabilities
    from four values so most rows hold equal entries; "uniform" is a
    zero router's softmax."""
    rs = np.random.RandomState(0)
    N, e, k = 64, 8, 2
    if kind == "random":
        p = rs.dirichlet(np.ones(e), N)
    elif kind == "ties":
        p = rs.randint(0, 4, (N, e)).astype(np.float64) + 1.0
        p /= p.sum(-1, keepdims=True)
    else:
        p = np.full((N, e), 1.0 / e)
    p = p.astype(np.float32)
    cap = tmoe.capacity(N, k, e, 1.25)
    jg, ji, jpos, jkeep = _jax_slots(jnp.asarray(p), k, e, cap)
    g, idx = tmoe.route(torch.from_numpy(p), k)
    pos, keep = tmoe.slots(idx, e, cap)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-7, atol=0)
    if kind != "random":
        assert not keep.all()      # the budget binds: keep is exercised


class TestDropRate:
    """The port's counterparts of tests/test_parallel.py TestMoeDropless
    (:1129, :1137, :1142): the drop rate is sane at the default
    capacity, reports starvation, and dropless equals a capacity no
    expert exceeds."""

    def _rate(self, **kw):
        _, params, x = _flax_moe()
        pm = _port_moe(params, **kw)
        out, aux = pm(torch.from_numpy(np.array(x)))
        return float(pm.drop_rate), out.detach(), aux.detach()

    def test_drop_rate_sane_at_default_capacity(self):
        rate, _, _ = self._rate()
        assert 0.0 <= rate <= 0.25, rate

    def test_drop_rate_reports_starvation(self):
        rate, _, _ = self._rate(capacity_factor=0.01)
        assert rate >= 0.8, rate

    def test_dropless_matches_infinite_capacity(self):
        _, ref, aux_ref = self._rate(capacity_factor=100.0)
        rate, out, aux = self._rate(dropless=True)
        np.testing.assert_allclose(out.detach().numpy(),
                                   ref.detach().numpy(), atol=2e-5)
        np.testing.assert_allclose(float(aux), float(aux_ref), atol=1e-6)
        assert rate == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_form_equals_the_one_hot_plain_version(dtype):
    """MoeMlp's index dispatch against `moe_ref` (the reference's one-hot
    dispatch and combine einsums) on the same weights, starved so tokens
    drop: aux and drop rate equal, outputs within f32 summation order
    (the expert GEMMs take the same bf16 operands in both)."""
    _, params, x = _flax_moe(seed=3)
    pm = _port_moe(params, capacity_factor=0.6, dtype=dtype)
    xt = torch.from_numpy(np.array(x)).to(dtype)
    out, aux = pm(xt)
    with torch.no_grad():
        ref, ref_aux, ref_rate = tmoe.moe_ref(
            xt, pm.router.weight, pm.w_in, pm.w_out, capacity_factor=0.6,
            dtype=dtype)
    assert float(pm.drop_rate) == float(ref_rate) > 0
    assert float(aux.detach()) == float(ref_aux)
    atol = OUT_ATOL if dtype == torch.float32 else 1e-4   # bf16 outputs
    np.testing.assert_allclose(out.detach().float().numpy(),
                               ref.detach().float().numpy(), atol=atol,
                               rtol=0)


def _configs(**kw):
    jcfg = jt.gpt2_config("test", attention="dense", dtype=jnp.float32,
                          vocab_size=V, max_len=L, num_experts=4, **kw)
    tcfg = tt.gpt2_config("test", attention="dense", dtype=torch.float32,
                          vocab_size=V, max_len=L, num_experts=4, **kw)
    return jcfg, tcfg


def _batch(seed):
    toks = np.random.RandomState(seed).randint(0, V, (B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def test_moe_lm_forward_grads_and_aux_match_flax():
    """gpt2-test with 4 experts (block 1 is MoE): logits, the aux loss,
    and the gradients of lm_loss + 0.01 * aux (the reference trainer's
    objective) against flax."""
    jcfg, tcfg = _configs()
    jm = jt.CausalLM(jcfg)
    tree = perturbed_params(jm)
    toks, tgts = _batch(1)

    def jloss(params):
        logits, interm = jm.apply({"params": params}, jnp.asarray(toks),
                                  mutable=["intermediates"])
        aux = jax.tree.leaves(interm["intermediates"])
        return (jtr.lm_loss(logits, jnp.asarray(tgts))
                + 0.01 * sum(a.mean() for a in aux)), (logits, aux)
    (jl, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, tree))

    trainer, state = port_trainer(tcfg, tree, B, S)
    logits, aux = state.model.forward_train(torch.from_numpy(toks).long())
    assert len(aux) == len(jaux) == 1
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux[0].detach()), float(jaux[0]),
                               atol=AUX_ATOL)
    loss, grads, _ = trainer.loss_and_grads(state, toks, tgts)
    np.testing.assert_allclose(float(loss), float(jl), atol=LOSS_ATOL)
    want = to_port(tcfg, jgrads)
    off = 0
    for name, shape in tt.param_shapes(tcfg).items():
        n = math.prod(shape)
        np.testing.assert_allclose(
            grads[off:off + n].reshape(shape).numpy(), want[name].numpy(),
            atol=GRAD_ATOL, rtol=0, err_msg=name)
        off += n
    assert any(".moe.w_in" in n for n in want)


def test_three_trainer_steps_match_lm_trainer():
    """Three AdamW steps of the MoE LM against the JAX LMTrainer on a
    one-device mesh: losses (aux included) per step and every parameter
    after step 3; eval leaves the aux term out on both sides; the step's
    model FLOPs count every expert on both sides (G2, kept for
    parity)."""
    jcfg, tcfg = _configs()
    tree = perturbed_params(jt.CausalLM(jcfg))
    jtrainer, jstate = jax_trainer(jt.CausalLM(jcfg), tree, B, S)
    trainer, state = port_trainer(tcfg, tree, B, S)
    for step in range(3):
        toks, tgts = _batch(10 + step)
        jstate, jm = jtrainer.train_step(jstate, jnp.asarray(toks),
                                         jnp.asarray(tgts))
        state, m = trainer.train_step(state, toks, tgts)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=LOSS_ATOL)
    assert_params_match(tcfg, state, jstate, PARAM_ATOL)
    toks, tgts = _batch(20)
    ev = float(trainer.eval_step(state, toks, tgts))
    np.testing.assert_allclose(
        ev, float(jtrainer.eval_step(jstate, jnp.asarray(toks),
                                     jnp.asarray(tgts))), atol=LOSS_ATOL)
    with torch.no_grad():
        logits, aux = state.model.forward_train(torch.from_numpy(toks).long())
    plain = float(ttr.lm_loss(logits, torch.from_numpy(tgts)))
    assert ev == pytest.approx(plain, abs=1e-6) and float(aux[0]) > 0
    want = jtrainer._step_flops(jstate, None)
    assert trainer._step_flops(state) == want
    e, E, M = 4, tcfg.embed_dim, tcfg.mlp_dim
    assert state.params.numel() >= 2 * e * E * M      # every expert counted


def test_llama_with_experts_raises_like_the_reference():
    cfg = tt.llama_config("test", num_experts=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="activation='gelu'"):
        tt.CausalLM(cfg)
    jcfg = jt.llama_config("test", num_experts=4, dtype=jnp.float32)
    with pytest.raises(ValueError, match="activation='gelu'"):
        jax.eval_shape(jt.CausalLM(jcfg).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 4), jnp.int32))


def test_run_lm_benchmark_reports_the_drop_rate():
    """moe_experts through the entry point: training runs, and one
    forward on a fresh batch after it reads the mean drop rate of the
    MoE layers; dropless reads 0; --moe-dropless alone raises."""
    kw = dict(workload="gpt2", size="test", batch_per_device=2, seq_len=16,
              num_steps=2, warmup_steps=1, dtype_name="float32",
              device="cpu", log=lambda s: None)
    state, m = bench.run_lm_benchmark(moe_experts=4, **kw)
    assert 0.0 <= m["moe_drop_rate"] < 1.0
    assert all(math.isfinite(x) for x in m["step_losses"])
    assert any(b.moe is not None for b in state.model.backbone.blocks)
    _, m = bench.run_lm_benchmark(moe_experts=4, moe_dropless=True, **kw)
    assert m["moe_drop_rate"] == 0.0
    _, m = bench.run_lm_benchmark(**kw)
    assert "moe_drop_rate" not in m
    with pytest.raises(ValueError, match="--moe-experts"):
        bench.run_lm_benchmark(moe_dropless=True, **kw)
