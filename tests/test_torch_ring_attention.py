"""Sequence parallelism on the CPU: ring attention (parallel/
ring_attention.py) and the LMTrainer over sp, one gang of 8 gloo ranks
(tests/torch_mp_worker.py) against the JAX package on the conftest's 8
virtual devices.

- `ring_attention` at sp = 4 (dp = 2) and sp = 8, causal and not,
  through the flash inner and the dense fallback: the output and the
  gradients dq, dk, dv of a seeded cotangent equal the reference's
  ring_attention (flash inner, interpret mode) to 1e-5 and dense
  attention over the whole sequence.
- H28, the causal plan: on the rank at sp index i, K1, K2 and K3 (their
  plain versions here) run i + 1 times, n times without the mask.
- The trainer at (dp, sp, tp) = (2, 2, 2): 3 AdamW steps of gpt2 equal
  the JAX LMTrainer's with attention "ring" on the same mesh, and one
  process's; llama (RoPE) equals one process's (H29: the positions of a
  sequence shard start at sp_rank x S/sp). Its plain K1-K3 calls follow
  H28's plan, layer by layer.
- The planted fault (the ring's diagonal block non-causal) misses the
  limits. A key mask with attention "ring", and any other attention
  under sp, raise (H29).
"""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_parity as mp  # noqa: E402
import torch_mp_worker as worker  # noqa: E402

jpar = importlib.import_module("mpi_operator_tpu.parallel")
jring = importlib.import_module("mpi_operator_tpu.parallel.ring_attention")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
tmesh = importlib.import_module("mpi_operator_tpu_torch.parallel.mesh")
tsh = importlib.import_module("mpi_operator_tpu_torch.parallel.sharding")

ATOL = 1e-5
RINGS = ("ring/dp2-sp4", "ring/sp8")
DENSE = ("ring/dp2-sp4-dense", "ring/sp8-dense")
TRAIN = ("gpt2/dp2-sp2-tp2", "llama/dp2-sp2-tp2")
FAULT = "gpt2/dp2-sp2-tp2/ring-diagonal-noncausal"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.run_gang(tmp_path_factory.mktemp("sp"), RINGS + DENSE + TRAIN
                       + (FAULT,), ("gpt2", "llama"))


def _jax_ring(name, causal):
    """The reference's ring_attention on the leg's mesh: out and the
    gradients of the same seeded cotangent."""
    spec = worker.LEGS[name]
    q, k, v, do = (jnp.asarray(t.numpy()) for t in worker.ring_inputs(
        4, 64, 2, 16, torch.float32))
    mesh = jpar.make_mesh(jpar.MeshConfig(**spec["mesh"]))
    out, vjp = jax.vjp(lambda a, b, c: jring.ring_attention(
        a, b, c, mesh, causal=causal), q, k, v)
    return [np.asarray(t) for t in (out, *vjp(do))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", RINGS + DENSE)
def test_ring_equals_the_reference_and_dense(runs, name, causal):
    """Both inners, flash (the plain K1-K3 a block) and the dense
    fallback, against the reference's ring and dense attention."""
    got, _ = runs
    r = got[0][name][causal]
    want = _jax_ring(name, causal)
    for key, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(r[key].numpy(), w, atol=ATOL,
                                   err_msg=key)
    q, k, v, do = (t.clone().requires_grad_() for t in worker.ring_inputs(
        4, 64, 2, 16, torch.float32))
    out = tt.dense_attention(q, k, v, causal=causal, dtype=torch.float32)
    out.backward(do.detach())
    for key, w in zip(("out", "dq", "dk", "dv"),
                      (out, q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(r[key].numpy(), w.detach().numpy(),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", RINGS)
def test_h28_the_causal_plan(runs, name):
    """Rank i of the ring runs its visible blocks only: i + 1 of each
    kernel under the causal mask (the diagonal causal, those below
    non-causal), every block without it."""
    got, _ = runs
    n = worker.LEGS[name]["mesh"]["sp"]
    for r in got:
        for causal, res in ((c, r[name][c]) for c in (True, False)):
            want = res["sp_index"] + 1 if causal else n
            assert res["plain_calls"] == {k: want for k in worker.FLASH}


def test_trainer_over_sp_equals_the_jax_trainer(runs):
    got, weights = runs
    name = "gpt2/dp2-sp2-tp2"
    want = mp.jax_run(name, weights)
    r = got[0][name]
    np.testing.assert_allclose(r["losses"], want["losses"],
                               atol=mp.LOSS_ATOL)
    np.testing.assert_allclose(r["params"].numpy(), want["params"].numpy(),
                               atol=mp.JAX_PARAM_ATOL, rtol=0)
    assert worker.rel(r["mu"], want["mu"]) < mp.MOMENT_REL
    assert worker.rel(r["nu"], want["nu"]) < mp.MOMENT_REL


@pytest.mark.parametrize("name", TRAIN)
def test_trainer_over_sp_equals_one_process(runs, name):
    """The sequence shards' positions start at sp_rank x S/sp (learned
    positions for gpt2, RoPE for llama), the loss and gradients sum over
    sp: every rank equals one process at the global batch. Each rank's
    plain K1-K3 calls are H28's plan, 2 layers x 3 steps."""
    got, weights = runs
    want = mp.one_process(name, weights)
    ranks = mp.ranks(got, name)
    err = worker.compare(ranks[0], want)
    assert err["update"] < mp.UPDATE_REL, err
    assert max(err["mu"], err["nu"]) < mp.MOMENT_REL, err
    for r in ranks:
        assert max(abs(a - b) for a, b in zip(r["losses"], want["losses"])) \
            < mp.LOSS_ATOL, r["losses"]
        assert r["digest"] == ranks[0]["digest"]
    sp_index = [tmesh.Mesh(tmesh.MeshConfig(dp=2, sp=2, tp=2),
                           range(8)).coords(rank)["sp"] for rank in range(8)]
    for rank, r in enumerate(got):
        assert r[name]["plain_calls"] == {
            k: 2 * 3 * (sp_index[rank] + 1) for k in worker.FLASH}


def test_diagonal_block_run_non_causal_misses_the_limits(runs):
    got, weights = runs
    want = mp.one_process(FAULT, weights)
    err = worker.compare(mp.ranks(got, FAULT)[0], want)
    assert err["update"] > mp.FAULT_MARGIN * mp.UPDATE_REL, err


def test_h29_masks_and_other_attention_under_sp_raise():
    """attend() under sp: a key mask with "ring" raises (the ring takes
    none), and dense or flash raise (they would attend within a shard);
    "ring" without sp raises as the reference's does."""
    cfg = tt.bert_config("test", attention="ring", dtype=torch.float32,
                         vocab_size=96, max_len=32)
    mesh = tmesh.Mesh(tmesh.MeshConfig(sp=2), range(2))
    layout = tsh.ModelLayout(mesh, cfg)
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="key-padding mask"):
        tt.attend(q, q, q, torch.ones(1, 8), cfg, layout)
    for impl in ("dense", "flash"):
        with pytest.raises(ValueError, match="attention must be 'ring'"):
            tt.attend(q, q, q, None, dataclasses.replace(cfg, attention=impl),
                      layout)
    with pytest.raises(ValueError, match="sp > 1"):
        tt.attend(q, q, q, None, cfg, None)
