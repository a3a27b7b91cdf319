"""Pipelines with mixture-of-experts blocks on the CPU (GPipe only, as
the reference): one gang of 8 gloo ranks (tests/torch_mp_worker.py
through launch.py and the bootstrap) against the JAX PipelineLMTrainer
on the same mesh of the conftest's 8 virtual devices.

3 AdamW steps, global batch 16 x 16 in M = 4 microbatches, f32, dense
attention, the flax weights converted (gpt2's test width at 4 layers
with 4 experts in every second block, vocab 96):

- (pp, dp) = (2, 4) in capacity mode (H32: data rank i of microbatch m
  holds rows m B/M + i B/(M D) onward, and each routes and budgets its
  capacity over those rows alone, as the reference's microbatch shard
  does; a contiguous B/D block cut into M pieces would route other
  tokens together) and dropless;
- (pp, ep) = (2, 2): each rank its experts, the tokens replicated over
  ep, against one process's PipelineLMTrainer at pp 1 and one process's
  LMTrainer with accum_steps = M (each routes every microbatch's rows
  alone, as the pipeline does);
- the aux loss and the drop rate normalised per (microbatch, data
  shard), as the reference's `_finalize_moe` does (H33).
"""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_parity as mp  # noqa: E402
import torch_mp_worker as worker  # noqa: E402
import torch_pp_parity as pp  # noqa: E402
from mpi_operator_tpu_torch.data.synthetic import rank_share  # noqa: E402

#: the legs held to the JAX pipeline
JAX_LEGS = ("pp/moe/pp2-dp4-gpipe", "pp/moe/pp2-dp4-gpipe-dropless")
LEGS = JAX_LEGS + ("pp/moe/pp2-ep2-gpipe",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pp.run_gang(tmp_path_factory.mktemp("ppm"), LEGS)


@pytest.mark.parametrize("name", JAX_LEGS)
def test_gang_equals_the_jax_pipeline_trainer_on_the_same_mesh(runs, name):
    got, weights = runs
    pp.check_against_jax(got, name, weights)
    ranks = mp.ranks(got, name)
    for r in ranks:
        assert r["digest"] == ranks[0]["digest"]
        assert r["replicated_digest"] == ranks[0]["replicated_digest"]


def test_experts_over_ep_equal_one_stage(runs):
    """(pp, ep) = (2, 2): each rank its experts, the tokens replicated
    over ep, equals the same model routed the same way (per microbatch)
    by one process's PipelineLMTrainer at pp 1, and by one process's
    LMTrainer accumulating over the same M microbatches (code the
    pipeline does not share)."""
    got, weights = runs
    name = "pp/moe/pp2-ep2-gpipe"
    spec = dict(worker.LEGS[name], mesh={})
    mesh = worker.tmesh.make_mesh(worker.tmesh.MeshConfig())
    state = weights[spec["weights"]][1]
    ranks = mp.ranks(got, name)
    for want in (worker.pp_train_leg(spec, "cpu", mesh, state),
                 worker.train_leg(dict(spec, kind="train",
                                       accum=spec["micro"]), "cpu", None,
                                  state)):
        err = worker.compare(ranks[0], want)
        assert err["update"] < mp.UPDATE_REL, err
        assert max(err["mu"], err["nu"]) < mp.MOMENT_REL, err
        for r in ranks:
            assert r["digest"] == ranks[0]["digest"]
            assert max(abs(a - b) for a, b in
                       zip(r["losses"], want["losses"])) < mp.LOSS_ATOL


def test_h32_rows_a_rank_holds():
    """The rows PipelineLMTrainer.share gives data rank i: row m B/M + i
    B/(M D) onward of each microbatch m (B 16, M 4, D 4: one row of
    each), not a contiguous B/D block."""
    rows = np.arange(16)[:, None]
    for i in range(4):
        got = rank_share(rows, i, 4, accum_steps=4)
        assert got[:, 0].tolist() == [m * 4 + i for m in range(4)]


def test_capacity_routing_differs_from_one_process(runs):
    """Capacity and routing per (microbatch, data shard): the pipeline's
    update is the reference pipeline's (above) and NOT the LMTrainer's,
    which routes the global batch at once."""
    got, weights = runs
    spec = dict(worker.LEGS["pp/moe/pp2-dp4-gpipe"], fault=None,
                kind="train")
    want = worker.train_leg(spec, "cpu", None,
                            weights[spec["weights"]][1])
    err = worker.compare(mp.ranks(got, "pp/moe/pp2-dp4-gpipe")[0], want)
    assert err["update"] > mp.UPDATE_REL * mp.FAULT_MARGIN, err
