"""FSDP and tensor parallelism on the CPU: one gang of 8 gloo ranks
(tests/torch_mp_worker.py through launch.py and the bootstrap) runs the
legs below, each over its own mesh of the same processes, against one
process at the global batch and against the JAX LMTrainer on the same
mesh of the conftest's 8 virtual devices.

3 AdamW steps, global batch 8 x 16, f32, dense attention, the flax
weights converted (gpt2, llama and bert at their 2-layer test widths,
vocab 96):

- (dp, fsdp, tp) = (2, 2, 2) and (1, 2, 2): the update, mu and nu of the
  whole model (gathered over fsdp, tp) and the step losses equal the
  JAX LMTrainer's on the same mesh, and one process's, to the limits of
  tests/test_torch_lm_gang.py (UPDATE_REL, MOMENT_REL, LOSS_ATOL; the
  parameters to JAX_PARAM_ATOL);
- tp = 8 (4 heads: everything but the mlp replicates, H26);
- tp_overlap with the uni and the bidir ring (the fused, vocab-parallel
  loss in its ring form) equals the all-reduce path;
- the ring collective-matmuls equal the einsum forward and backward,
  with the non-divisible rows and the argument errors of the
  reference's TestRingCollectiveMatmul;
- the planted faults (one layer's row-parallel all-reduce skipped,
  fsdp's reduce-scatter over tp, a tp-replicated parameter counted tp
  times in the norm: H25) each miss the limits by FAULT_MARGIN;
- a same-mesh checkpoint resumes bit-equal; another split raises,
  naming restore_resharded, which restores it bit-equal.
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
from torch_mp_parity import (FAULT_MARGIN, JAX_PARAM_ATOL,  # noqa: E402
                             LOSS_ATOL, MOMENT_REL, UPDATE_REL)

TRAIN = ("gpt2/dp2-fsdp2-tp2", "llama/dp2-fsdp2-tp2", "bert/dp2-fsdp2-tp2",
         "gpt2/fsdp2-tp2", "gpt2/tp8", "gpt2/dp2-fsdp2-tp2-uni",
         "gpt2/dp2-fsdp2-tp2-bidir")
FAULTS = ("gpt2/fsdp2-tp2/allreduce-skipped",
          "gpt2/fsdp2-tp2/fsdp-wrong-group", "gpt2/fsdp2-tp2/norm-tp-times")
LEGS = TRAIN + FAULTS + ("matmul/dp2-tp4", "ckpt/fsdp2-tp2",
                         "ckpt/dp2-fsdp2-tp2")
#: the legs held to the JAX LMTrainer on their mesh
JAX_LEGS = ("gpt2/dp2-fsdp2-tp2", "gpt2/fsdp2-tp2", "llama/dp2-fsdp2-tp2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.run_gang(tmp_path_factory.mktemp("tp"), LEGS,
                       ("gpt2", "llama", "bert"))


@pytest.mark.parametrize("name", TRAIN)
def test_gang_equals_one_process(runs, name):
    got, weights = runs
    want = mp.one_process(name, weights)
    ranks = mp.ranks(got, name)
    assert len(ranks) == worker.tmesh.MeshConfig(
        **worker.LEGS[name]["mesh"]).num_devices
    err = worker.compare(ranks[0], want)
    assert err["update"] < UPDATE_REL, (name, err)
    assert max(err["mu"], err["nu"]) < MOMENT_REL, (name, err)
    for r in ranks:
        assert max(abs(a - b) for a, b in zip(r["losses"], want["losses"])) \
            < LOSS_ATOL, (name, r["losses"])
        assert r["count"] == 3 and r["streak"] == 0
        assert r["digest"] == ranks[0]["digest"]


@pytest.mark.parametrize("name", JAX_LEGS)
def test_gang_equals_the_jax_trainer_on_the_same_mesh(runs, name):
    """The update, mu, nu and losses against the JAX LMTrainer jitted
    over the same mesh of the virtual devices."""
    got, weights = runs
    want = mp.jax_run(name, weights)
    r = mp.ranks(got, name)[0]
    np.testing.assert_allclose(r["losses"], want["losses"], atol=LOSS_ATOL)
    np.testing.assert_allclose(r["params"].numpy(), want["params"].numpy(),
                               atol=JAX_PARAM_ATOL, rtol=0)
    start = mp.start_flat(name, weights)
    assert worker.rel(r["params"] - start,
                      want["params"] - start) < UPDATE_REL
    assert worker.rel(r["mu"], want["mu"]) < MOMENT_REL
    assert worker.rel(r["nu"], want["nu"]) < MOMENT_REL


@pytest.mark.parametrize("name", FAULTS)
def test_planted_faults_miss_the_limits(runs, name):
    """Each fault misses the update, mu or nu limit by FAULT_MARGIN (the
    norm fault moves the clip: the gradient's norm is above 1 here, so
    the clip is active, and mu and nu scale with it)."""
    got, weights = runs
    want = mp.one_process(name, weights)
    err = worker.compare(mp.ranks(got, name)[0], want)
    assert max(err["update"] / UPDATE_REL, err["mu"] / MOMENT_REL,
               err["nu"] / MOMENT_REL) > FAULT_MARGIN, (name, err)


def test_overlap_rings_equal_the_all_reduce_path(runs):
    """Both rings' updates equal the all-reduce path's, against the same
    one process's, and their losses equal its losses."""
    got, weights = runs
    want = mp.one_process("gpt2/dp2-fsdp2-tp2", weights)
    base = mp.ranks(got, "gpt2/dp2-fsdp2-tp2")[0]
    for ring in ("uni", "bidir"):
        r = mp.ranks(got, f"gpt2/dp2-fsdp2-tp2-{ring}")[0]
        err = worker.compare(r, want)
        assert err["update"] < UPDATE_REL and err["loss"] < LOSS_ATOL, err
        assert max(abs(a - b) for a, b in zip(r["losses"], base["losses"])) \
            < LOSS_ATOL


def test_collective_matmuls_equal_the_einsum(runs):
    got, _ = runs
    for r in mp.ranks(got, "matmul/dp2-tp4"):
        for ring in ("uni", "bidir"):
            assert r[f"agm-{ring}"] < 1e-5
            for S in (8, 6):
                assert r[f"mrs-{ring}-{S}"] < 1e-5
                assert r[f"mrs-{ring}-{S}-shape"] == (2, 8, 12)
                assert r[f"mrs-{ring}-{S}-pad-zero"]
        m = r["messages"]
        assert "contraction mismatch" in m[0] and "contraction mismatch" \
            in m[1]
        assert "must be 'uni' or 'bidir'" in m[2] and "rank>=2" in m[3]


@pytest.mark.parametrize("name", ["ckpt/fsdp2-tp2", "ckpt/dp2-fsdp2-tp2"])
def test_checkpoint_resumes_bit_equal_and_refuses_another_split(runs, name):
    got, _ = runs
    for r in mp.ranks(got, name):
        assert r["step"] == 2 and r["verified"] and r["loss_equal"]
        assert r["params"] and r["mu"] and r["nu"]
        assert "restore_resharded" in r["other_mesh"] and r["resharded"]


def test_h25_the_norm_counts_each_parameter_once(runs):
    """The gang's clipped update equals one process's only when every
    parameter enters the norm once: the sound leg holds, the norm fault
    (weight 1 on the tp-replicated class) does not."""
    got, weights = runs
    want = mp.one_process("gpt2/fsdp2-tp2", weights)
    sound = worker.compare(mp.ranks(got, "gpt2/fsdp2-tp2")[0], want)
    fault = worker.compare(mp.ranks(got, "gpt2/fsdp2-tp2/norm-tp-times")[0],
                           want)
    assert sound["mu"] < MOMENT_REL < fault["mu"]
