"""Pipelines on the CPU: one gang of 8 gloo ranks (tests/torch_mp_worker.py
through launch.py and the bootstrap) runs the legs below, each over its
own mesh of the same processes, against the JAX PipelineLMTrainer on the
same mesh of the conftest's 8 virtual devices and against one process's
LMTrainer at the global batch.

3 AdamW steps, global batch 16 x 16 in M = 4 microbatches, f32, dense
attention, the flax weights converted (gpt2 at 4 layers of its test
width, vocab 96):

- (pp, dp) = (2, 4) under GPipe and under 1F1B x 2, (pp, tp, dp) =
  (2, 2, 2) under GPipe, and the fused loss on the last stage: losses,
  the update, mu and nu of the whole model equal the JAX trainer's and
  one process's to the limits of tests/torch_mp_parity.py;
- every rank's replicated leaves are bit-equal after the updates (H30);
- the planted faults (the tied embedding's gradient not summed over pp,
  one backward hop dropped, the replicated leaves counted pp times in
  the norm: H30, H31, H34) each miss the limits by FAULT_MARGIN;
- a GPipe checkpoint resumes under 1F1B x 2 and back with canonical
  params, mu, nu and step bit-equal, the 1F1B x 2 evaluation equals
  GPipe's on the same weights (H35), and another pp or tp raises naming
  restore_resharded, which restores it bit-equal;
- `pipeline_apply` at pp = 4 equals the stages applied in sequence,
  forward and backward (the reference's TestPipeline);
- the benchmark's keys (the reference's), its MFU from the whole
  model's parameters (the CLI: test_torch_pp_cli.py).
"""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_parity as mp  # noqa: E402
import torch_mp_worker as worker  # noqa: E402
import torch_pp_parity as pp  # noqa: E402
from mpi_operator_tpu_torch.parallel.pipeline_1f1b import \
    simulate_1f1b  # noqa: E402
from mpi_operator_tpu_torch.utils import flops  # noqa: E402
from torch_mp_parity import (FAULT_MARGIN, MOMENT_REL,  # noqa: E402
                             UPDATE_REL)

TRAIN = ("pp/gpt2/pp2-dp4-gpipe", "pp/gpt2/pp2-tp2-dp2-gpipe",
         "pp/gpt2/pp2-dp4-1f1b2", "pp/gpt2/pp2-dp4-fused")
FAULTS = ("pp/gpt2/pp2-dp4-gpipe/tied-not-summed",
          "pp/gpt2/pp2-dp4-gpipe/hop-dropped",
          "pp/gpt2/pp2-dp4-gpipe/norm-pp-times")
LEGS = TRAIN + FAULTS + ("pp-ckpt/gpt2/pp2-dp4", "pp-apply/pp4-dp2",
                         "pp-bench/gpt2/pp2-dp4-1f1b2")
#: the keys of the reference's PipelineLMTrainer.benchmark
REFERENCE_KEYS = ("tokens_per_sec", "tokens_per_sec_per_device",
                  "final_loss", "bubble_fraction", "step_time_p50_ms",
                  "step_time_p99_ms", "host_gap_p50_ms", "host_gap_p99_ms",
                  "flops_per_step", "tflops_per_sec_per_device", "mfu")
_CFG = worker.config_of(worker.LEGS["pp-bench/gpt2/pp2-dp4-1f1b2"])
#: 6N + attention a token (utils/flops.py) over the WHOLE model, 16 x 16
WHOLE_MODEL_FLOPS = flops.transformer_train_flops_per_token(
    sum(int(torch.Size(s).numel()) for s in
        worker.tt.param_shapes(_CFG).values()),
    _CFG.num_layers, _CFG.embed_dim, 16, causal=True) * 16 * 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pp.run_gang(tmp_path_factory.mktemp("pp"), LEGS)


@pytest.mark.parametrize("name", TRAIN)
def test_gang_equals_one_process(runs, name):
    got, weights = runs
    pp.check_against_one_process(got, name, weights)


@pytest.mark.parametrize("name", TRAIN)
def test_gang_equals_the_jax_pipeline_trainer_on_the_same_mesh(runs, name):
    got, weights = runs
    pp.check_against_jax(got, name, weights)


def test_stages_hold_their_layers(runs):
    """GPipe's stage p holds layers [2p, 2p + 2); 1F1B x 2's rank d its
    virtual stages d and P + d (H35: the reference's layer order)."""
    got, _ = runs
    for i, r in enumerate(got):
        d = i // 4                          # (pp, dp) = (2, 4), dp inner
        assert r["pp/gpt2/pp2-dp4-gpipe"]["layers"] == [2 * d, 2 * d + 1]
        assert r["pp/gpt2/pp2-dp4-1f1b2"]["layers"] == [d, 2 + d]


@pytest.mark.parametrize("name", FAULTS)
def test_planted_faults_miss_the_limits(runs, name):
    got, weights = runs
    want = pp.one_process(name, weights)
    err = worker.compare(mp.ranks(got, name)[0], want)
    assert max(err["update"] / UPDATE_REL, err["mu"] / MOMENT_REL,
               err["nu"] / MOMENT_REL) > FAULT_MARGIN, (name, err)


def test_h30_unsummed_tied_gradient_splits_the_replicas(runs):
    """Without the sum over pp each stage updates its own copy of wte
    from its own use of it: the ranks' replicated leaves differ."""
    got, _ = runs
    digests = {r["replicated_digest"] for r in
               mp.ranks(got, "pp/gpt2/pp2-dp4-gpipe/tied-not-summed")}
    assert len(digests) == 2


def test_h34_the_norm_counts_replicated_leaves_once(runs):
    got, weights = runs
    want = pp.one_process("pp/gpt2/pp2-dp4-gpipe", weights)
    sound = worker.compare(mp.ranks(got, "pp/gpt2/pp2-dp4-gpipe")[0], want)
    fault = worker.compare(
        mp.ranks(got, "pp/gpt2/pp2-dp4-gpipe/norm-pp-times")[0], want)
    assert sound["mu"] < MOMENT_REL < fault["mu"]


def test_checkpoint_is_schedule_agnostic(runs):
    got, _ = runs
    for r in mp.ranks(got, "pp-ckpt/gpt2/pp2-dp4"):
        assert all(r["to_1f1b"].values()) and all(r["to_gpipe"].values())
        assert r["step_1f1b"] == r["count_1f1b"] == 2
        assert r["step_gpipe"] == 3
        assert r["layers_gpipe"] != r["layers_1f1b"]
        assert r["canonical_round_trip"]
        assert len(r["other_split"]) == 2
        assert all("restore_resharded" in m for m in r["other_split"])
        assert r["resharded"]


def test_interleaved_evaluate_equals_gpipe(runs):
    got, _ = runs
    for r in mp.ranks(got, "pp-ckpt/gpt2/pp2-dp4"):
        assert r["eval_1f1b"] == pytest.approx(r["eval_gpipe"], rel=1e-5)


def test_pipeline_apply_matches_sequential(runs):
    got, _ = runs
    for r in mp.ranks(got, "pp-apply/pp4-dp2"):
        assert r["out"] < 1e-6 and r["dx"] < 1e-5
        assert r["dw"] < 1e-5 and r["db"] < 1e-5 and r["ref_scale"] > 1e-3


def test_benchmark_reports_the_reference_keys(runs):
    """PipelineLMTrainer.benchmark's keys are the reference's (its MFU
    from the whole model's parameters) and its bubble the schedule's."""
    got, _ = runs
    r = mp.ranks(got, "pp-bench/gpt2/pp2-dp4-1f1b2")[0]
    assert set(REFERENCE_KEYS) <= set(r["keys"]), r["keys"]
    assert r["bubble"] == simulate_1f1b(2, 4, 2).bubble_fraction
    assert r["flops_per_step"] == WHOLE_MODEL_FLOPS
