"""Pipelines composed with BERT's masked objective and with sequence
parallelism on the CPU: one gang of 8 gloo ranks (tests/torch_mp_worker.py
through launch.py and the bootstrap), each leg over its own mesh of the
same processes, against the JAX PipelineLMTrainer on the same mesh of
the conftest's 8 virtual devices and against one process's LMTrainer.

3 AdamW steps, global batch 16 x 16 in M = 4 microbatches, f32, the flax
weights converted (4 layers of the test widths, vocab 96):

- bert at (pp, dp) = (2, 4) under GPipe and under 1F1B x 2: the mask
  stream on the last stage, the global mask count as the denominator
  (H33);
- gpt2 at (pp, sp, dp) = (2, 2, 2) under GPipe and under 1F1B, each
  stage body ringing its attention over sp from positions sp_rank x
  S / sp (H29), the loss and gradients summed over sp.
"""
import os
import sys

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_pp_parity as pp  # noqa: E402

LEGS = ("pp/bert/pp2-dp4-gpipe", "pp/bert/pp2-dp4-1f1b2",
        "pp/gpt2/pp2-sp2-dp2-gpipe", "pp/gpt2/pp2-sp2-dp2-1f1b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return pp.run_gang(tmp_path_factory.mktemp("ppc"), LEGS)


@pytest.mark.parametrize("name", LEGS)
def test_gang_equals_one_process(runs, name):
    got, weights = runs
    pp.check_against_one_process(got, name, weights)


@pytest.mark.parametrize("name", LEGS)
def test_gang_equals_the_jax_pipeline_trainer_on_the_same_mesh(runs, name):
    got, weights = runs
    pp.check_against_jax(got, name, weights)
