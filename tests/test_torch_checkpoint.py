"""The port's checkpoints (train/checkpoint.py, on torch.distributed.
checkpoint) against the semantics of the JAX package's
(tests/test_checkpoint.py, tests/test_resilience.py's storage tests),
on the CPU at gpt2-test size in f32.

What the port must keep: a round trip restores step, parameters, both
moments and the update count exactly, INTO the live flat buffer the
model's parameters view (nothing rebound); the latest pick is the
largest committed step; a step without DCP's `.metadata`, or one being
written under its tmp name, is not a checkpoint; a corrupted newest
step falls back to the previous one with a warning; gc keeps the newest
`keep_last`; the periodic saver writes without blocking and bounds
retention; maybe_save skips a step it already wrote until
reset_saved_state; and a save that returned at step N restores step N's
values however the state was updated in place afterwards. Values are
compared bit for bit: a checkpoint is a copy, not a computation.
"""
import os
import types

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models.transformer import gpt2_config
from mpi_operator_tpu_torch.train import checkpoint as ck
from mpi_operator_tpu_torch.train.lm_trainer import (
    AdamWState, LMTrainer, LMTrainerConfig, LMTrainState)
from mpi_operator_tpu_torch.train.resilience import corrupt_latest_checkpoint

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

V, S, B = 64, 16, 2


@pytest.fixture(autouse=True)
def _fresh_saved_state():
    yield
    ck.reset_saved_state()


def _ckpt_state(step: int, value: float, n: int = 4) -> LMTrainState:
    """A model-free LMTrainState: checkpoints hold step, params and the
    optimizer state, so the storage layer needs no model."""
    params = torch.full((n,), value, dtype=torch.float32)
    opt = AdamWState(torch.tensor(step, dtype=torch.int32),
                     torch.full((n,), value / 2), torch.full((n,), value / 4))
    return LMTrainState(params=params, opt=opt, model=None, step=step,
                        nonfinite_streak=torch.zeros((), dtype=torch.int32))


def _trainer():
    cfg = gpt2_config("test", attention="dense", dtype=torch.float32,
                      vocab_size=V, max_len=32)
    return LMTrainer(cfg, LMTrainerConfig(global_batch_size=B, seq_len=S,
                                          warmup_steps=1, log_every=2),
                     device="cpu")


def _batch(seed=1):
    toks = np.random.RandomState(seed).randint(0, V, (B, S + 1))
    return torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])


def _assert_same(a: LMTrainState, b: LMTrainState):
    assert a.step == b.step
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.opt.mu, b.opt.mu)
    assert torch.equal(a.opt.nu, b.opt.nu)
    assert torch.equal(a.opt.count, b.opt.count)


def test_save_restore_round_trip_into_the_live_buffer(tmp_path):
    tr = _trainer()
    state = tr.init_state(0)
    for _ in range(2):
        state, _ = tr.train_step(state, *_batch())
    ck.save_checkpoint(tmp_path, state)
    assert ck.last_save_info()["threads"] == ck.WRITER_THREADS
    assert ck.last_save_info()["bytes"] == 3 * state.params.numel() * 4 + 4

    fresh = tr.init_state(7)
    flat, mu = fresh.params, fresh.opt.mu
    views = {n: p for n, p in fresh.model.named_parameters()}
    got = ck.restore_checkpoint(str(tmp_path), fresh)
    assert got is fresh and got.params is flat and got.opt.mu is mu
    _assert_same(state, got)
    # the model trains the restored values: its parameters still view
    # the flat buffer the restore copied into
    for name, p in fresh.model.named_parameters():
        assert p is views[name]
        assert p.data_ptr() >= flat.data_ptr()
        assert torch.equal(p, state.model.get_parameter(name))


def test_resume_continues_training(tmp_path):
    """Train 2 steps -> checkpoint -> restore into a fresh state: the
    third step from the restored state equals the third step of the
    uninterrupted run."""
    tr = _trainer()
    state = tr.init_state(0)
    for _ in range(2):
        state, _ = tr.train_step(state, *_batch())
    ck.save_checkpoint(tmp_path, state)
    state, m = tr.train_step(state, *_batch())

    resumed = ck.restore_checkpoint(str(tmp_path), tr.init_state(3))
    assert resumed.step == 2
    resumed, m2 = tr.train_step(resumed, *_batch())
    assert resumed.step == 3 and torch.equal(m["loss"], m2["loss"])
    _assert_same(state, resumed)


def test_latest_checkpoint_picks_max_step(tmp_path):
    for step in (1, 10, 2):
        ck.save_checkpoint(tmp_path, _ckpt_state(step, float(step)),
                           step=step)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_10")
    assert ck.checkpoint_steps(str(tmp_path)) == [1, 2, 10]


def test_restore_missing_dir_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore_checkpoint(str(tmp_path / "empty"), _ckpt_state(0, 0.0))


def test_verify_rejects_missing_metadata_and_uncommitted_names(tmp_path):
    ck.save_checkpoint(tmp_path, _ckpt_state(1, 1.0), step=1)
    path2 = ck.save_checkpoint(tmp_path, _ckpt_state(2, 2.0), step=2)
    assert ck.verify_checkpoint(path2)
    os.remove(os.path.join(path2, ".metadata"))          # torn write
    assert not ck.verify_checkpoint(path2)
    # latest skips the torn candidate and falls back a step
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_1")
    # an in-flight write lives under its tmp name: never a step
    tmp = tmp_path / "step_9.tmp-123"
    tmp.mkdir()
    (tmp / ".metadata").write_bytes(b"")
    assert not ck.verify_checkpoint(str(tmp))
    assert ck.checkpoint_steps(str(tmp_path)) == [1, 2]


def test_corrupted_newest_falls_back_with_warning(tmp_path):
    ck.save_checkpoint(tmp_path, _ckpt_state(1, 1.0), step=1)
    ck.save_checkpoint(tmp_path, _ckpt_state(2, 2.0), step=2)
    corrupted = corrupt_latest_checkpoint(str(tmp_path))
    assert corrupted.endswith("step_2")
    # the scribbled directory still LOOKS committed — only the restore
    # itself can catch it
    assert ck.verify_checkpoint(corrupted)
    logs = []
    restored, path = ck.restore_with_fallback(
        str(tmp_path), _ckpt_state(0, 0.0), logs.append)
    assert path.endswith("step_1") and restored.step == 1
    _assert_same(_ckpt_state(1, 1.0), restored)
    assert any("WARNING" in line and "step_2" in line for line in logs)

    logs2 = []
    resumed = ck.maybe_resume(str(tmp_path), _ckpt_state(0, 0.0),
                              logs2.append)
    assert resumed.step == 1
    assert any("resumed from" in line for line in logs2)


def test_nothing_restorable_leaves_the_state_untouched(tmp_path):
    ck.save_checkpoint(tmp_path, _ckpt_state(1, 1.0), step=1)
    corrupt_latest_checkpoint(str(tmp_path))
    state = _ckpt_state(5, 5.0)
    got, path = ck.restore_with_fallback(str(tmp_path), state,
                                         lambda s: None)
    assert path is None and got is state
    _assert_same(_ckpt_state(5, 5.0), got)


def test_gc_checkpoints_keep_last(tmp_path):
    for n in range(1, 6):
        ck.save_checkpoint(tmp_path, _ckpt_state(n, float(n)), step=n)
    assert ck.gc_checkpoints(str(tmp_path), keep_last=0) == []   # disabled
    logs = []
    assert ck.gc_checkpoints(str(tmp_path), 2, logs.append) == [1, 2, 3]
    assert ck.checkpoint_steps(str(tmp_path)) == [4, 5]
    assert any("checkpoint gc" in line for line in logs)
    assert ck.gc_checkpoints(str(tmp_path), 2) == []             # idempotent


def test_periodic_saver_gc_bounds_retention(tmp_path):
    logs = []
    hook = ck.periodic_saver(str(tmp_path), every=1, log=logs.append,
                             keep_last=2)
    for n in range(1, 5):
        hook(_ckpt_state(n, float(n)), n)
    ck.wait_for_checkpoints()
    steps = ck.checkpoint_steps(str(tmp_path))
    assert 1 not in steps                       # oldest collected
    assert steps[-2:] == [3, 4]                 # newest retained
    assert len(steps) <= 3                      # keep_last + in-flight
    assert ck.periodic_saver(None, 2) is None
    assert ck.periodic_saver(str(tmp_path), 0) is None


def test_maybe_save_skip_and_reset(tmp_path):
    logs = []
    ck.maybe_save(str(tmp_path), _ckpt_state(3, 1.0), logs.append)
    assert any("written to" in line for line in logs)
    logs.clear()
    ck.maybe_save(str(tmp_path), _ckpt_state(3, 1.0), logs.append)
    assert any("already written" in line for line in logs)   # no rewrite
    ck.reset_saved_state()
    logs.clear()
    ck.maybe_save(str(tmp_path), _ckpt_state(3, 1.0), logs.append)
    assert any("written to" in line for line in logs)        # forgotten
    ck.maybe_save(None, _ckpt_state(3, 1.0), logs.append)    # no train_dir


def test_periodic_async_checkpointing_in_the_benchmark(tmp_path):
    """periodic_saver fires non-blocking checkpoints every 2 timed steps
    of the benchmark loop (warmup excluded); a mid-run checkpoint
    restores with its step; the final maybe_save skips a step the hook
    already committed."""
    tr = _trainer()
    state = tr.init_state(0)

    class Stream:
        def __iter__(self):
            return self

        def __next__(self):
            return _batch()

    hook = ck.periodic_saver(str(tmp_path), every=2, log=lambda s: None)
    state, _ = tr.benchmark(state, Stream(), num_steps=6, warmup_steps=1,
                            log=lambda s: None, step_hook=hook)
    ck.wait_for_checkpoints()
    assert ck.checkpoint_steps(str(tmp_path)) == [2, 4, 6]
    mid = ck.restore_checkpoint(str(tmp_path / "step_4"), tr.init_state(0))
    assert mid.step == 4 and int(mid.opt.count) == 4
    logs = []
    ck.maybe_save(str(tmp_path), state, log=logs.append)     # step 7
    assert "step_7" in logs[-1] and "already" not in logs[-1]
    ck.maybe_save(str(tmp_path), state, log=logs.append)
    assert "already written" in logs[-1]


def test_nonblocking_saves_gc_and_restore_exact(tmp_path):
    """Back-to-back non-blocking firings with keep_last=1 never delete
    the newest committed checkpoint under the in-flight write; every
    surviving step_N is intact and restores bit-identical."""
    hook = ck.periodic_saver(str(tmp_path), every=1, log=lambda s: None,
                             keep_last=1)
    for step in range(1, 6):
        hook(_ckpt_state(step, float(step)), step)
    ck.wait_for_checkpoints()
    # gc runs BEFORE each dispatch, so the previous step survives
    assert ck.checkpoint_steps(str(tmp_path)) == [4, 5]
    for s in (4, 5):
        assert ck.verify_checkpoint(str(tmp_path / f"step_{s}"))
    got = ck.restore_checkpoint(str(tmp_path / "step_5"),
                                _ckpt_state(0, 0.0))
    _assert_same(_ckpt_state(5, 5.0), got)
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]

    ck.maybe_save(str(tmp_path), _ckpt_state(9, 9.0), log=lambda s: None,
                  block=False)
    ck.wait_for_checkpoints()
    back = ck.restore_checkpoint(str(tmp_path / "step_9"),
                                 _ckpt_state(0, 0.0))
    _assert_same(_ckpt_state(9, 9.0), back)


def test_async_save_then_in_place_steps_restores_step_n(tmp_path):
    """The trainer updates its state in place. A non-blocking save at
    step N, followed at once by more in-place steps, must restore step
    N's values exactly — the snapshot is taken before the save returns."""
    tr = _trainer()
    state = tr.init_state(0)
    for _ in range(2):
        state, _ = tr.train_step(state, *_batch())
    want = {"params": state.params.clone(), "mu": state.opt.mu.clone(),
            "nu": state.opt.nu.clone(), "count": state.opt.count.clone()}
    ck.save_checkpoint(tmp_path, state, block=False)
    for seed in range(3):                       # in place, under the write
        state, _ = tr.train_step(state, *_batch(seed + 5))
    assert not torch.equal(state.params, want["params"])
    ck.wait_for_checkpoints()
    got = ck.restore_checkpoint(str(tmp_path / "step_2"), tr.init_state(1))
    assert got.step == 2
    assert torch.equal(got.params, want["params"])
    assert torch.equal(got.opt.mu, want["mu"])
    assert torch.equal(got.opt.nu, want["nu"])
    assert torch.equal(got.opt.count, want["count"])


def test_resharding_restore_raises(tmp_path, monkeypatch):
    """The resharding restore is ported: maybe_resume(reshard=True) and
    TPU_RESHARD_RESTORE=1 restore through restore_resharded (an empty
    directory is still a no-op); what the reader cannot restore raises:
    a state it does not know, another model's checkpoint."""
    tr = _trainer()
    state, _ = tr.train_step(tr.init_state(0), *_batch())
    assert ck.maybe_resume(str(tmp_path), _ckpt_state(0, 0.0),
                           reshard=True).step == 0
    ck.save_checkpoint(tmp_path, state)
    got = ck.maybe_resume(str(tmp_path), tr.init_state(1), reshard=True)
    _assert_same(got, state)
    assert ck.last_restore_info()["resharded"] is True
    monkeypatch.setenv(ck.ENV_RESHARD_RESTORE, "1")
    _assert_same(ck.maybe_resume(str(tmp_path), tr.init_state(1)), state)
    assert ck.last_restore_info()["resharded"] is True
    with pytest.raises(TypeError, match="restores the LM trainers"):
        ck.restore_resharded(str(tmp_path), types.SimpleNamespace(step=0))
    other = LMTrainer(gpt2_config("test", attention="dense",
                                  dtype=torch.float32, vocab_size=2 * V,
                                  max_len=32),
                      LMTrainerConfig(global_batch_size=B, seq_len=S),
                      device="cpu")
    with pytest.raises(ValueError):
        ck.restore_resharded(str(tmp_path), other.init_state(0))
