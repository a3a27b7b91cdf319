"""Checkpoints and the token pipeline with the state on the card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py

Without a card every test here skips: what they hold is the card's own
path — the device clone a save takes in stream order, the writer
thread's copy to pinned host memory on its own stream, the restore's
copy back into the live device buffers, and the consumer-stream copy of
pinned batches. The CPU tests (test_torch_checkpoint.py,
test_torch_data.py) hold the same semantics on the CPU.
"""
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.data import tokenstream as tts
from mpi_operator_tpu_torch.models.transformer import gpt2_config
from mpi_operator_tpu_torch.train import checkpoint as ck
from mpi_operator_tpu_torch.train.lm_trainer import LMTrainer, LMTrainerConfig

V, S, B = 256, 64, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device snapshot and the "
                    "pinned-memory copies have no CPU mode (the CPU path is "
                    "tested in test_torch_checkpoint.py)")
    yield torch.device("cuda")
    ck.reset_saved_state()


def _trainer(dev):
    cfg = gpt2_config("test", attention="dense", dtype=torch.float32,
                      vocab_size=V, max_len=S)
    return LMTrainer(cfg, LMTrainerConfig(global_batch_size=B, seq_len=S,
                                          warmup_steps=1), device=dev)


def _batch(dev, seed):
    toks = np.random.RandomState(seed).randint(0, V, (B, S + 1))
    t = torch.from_numpy(toks).to(dev)
    return t[:, :-1], t[:, 1:]


def _snapshot(state):
    return [state.params.clone(), state.opt.mu.clone(), state.opt.nu.clone(),
            state.opt.count.clone()]


def _tensors(state):
    return [state.params, state.opt.mu, state.opt.nu, state.opt.count]


@pytest.mark.cuda
def test_card_state_round_trip_is_bit_equal(cuda_device, tmp_path):
    tr = _trainer(cuda_device)
    state = tr.init_state(0)
    for seed in range(3):
        state, _ = tr.train_step(state, *_batch(cuda_device, seed))
    want = _snapshot(state)
    ck.save_checkpoint(tmp_path, state)
    fresh = tr.init_state(5)
    ptrs = [t.data_ptr() for t in _tensors(fresh)]
    got = ck.restore_checkpoint(str(tmp_path), fresh)
    assert got.step == 3
    assert [t.data_ptr() for t in _tensors(got)] == ptrs   # copied in
    for a, b in zip(want, _tensors(got)):
        assert a.device.type == b.device.type == "cuda"
        assert torch.equal(a, b)
    # the model's parameter views see the restored values
    for p in got.model.parameters():
        off = (p.data_ptr() - got.params.data_ptr()) // 4
        assert 0 <= off <= got.params.numel() - p.numel()
        assert torch.equal(p.reshape(-1), want[0][off:off + p.numel()])


@pytest.mark.cuda
def test_async_save_then_in_place_steps_restores_step_n(cuda_device,
                                                        tmp_path):
    """The save returns after a stream-ordered device clone; the steps
    queued right after it update the state in place while the writer
    thread copies the clone out. The checkpoint holds step N."""
    tr = _trainer(cuda_device)
    state = tr.init_state(0)
    for seed in range(2):
        state, _ = tr.train_step(state, *_batch(cuda_device, seed))
    want = _snapshot(state)
    ck.save_checkpoint(tmp_path, state, block=False)
    for seed in range(2, 6):
        state, _ = tr.train_step(state, *_batch(cuda_device, seed))
    assert not torch.equal(state.params, want[0])
    ck.wait_for_checkpoints()
    info = ck.last_save_info()
    assert info["bytes"] == sum(t.numel() * t.element_size() for t in want)
    got = ck.restore_checkpoint(str(tmp_path / "step_2"), tr.init_state(9))
    assert got.step == 2
    for a, b in zip(want, _tensors(got)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_token_batches_land_on_the_card_equal_to_the_host_windows(
        cuda_device, tmp_path):
    rs = np.random.RandomState(0)
    for i in range(3):
        tts.write_token_shard(str(tmp_path), f"s{i}",
                              rs.randint(0, V, 700 + 90 * i).astype(np.int32))
    host = tts.NpyTokenDataset(str(tmp_path), B, S, device="cpu", seed=4,
                               vocab_size=V)
    card = tts.NpyTokenDataset(str(tmp_path), B, S, device=cuda_device,
                               seed=4, vocab_size=V)
    try:
        for _ in range(20):
            (ht, hg), (ct, cg) = next(host), next(card)
            assert ct.device.type == "cuda" and ct.dtype == torch.int64
            # a kernel on the default stream reads the batch right away:
            # the copy was queued on this stream, so it has landed
            assert torch.equal((ct * 1).cpu(), ht)
            assert torch.equal((cg * 1).cpu(), hg)
    finally:
        host.close()
        card.close()
