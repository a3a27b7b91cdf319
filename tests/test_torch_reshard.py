"""The port's resharding restore (train/checkpoint.py restore_resharded)
against the patterns of tests/test_reshard.py, on the port's states.

- One 4-rank gloo gang (tests/torch_mp_worker.py `reshard_leg`): gpt2
  (test size, f32) trained two steps at (fsdp, tp) = (2, 2) and saved;
  restored bit-equal (global params, mu, nu and the step) at fsdp 4,
  then from that checkpoint at tp 4, as a replica over 4 ranks, at (2,
  2) again, at fsdp 2 on 2 ranks and as one process: every split, world
  4 -> 2 -> 1. A pipeline state at pp 2 restored at pp 4, at (pp, tp) =
  (2, 2) and into a flat replica. A corrupt newest checkpoint falls back
  to the previous step across a reshard; the planted fault (one rank's
  slice cut at the wrong offset) breaks the bit-equality.
- In one process: the regex restore rules (the first hit wins, None
  replicates), the memory pin (peak in-flight bytes at one saved tensor
  with max_workers=1), a shape mismatch raising, and the INFO restore
  line with `resharded` in last_restore_info().
"""
import importlib
import os

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

import torch_mp_worker as worker  # noqa: E402

tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
ck = importlib.import_module("mpi_operator_tpu_torch.train.checkpoint")
tmesh = importlib.import_module("mpi_operator_tpu_torch.parallel.mesh")

V = worker.VOCAB
LEG = "reshard/fsdp2-tp2"


@pytest.fixture(scope="module")
def gang_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    return worker.gang(4, str(tmp / "r"), [LEG])


@pytest.mark.parametrize("label", [label for label, _ in
                                   worker.RESHARD_CHAIN])
def test_reshard_restore_bitwise_across_splits(gang_run, label):
    sizes = dict(worker.RESHARD_CHAIN)[label]
    members = tmesh.MeshConfig(**sizes).num_devices
    ranks = [r[LEG] for r in gang_run[:members]]
    assert all(r["checks"][label] for r in ranks)
    for r in ranks:
        st = r["stats"][label]
        assert 0 < st["peak_in_flight_bytes"] <= st["bytes_read"]
        assert st["bytes_read"] <= st["total_bytes"]


@pytest.mark.parametrize("label", ["pp4", "pp2-tp2", "pp-to-flat"])
def test_pipeline_state_reshards_across_pp(gang_run, label):
    members = 1 if label == "pp-to-flat" else 4
    assert all(r[LEG]["checks"][label] for r in gang_run[:members])


def test_the_wrong_offset_fault_breaks_the_restore(gang_run):
    """Rank 1 restores its neighbour's fsdp slice: its buffers differ
    from the oracle's; the other ranks' hold."""
    checks = [r[LEG]["checks"]["fault"] for r in gang_run]
    assert checks == [True, False, True, True]


def test_corrupt_newest_falls_back_across_reshard(gang_run):
    for r in gang_run:
        leg = r[LEG]
        assert leg["checks"]["fallback"]
        assert leg["restore_info"]["resharded"] is True
        logs = leg["logs"]
        assert any("WARNING" in line and "step_2" in line for line in logs)
        assert any("INFO: restored" in line and "step_1" in line
                   and line.rstrip().endswith("leaves)") for line in logs)
    assert gang_run[0][LEG]["corrupted"].endswith("step_2")


def _cfg(**kw):
    return tt.gpt2_config("test", attention="dense", dtype=torch.float32,
                          vocab_size=kw.pop("vocab_size", V), max_len=32,
                          **kw)


def _trained(tmp_path, steps=1, **kw):
    tr = ttr.LMTrainer(_cfg(**kw), ttr.LMTrainerConfig(
        global_batch_size=4, seq_len=16, warmup_steps=2), device="cpu")
    state = tr.init_state(0)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        toks = torch.randint(0, V, (4, 17), generator=g)
        state, _ = tr.train_step(state, toks[:, :-1], toks[:, 1:])
    ck.reset_saved_state()
    return tr, state, ck.save_checkpoint(str(tmp_path), state)


def test_reshard_restore_rules_override(tmp_path):
    """A dict target on a (dp, tp) = (2, 2) mesh (this process at its
    first coordinates): a rule puts the token table over tp by rows, a
    None rule replicates a bias, the first hit wins, an unmatched key
    lands whole."""
    tr, state, path = _trained(tmp_path)
    named = state.named_params()
    mesh = tmesh.Mesh(tmesh.MeshConfig(dp=2, tp=2), range(4))
    E = named["wte.weight"].shape[1]
    target = {"params/wte.weight": torch.zeros(V // 2, E),
              "params/backbone.blocks.0.ln_1.bias": torch.zeros(E),
              "params/wpe.weight": torch.zeros_like(named["wpe.weight"])}
    rules = [(("params", "wte", "weight"), ("tp", None)),
             (("params", ".*", "bias"), None),
             (("wte",), None)]                  # never reached: first wins
    ck.restore_resharded(path, target, rules=rules, mesh=mesh,
                         model_config=tr.model_config)
    assert torch.equal(target["params/wte.weight"],
                       named["wte.weight"][:V // 2])
    assert torch.equal(target["params/backbone.blocks.0.ln_1.bias"],
                       named["backbone.blocks.0.ln_1.bias"])
    assert torch.equal(target["params/wpe.weight"], named["wpe.weight"])
    # a target must hold the block its rule gives
    with pytest.raises(ValueError, match="block"):
        ck.restore_resharded(path, {"params/wte.weight": torch.zeros(V, E)},
                             rules=rules, mesh=mesh,
                             model_config=tr.model_config)


def test_reshard_restore_memory_pin(tmp_path):
    """With max_workers=1 at most one saved tensor is held at a time:
    the peak is one buffer's bytes, under the whole checkpoint's."""
    tr, state, path = _trained(tmp_path)
    stats = ck.ReadStats()
    target = tr.init_state(3)
    ck.restore_resharded(path, target, max_workers=1, stats=stats)
    assert torch.equal(target.params, state.params)
    assert torch.equal(target.opt.nu, state.opt.nu)
    assert target.step == 1 and int(target.opt.count) == 1
    one = state.params.numel() * 4
    assert stats.reads == 3 and stats.total_bytes == 3 * one
    assert 0 < stats.peak_in_flight_bytes <= one < stats.total_bytes
    assert stats.leaves == 5 and stats.seconds > 0


def test_restore_resharded_shape_mismatch_raises(tmp_path):
    _trained(tmp_path)
    other = ttr.LMTrainer(_cfg(vocab_size=128), ttr.LMTrainerConfig(
        global_batch_size=4, seq_len=16), device="cpu")
    with pytest.raises(ValueError):
        ck.restore_resharded(str(tmp_path), other.init_state(0))


def test_maybe_resume_reshards_and_logs_the_info_line(tmp_path,
                                                      monkeypatch):
    """TPU_RESHARD_RESTORE=1 routes maybe_resume through the reader:
    one INFO line with the wall time and the leaves, and
    last_restore_info() says resharded with the bytes read."""
    tr, state, _ = _trained(tmp_path, steps=2)
    monkeypatch.setenv(ck.ENV_RESHARD_RESTORE, "1")
    logs = []
    got = ck.maybe_resume(str(tmp_path), tr.init_state(3), logs.append)
    assert got.step == 2 and torch.equal(got.params, state.params)
    info = [line for line in logs if line.startswith("INFO: restored")]
    assert len(info) == 1 and info[0].rstrip().endswith("(5 leaves)")
    last = ck.last_restore_info()
    assert last["resharded"] is True and last["bytes_read"] > 0
    monkeypatch.delenv(ck.ENV_RESHARD_RESTORE)
    ck.maybe_resume(str(tmp_path), tr.init_state(3), logs.append)
    assert ck.last_restore_info()["resharded"] is False


def teardown_module(module):
    ck.wait_for_checkpoints()
