"""The port's HFTA fused trainer (train/hfta.py) against the JAX package's
HFTATrainer, and the patterns of tests/test_hfta.py against the port's
own trainers, on the CPU in f32.

- K = 3 with per-replica learning rates, weight decays, warmups and
  seeds, from the same perturbed flax weights (stacked on the JAX side,
  sliced out by `params_from_hfta` on the port's) and the same numpy
  batches: each replica's loss, update, mu and nu within the
  model-parallel parity limits (tests/torch_mp_parity.py: update 1e-4
  relative, moments 1e-5 relative, loss 1e-5 absolute).
- The pins: fused K = 1 is the port's LMTrainer bit for bit; K identical
  replicas give K identical curves; a poisoned replica freezes while its
  siblings stay bit-equal to an unpoisoned run (and the planted
  whole-state select breaks that); vmap(flash_attention) equals the loop
  of calls bit for bit, forward and gradients.
- A 2-rank gloo gang (tests/torch_mp_worker.py): K = 2 slice-shared (no
  all-reduce in the step) and K = 3 with the rows shared, against one
  process.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

import torch_mp_worker as worker  # noqa: E402
from torch_mp_parity import LOSS_ATOL, MOMENT_REL, UPDATE_REL  # noqa: E402
from torch_parity import perturbed_params  # noqa: E402

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jhf = importlib.import_module("mpi_operator_tpu.train.hfta")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
hfta = importlib.import_module("mpi_operator_tpu_torch.train.hfta")
ck = importlib.import_module("mpi_operator_tpu_torch.train.checkpoint")
res = importlib.import_module("mpi_operator_tpu_torch.train.resilience")
ops = importlib.import_module("mpi_operator_tpu_torch.ops.attention")
tel = importlib.import_module("mpi_operator_tpu_torch.telemetry")
tmesh = importlib.import_module("mpi_operator_tpu_torch.parallel.mesh")

V, B, S = 96, 4, 16
LRS, WDS, WARMUPS, SEEDS = (1e-3, 2e-3, 5e-4), (0.0, 0.01, 0.1), (1, 2, 3), \
    (0, 1, 2)


def _cfg(**kw):
    return tt.gpt2_config("test", attention="dense", dtype=torch.float32,
                          vocab_size=V, max_len=32, **kw)


def _tcfg(**kw):
    return ttr.LMTrainerConfig(global_batch_size=B, seq_len=S,
                               warmup_steps=2, **kw)


def _fused(i, k, seed=1):
    """The step-i fused batch: K different [B, S] token rows."""
    rs = np.random.RandomState(seed * 1000 + i)
    toks = rs.randint(0, V, (k, B, S + 1))
    return toks[..., :-1], toks[..., 1:]


def _stacked(i, k):
    """K identical copies of one step-i batch."""
    toks, tgts = _fused(i, 1)
    return np.repeat(toks, k, 0), np.repeat(tgts, k, 0)


def _rel(a, b):
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def _jax_state_dicts(tcfg_port, tree):
    """The port's K state dicts of a stacked flax tree."""
    return convert.params_from_hfta(tcfg_port, jax.tree.map(np.asarray,
                                                            tree))


@pytest.fixture(scope="module")
def jax_k3():
    """The JAX HFTATrainer at K = 3 on one device, from three perturbed
    flax inits stacked, three steps on the fused numpy batches: the
    start, the per-replica losses and the final params, mu, nu."""
    jcfg = jt.gpt2_config("test", attention="dense", dtype=jnp.float32,
                          vocab_size=V, max_len=32)
    jm = jt.CausalLM(jcfg)
    trees = [perturbed_params(jm, seed=s) for s in SEEDS]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=1), devices=jax.devices()[:1])
    tcfg = jtr.LMTrainerConfig(global_batch_size=B, seq_len=S,
                               warmup_steps=2)
    hp = jhf.HFTAHyperparams.sweep(3, tcfg, learning_rates=LRS, seeds=SEEDS,
                                   weight_decays=WDS, warmup_steps=WARMUPS)
    tr = jhf.HFTATrainer(jm, mesh, tcfg, hp)
    state = tr.init_state()
    state = state.replace(params=jax.tree.map(
        lambda ref, x: jax.device_put(jnp.asarray(x), ref.sharding),
        state.params, stacked))
    losses = []
    for i in range(3):
        toks, tgts = _fused(i, 3)
        state, m = tr.train_step(state, jnp.asarray(toks, jnp.int32),
                                 jnp.asarray(tgts, jnp.int32))
        losses.append(np.asarray(m["loss"]))
    adam = state.opt_state[1]
    return {"start": stacked, "losses": np.stack(losses),
            "params": state.params, "mu": adam.mu, "nu": adam.nu}


def _port_flat(cfg, tree):
    """[K, N] flat buffers of a stacked flax tree, param_shapes order."""
    return torch.stack([torch.cat([d[n].reshape(-1)
                                   for n in tt.param_shapes(cfg)])
                        for d in _jax_state_dicts(cfg, tree)])


def test_k3_matches_the_jax_hfta_trainer(jax_k3):
    cfg, tcfg = _cfg(), _tcfg()
    hp = hfta.HFTAHyperparams.sweep(3, tcfg, learning_rates=LRS, seeds=SEEDS,
                                    weight_decays=WDS, warmup_steps=WARMUPS)
    tr = hfta.HFTATrainer(cfg, tcfg, hp, device="cpu")
    state = tr.init_state(_jax_state_dicts(cfg, jax_k3["start"]))
    start = state.params.clone()
    losses = []
    for i in range(3):
        state, m = tr.train_step(state, *_fused(i, 3))
        losses.append(m["loss"].numpy())
    np.testing.assert_allclose(np.stack(losses), jax_k3["losses"],
                               atol=LOSS_ATOL, rtol=0)
    want = {k: _port_flat(cfg, jax_k3[k]) for k in ("params", "mu", "nu")}
    wstart = _port_flat(cfg, jax_k3["start"])
    assert torch.equal(start, wstart)
    for k in range(3):
        assert _rel(state.params[k] - start[k],
                    want["params"][k] - wstart[k]) < UPDATE_REL, k
        assert _rel(state.opt.mu[k], want["mu"][k]) < MOMENT_REL, k
        assert _rel(state.opt.nu[k], want["nu"][k]) < MOMENT_REL, k
    assert state.opt.count.tolist() == [3, 3, 3] and state.step == 3


def test_params_from_hfta_slices_each_replica(jax_k3):
    cfg = _cfg()
    dicts = _jax_state_dicts(cfg, jax_k3["start"])
    assert len(dicts) == 3
    one = convert.params_from_flax(cfg, jax.tree.map(
        lambda x: np.asarray(x)[1], jax_k3["start"]))
    assert all(torch.equal(dicts[1][n], one[n]) for n in one)


def test_k1_fused_bitwise_matches_solo_lm_trainer():
    """Fused K = 1 squeezes: loss, params, mu and nu equal the solo
    LMTrainer's bit for bit, step after step (the warmup crossover at
    step 2 included)."""
    cfg, tcfg = _cfg(), _tcfg()
    solo = ttr.LMTrainer(cfg, tcfg, device="cpu")
    fused = hfta.HFTATrainer(cfg, tcfg, hfta.HFTAHyperparams.sweep(1, tcfg),
                             device="cpu")
    s, f = solo.init_state(0), fused.init_state()
    assert torch.equal(s.params, f.params[0])
    for i in range(4):
        toks, tgts = _fused(i, 1)
        s, sm = solo.train_step(s, toks[0], tgts[0])
        f, fm = fused.train_step(f, toks, tgts)
        assert float(fm["loss"][0]) == float(sm["loss"]), i
    assert torch.equal(s.params, f.params[0])
    assert torch.equal(s.opt.mu, f.opt.mu[0])
    assert torch.equal(s.opt.nu, f.opt.nu[0])


def test_k3_identical_hparams_identical_curves():
    tr = hfta.HFTATrainer(_cfg(), _tcfg(), hfta.HFTAHyperparams.sweep(
        3, _tcfg()), device="cpu")
    state = tr.init_state()
    for i in range(3):
        state, m = tr.train_step(state, *_stacked(i, 3))
        loss = m["loss"].tolist()
        assert loss[0] == loss[1] == loss[2], i
    p = state.params
    assert torch.equal(p[0], p[1]) and torch.equal(p[0], p[2])


def test_sweep_axes_validated_and_broadcast():
    tcfg = ttr.LMTrainerConfig(global_batch_size=8, seq_len=16,
                               learning_rate=3e-4, weight_decay=0.1)
    with pytest.raises(ValueError, match="sweep axis"):
        hfta.HFTAHyperparams.sweep(3, tcfg, learning_rates=[1e-3])
    hp = hfta.HFTAHyperparams.sweep(2, tcfg, learning_rates=[1e-3, 2e-3])
    assert hp.k == 2 and hp.weight_decays == (0.1, 0.1)
    assert hp.seeds == (0, 0)
    cfg1 = hp.replica_config(tcfg, 1)
    assert cfg1.learning_rate == 2e-3 and cfg1.weight_decay == 0.1


@pytest.mark.parametrize("kw,cfg_kw,match", [
    (dict(masked_lm=True), {}, "causal"),
    (dict(accum_steps=2), {}, "accumulation"),
    ({}, dict(tp_overlap=True), "tp_overlap"),
    (dict(fused_xent=True), {}, "fused_xent"),
    ({}, dict(remat=True), "remat"),
    ({}, dict(num_experts=4), "MoE"),
])
def test_unsupported_configs_rejected(kw, cfg_kw, match):
    with pytest.raises(ValueError, match=match):
        hfta.HFTATrainer(_cfg(**cfg_kw), _tcfg(**kw), device="cpu")


def test_model_parallel_meshes_rejected():
    mesh = tmesh.Mesh(tmesh.MeshConfig(tp=2), [0, 1])
    with pytest.raises(ValueError, match="data-parallel mesh only"):
        hfta.HFTATrainer(_cfg(), _tcfg(), device="cpu", mesh=mesh)


def _poison_run(select=None):
    tr = hfta.HFTATrainer(_cfg(), _tcfg(), hfta.HFTAHyperparams.sweep(
        3, _tcfg(), seeds=[0, 1, 2]), freeze_after=2, device="cpu")
    ctrl, fault = tr.init_state(), tr.init_state()
    orig = hfta.select_replicas
    if select is not None:
        hfta.select_replicas = select
    try:
        for i in range(5):
            toks, tgts = _fused(i, 3)
            ctrl, _ = tr.train_step(ctrl, toks, tgts)
            if i == 2:
                fault = hfta.poison_replica(fault, 1)
            fault, fm = tr.train_step(fault, toks, tgts)
    finally:
        hfta.select_replicas = orig
    return ctrl, fault, fm


def test_poisoned_replica_freezes_siblings_bitwise_unaffected():
    ctrl, fault, fm = _poison_run()
    assert fault.step == 5
    assert fault.frozen.tolist() == [False, True, False]
    assert int(fault.nonfinite_streak[1]) >= 2
    for k in (0, 2):
        assert torch.equal(fault.params[k], ctrl.params[k])
        assert torch.equal(fault.opt.mu[k], ctrl.opt.mu[k])
        assert torch.equal(fault.opt.nu[k], ctrl.opt.nu[k])
    assert torch.isnan(fault.params[1]).all()
    loss = fm["loss"].numpy()
    assert np.isnan(loss[1]) and np.isfinite(loss[[0, 2]]).all()


def test_whole_state_select_fault_breaks_isolation():
    """The planted fault: the guard's per-row select made one select of
    the whole state (every row keeps its old values once any row is bad)
    must fail the isolation check."""
    def whole(ok, pairs):
        for old, new in pairs:
            torch.where(ok.all(), new, old, out=old)
    ctrl, fault, _ = _poison_run(whole)
    assert not torch.equal(fault.params[0], ctrl.params[0])


def test_fault_injector_nan_replica_directive():
    faults = res.FaultInjector("nan-replica:1@3")
    assert faults.check_nan_replica(2) is None
    assert faults.check_nan_replica(3) == 1
    assert faults.check_nan_replica(4) is None
    with pytest.raises(ValueError):
        res.FaultInjector("nan-replica:nope")


def _stream(k):
    i = 0
    while True:
        yield _fused(i, k)
        i += 1


def test_benchmark_poisons_through_the_directive(tmp_path):
    """`benchmark` calls check_nan_replica and poison_replica: replica 1
    freezes, one replica_frozen record names it, its siblings train."""
    tcfg = _tcfg(log_every=1)
    tr = hfta.HFTATrainer(_cfg(), tcfg, hfta.HFTAHyperparams.sweep(3, tcfg),
                          freeze_after=2, device="cpu")
    logs = []
    with tel.EventLog(str(tmp_path / "ev.jsonl")) as events:
        state, m = tr.benchmark(tr.init_state(), _stream(3), num_steps=5,
                                warmup_steps=1, log=logs.append,
                                faults=res.FaultInjector("nan-replica:1@2"),
                                events=events)
    assert m["per_replica"]["frozen"] == [False, True, False]
    assert m["frozen_replicas"] == 1
    assert any("NaN into replica 1 at step 2" in line for line in logs)
    recs = tel.read_events(str(tmp_path / "ev.jsonl"))
    frozen = [r for r in recs if r["event"] == "replica_frozen"]
    assert len(frozen) == 1 and frozen[0]["replica"] == "1"


def test_stacked_checkpoint_roundtrip(tmp_path):
    tcfg = _tcfg()
    tr = hfta.HFTATrainer(_cfg(), tcfg, hfta.HFTAHyperparams.sweep(
        2, tcfg, seeds=[0, 7]), device="cpu")
    state = tr.init_state()
    for i in range(2):
        state, _ = tr.train_step(state, *_fused(i, 2))
    ck.save_checkpoint(str(tmp_path), state)
    restored = ck.restore_checkpoint(str(tmp_path), tr.init_state())
    assert restored.step == 2
    for a, b in ((restored.params, state.params),
                 (restored.opt.mu, state.opt.mu),
                 (restored.opt.nu, state.opt.nu),
                 (restored.opt.count, state.opt.count)):
        assert torch.equal(a, b)
    restored, m = tr.train_step(restored, *_fused(2, 2))
    assert np.isfinite(m["loss"].numpy()).all()


def test_export_replica_checkpoint_restores_into_solo_trainer(tmp_path):
    tcfg = _tcfg()
    tr = hfta.HFTATrainer(_cfg(), tcfg, hfta.HFTAHyperparams.sweep(
        2, tcfg, learning_rates=[1e-3, 2e-3], seeds=[0, 7]), device="cpu")
    state = tr.init_state()
    for i in range(2):
        state, _ = tr.train_step(state, *_fused(i, 2))
    tr.export_replica_checkpoint(str(tmp_path), state, 1)
    solo = ttr.LMTrainer(_cfg(), tr.hparams.replica_config(tcfg, 1),
                         device="cpu")
    restored = ck.restore_checkpoint(str(tmp_path), solo.init_state(7))
    assert restored.step == 2
    assert torch.equal(restored.params, state.params[1])
    assert torch.equal(restored.opt.mu, state.opt.mu[1])
    assert int(restored.opt.count) == 2
    toks, tgts = _fused(2, 1)
    restored, m = solo.train_step(restored, toks[0], tgts[0])
    assert np.isfinite(float(m["loss"]))


def test_benchmark_emits_per_replica_labeled_series():
    tcfg = _tcfg(log_every=1)
    tr = hfta.HFTATrainer(_cfg(), tcfg, hfta.HFTAHyperparams.sweep(2, tcfg),
                          device="cpu")
    reg = tel.Registry()
    _, metrics = tr.benchmark(tr.init_state(), _stream(2), num_steps=2,
                              warmup_steps=1, log=lambda s: None,
                              registry=reg, faults=res.FaultInjector(""))
    assert metrics["k"] == 2 and metrics["tokens_per_sec"] > 0
    assert metrics["per_replica"]["goodput"] == [1.0, 1.0]
    assert len(metrics["per_replica"]["tokens_per_sec"]) == 2
    text = tel.render_registry(reg)
    for line in ('tpu_worker_tokens_per_sec{replica="0"}',
                 'tpu_worker_tokens_per_sec{replica="1"}',
                 'tpu_worker_goodput{replica="1"}'):
        assert line in text


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_vmapped_flash_attention_equals_the_loop(causal, masked):
    """vmap(flash_attention) folds the replicas into one call of the
    plain K1-K3 here: forward and the three gradients equal K separate
    calls bit for bit."""
    g = torch.Generator().manual_seed(0)
    K, b, s, h, d = 4, 2, 8, 2, 16
    q, k, v = (torch.randn(K, b, s, h, d, generator=g).requires_grad_()
               for _ in range(3))
    mask = (torch.rand(K, b, s, generator=g) > 0.25).float() if masked \
        else None
    do = torch.randn(K, b, s, h, d, generator=g)
    out = torch.func.vmap(
        lambda a, bb, c, m: ops.flash_attention(a, bb, c, causal, m),
        in_dims=(0, 0, 0, 0 if masked else None))(q, k, v, mask)
    out.backward(do)
    for r in range(K):
        qr, kr, vr = (x[r].detach().clone().requires_grad_()
                      for x in (q, k, v))
        o = ops.flash_attention(qr, kr, vr, causal,
                                None if mask is None else mask[r])
        o.backward(do[r])
        assert torch.equal(o, out[r])
        assert torch.equal(qr.grad, q.grad[r])
        assert torch.equal(kr.grad, k.grad[r])
        assert torch.equal(vr.grad, v.grad[r])


def test_vmapped_flash_forward_folds_into_one_call(monkeypatch):
    calls = []
    real = ops.flash_fwd

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)
    monkeypatch.setattr(ops, "flash_fwd", spy)
    q = torch.randn(3, 2, 8, 2, 16)
    torch.func.vmap(ops.flash_attention)(q, q, q)
    assert calls == [(6, 8, 2, 16)]


@pytest.fixture(scope="module")
def gang_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hfta_gang")
    return worker.gang(2, str(tmp / "r"), ["hfta/dp2-k2", "hfta/dp2-k3"])


@pytest.mark.parametrize("name,sharing", [("hfta/dp2-k2", True),
                                          ("hfta/dp2-k3", False)])
def test_two_rank_gang_matches_one_process(gang_runs, name, sharing):
    """K = 2 over 2 ranks: one replica a rank, no all-reduce in a step;
    K = 3: each rank its rows of every replica, one all-reduce a step;
    both against the same leg in one process."""
    spec = worker.LEGS[name]
    want = worker.hfta_leg(spec, torch.device("cpu"), None)
    ranks = [r[name] for r in gang_runs]
    assert [r["slice_sharing"] for r in ranks] == [sharing] * 2
    # rows shared: the mask counts' and the gradient's all-reduce a step
    assert [r["allreduces"] for r in ranks] == ([0, 0] if sharing
                                                else [6, 6])
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL,
                               rtol=0)
    for k in range(spec["k"]):
        assert _rel(got["params"][k] - want["start"][k],
                    want["params"][k] - want["start"][k]) < UPDATE_REL
        assert _rel(got["mu"][k], want["mu"][k]) < MOMENT_REL
        assert _rel(got["nu"][k], want["nu"][k]) < MOMENT_REL


def test_cli_runs_the_fused_sweep(capsys, tmp_path):
    """--hfta K through the CLI: the aggregate headline with every
    replica's final loss, the per-replica learning rates and seeds, and
    the final checkpoint a rerun resumes from."""
    bench = importlib.import_module(
        "mpi_operator_tpu_torch.examples.lm_benchmark")
    argv = ["--hfta", "2", "--hfta-lrs", "1e-3,2e-3", "--hfta-seeds", "0,1",
            "--size", "test", "--batch-per-device", "2", "--seq-len", "16",
            "--dtype", "float32", "--num-steps", "2", "--warmup-steps", "1",
            "--device", "cpu", "--train-dir", str(tmp_path)]
    assert bench.main(argv) == 0
    out = capsys.readouterr().out
    head = [line for line in out.splitlines() if line.startswith("{")][-1]
    import json
    rec = json.loads(head)
    assert rec["metric"] == "gpt2_hfta2_tokens_per_sec" and rec["value"] > 0
    assert len(rec["final_loss"]) == 2
    assert "lrs=[0.001, 0.002] seeds=[0, 1]" in out
    assert ck.checkpoint_steps(str(tmp_path)) == [3]
    assert bench.main(argv) == 0
    assert "resumed from" in capsys.readouterr().out
    assert ck.checkpoint_steps(str(tmp_path)) == [3, 6]


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_lr_at_follows_each_replicas_solo_schedule(schedule):
    """The fused [K] schedule (`_lr_at`, the reference's term for term)
    against each replica's solo make_lr_schedule, before, at and after
    the warmup and into the cosine decay."""
    tcfg = _tcfg(lr_schedule=schedule, decay_steps=12)
    hp = hfta.HFTAHyperparams.sweep(3, tcfg, learning_rates=LRS,
                                    warmup_steps=(0, 2, 5))
    tr = hfta.HFTATrainer(_cfg(), tcfg, hp, device="cpu")
    for c in (0, 1, 2, 3, 5, 8, 12, 20):
        got = tr._lr_at(torch.full((3,), c, dtype=torch.int32))
        want = [float(ttr.make_lr_schedule(hp.replica_config(tcfg, k))(
            torch.tensor(c, dtype=torch.int32))) for k in range(3)]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {c}")
