"""The port's image Trainer (train/trainer.py) against the JAX package's
`Trainer` on a one-device mesh, on the CPU in f32, and its entry points
(`run_benchmark`, `run_vit_benchmark`) and checkpoints.

Same weights (flax params and batch statistics moved off their init,
converted by models/convert.py) and the same numpy batches: a
bottleneck ResNet with one block a stage and the s2d stem, and
`vit_config("test")` with patch 4, at 32 px, batch 16. After three SGD
steps (lr 0.02, momentum 0.9) loss agrees at rtol 1e-5 and accuracy
exactly, parameters and running statistics at atol 5e-5 (f32 sums in
another order, carried through three updates), momentum by relative
error (see MOMENTUM_REL).
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jres = importlib.import_module("mpi_operator_tpu.models.resnet")
jtf = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tres = importlib.import_module("mpi_operator_tpu_torch.models.resnet")
ttf = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.trainer")
ck = importlib.import_module("mpi_operator_tpu_torch.train.checkpoint")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.benchmark")
lmbench = importlib.import_module(
    "mpi_operator_tpu_torch.examples.lm_benchmark")

# batch 16 as the reference's DP test (tests/test_data_plane.py): at 32
# px the last stage is 1x1, and a batch of 4 would leave its BN four
# values to normalise, which amplifies f32 rounding ~30x a step
IMG, CLASSES, B = 32, 10, 16
ATOL = 5e-5
# the parity test's learning rate: from the perturbed weights lr 0.1
# takes steps large enough that three of them amplify f32 rounding past
# 1e-4 in the stem; 0.02 keeps the comparison well conditioned
LR = 0.02
# the momentum holds the summed gradients, which the BN of the 1x1 last
# stage (16 values a channel) makes sensitive to f32 rounding: compared
# by relative error a tensor (~1e-3 read). ViT's key biases have an
# exact gradient of 0 (a key bias shifts a row's scores uniformly):
# both sides hold rounding noise under the floor
MOMENTUM_REL, MOMENTUM_FLOOR = 5e-3, 1e-6


def _jax_model(kind):
    if kind == "resnet":
        return jres.ResNet(stage_sizes=[1, 1, 1, 1],
                           block_cls=jres.BottleneckResNetBlock,
                           num_classes=CLASSES, dtype=jnp.float32,
                           stem="s2d")
    return jtf.ViT(jtf.vit_config("test", attention="dense",
                                  dtype=jnp.float32),
                   num_classes=CLASSES, patch_size=4)


def _port_model(kind):
    with torch.device("meta"):
        if kind == "resnet":
            return tres.ResNet([1, 1, 1, 1], tres.BottleneckResNetBlock,
                               num_classes=CLASSES, dtype=torch.float32,
                               stem="s2d")
        return ttf.ViT(ttf.vit_config("test", attention="dense",
                                      dtype=torch.float32),
                       num_classes=CLASSES, patch_size=4, image_size=IMG)


@functools.lru_cache(maxsize=None)
def _variables(kind):
    """flax params and batch_stats (numpy), biases, scales, statistics
    and the ViT's cls / positions moved off their init."""
    from flax.core import meta
    v = meta.unbox(jax.jit(_jax_model(kind).init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    v = jax.tree.map(np.asarray, dict(v))
    rs = np.random.RandomState(1)

    def walk(node, path=()):
        out = {}
        for k, val in node.items():
            if isinstance(val, dict):
                out[k] = walk(val, path + (k,))
                continue
            a = np.array(val, np.float32)
            if k in ("scale", "bias", "mean", "cls") or "pos" in path:
                a = a + 0.1 * rs.randn(*a.shape).astype(np.float32)
            elif k == "var":
                a = a * rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(v["params"]), walk(v.get("batch_stats", {}))


def _to_port(kind, model, params, stats):
    if kind == "resnet":
        return convert.resnet_params_from_flax(model, params, stats)
    return convert.vit_params_from_flax(model.config, params)


def _batches(n, seed=0, nan_at=None):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rs.randn(B, IMG, IMG, 3).astype(np.float32)
        if i == nan_at:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rs.randint(0, CLASSES, B).astype(np.int32)))
    return out


def _jax_trainer(kind, **kw):
    mesh = jpar.make_mesh(jpar.MeshConfig.data_parallel(1),
                          devices=jax.devices()[:1])
    tr = jtr.Trainer(_jax_model(kind), mesh, jtr.TrainerConfig(
        global_batch_size=B, image_size=IMG, num_classes=CLASSES, **kw))
    params, stats = _variables(kind)
    state = tr.init_state(jax.random.PRNGKey(0))
    put = functools.partial(jax.tree.map, lambda ref, x: jax.device_put(
        jnp.asarray(x), ref.sharding))
    state = state.replace(params=put(state.params, params))
    if stats:
        state = state.replace(batch_stats=put(state.batch_stats, stats))
    return tr, state


def _port_trainer(kind, **kw):
    model = _port_model(kind)
    params, stats = _variables(kind)
    tr = ttr.Trainer(model, ttr.TrainerConfig(
        global_batch_size=B, image_size=IMG, num_classes=CLASSES, **kw),
        device="cpu")
    return tr, tr.init_state(state_dict=_to_port(kind, model, params, stats))


def _named(model, flat, which="params"):
    named = (model.named_parameters() if which == "params"
             else model.named_buffers())
    out, off = {}, 0
    for name, t in named:
        out[name] = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
    return out


@pytest.mark.parametrize("kind", ["resnet", "vit"])
def test_three_sgd_steps_match_the_jax_trainer(kind):
    """Loss and accuracy of each step, then params, momentum and the
    running statistics, against Trainer.train_step on a 1-device mesh."""
    jtrainer, jstate = _jax_trainer(kind, learning_rate=LR)
    trainer, state = _port_trainer(kind, learning_rate=LR)
    for x, y in _batches(3):
        jstate, jm = jtrainer.train_step(
            jstate, jax.device_put(x, jtrainer.batch_sharding),
            jax.device_put(y, jtrainer.batch_sharding))
        state, m = trainer.train_step(state, torch.from_numpy(x),
                                      torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    assert state.step == int(jstate.step) == 3
    jstats = jax.tree.map(np.asarray, dict(jstate.batch_stats))
    want = _to_port(kind, state.model, jax.tree.map(np.asarray,
                                                    jstate.params), jstats)
    trace = jstate.opt_state[0].trace
    want_m = _to_port(kind, state.model, jax.tree.map(np.asarray, trace),
                      jstats)
    got_m = _named(state.model, state.momentum)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
        w = want_m[name]
        if float(w.norm()) < MOMENTUM_FLOOR:    # an exactly-zero gradient
            assert float(got_m[name].norm()) < MOMENTUM_FLOOR, name
            continue
        rel = float((got_m[name] - w).norm() / w.norm())
        assert rel < MOMENTUM_REL, (name, rel)
    for name, b in state.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), atol=ATOL,
                                   rtol=1e-5, err_msg=name)
    if kind == "resnet":
        assert state.batch_stats.numel() > 0
    else:
        assert state.batch_stats.numel() == 0


def test_nan_batch_is_skipped_and_the_streak_counts():
    """A batch with a NaN pixel: no update to params, momentum or
    statistics, the streak increments; the next clean step applies and
    resets it (the reference's guard_nonfinite_update)."""
    trainer, state = _port_trainer("resnet")
    (x0, y0), (bad, yb), (x2, y2) = _batches(3, nan_at=1)
    state, _ = trainer.train_step(state, torch.from_numpy(x0),
                                  torch.from_numpy(y0))
    before = [t.clone() for t in (state.params, state.momentum,
                                  state.batch_stats)]
    for k in (1, 2):
        state, m = trainer.train_step(state, torch.from_numpy(bad),
                                      torch.from_numpy(yb))
        assert math.isnan(float(m["loss"]))
        assert int(m["nonfinite_streak"]) == k
    for old, new in zip(before, (state.params, state.momentum,
                                 state.batch_stats)):
        assert torch.equal(old, new)
    state, m = trainer.train_step(state, torch.from_numpy(x2),
                                  torch.from_numpy(y2))
    assert int(m["nonfinite_streak"]) == 0 and state.step == 4
    assert not torch.equal(before[0], state.params)


def test_benchmark_returns_the_reference_keys():
    """Trainer.benchmark on both sides over the same batches (one warmup
    step, four timed in windows of two): the port returns the JAX
    benchmark's keys (plus `step_losses`), and equal losses."""
    jtrainer, jstate = _jax_trainer("resnet", log_every=2)
    trainer, state = _port_trainer("resnet", log_every=2)
    batches = _batches(5, seed=3)
    quiet = lambda s: None  # noqa: E731
    _, jm = jtrainer.benchmark(
        jstate, [tuple(jnp.asarray(a) for a in b) for b in batches],
        num_steps=4, warmup_steps=1, log=quiet)
    logs = []
    state, m = trainer.benchmark(
        state, [tuple(torch.from_numpy(a) for a in b) for b in batches],
        num_steps=4, warmup_steps=1, log=logs.append)
    assert set(m) == set(jm) | {"step_losses"}
    assert m["goodput"] == jm["goodput"] == 1.0
    np.testing.assert_allclose(m["final_loss"], jm["final_loss"], rtol=1e-5)
    # no peak is known for the CPU; no FLOP table for this cut ResNet
    assert m["mfu"] is None and m["flops_per_step"] is None
    assert any("images/sec:" in line for line in logs)
    assert any(line.startswith("total images/sec:") for line in logs)
    assert state.step == 5


def test_run_benchmark_and_run_vit_benchmark_on_the_cpu(monkeypatch):
    """The entry points at test size with device="cpu": finite losses,
    the reference's keys; without a card and without device="cpu" they
    raise."""
    state, m = bench.run_benchmark(
        model_name="resnet18", batch_per_device=2, num_steps=2,
        warmup_steps=1, image_size=32, stem="s2d", device="cpu",
        log=lambda s: None)
    assert state.step == 3 and math.isfinite(m["final_loss"])
    assert m["images_per_sec"] > 0 and m["flops_per_step"] > 0
    state, m = lmbench.run_vit_benchmark(
        size="test", batch_per_device=2, image_size=32, num_steps=2,
        warmup_steps=1, device="cpu", log=lambda s: None)
    assert state.step == 3 and math.isfinite(m["final_loss"])
    assert state.model.pos.num_embeddings == 5
    with pytest.raises(ValueError, match="2 slices"):
        bench.run_benchmark(num_slices=2, device="cpu")   # one process
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tres.create_model("resnet18"),
                 lambda: ttf.create_vit("vit-test"),
                 lambda: bench.run_benchmark("resnet18"),
                 lambda: lmbench.run_vit_benchmark("test"),
                 lambda: ttr.Trainer(_port_model("vit"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_image_checkpoint_resumes_bit_equal(tmp_path):
    """Two steps, a checkpoint (params, batch stats, momentum, step),
    two more steps = the run A; a fresh state restored from the
    checkpoint and stepped on the same two batches ends bit-equal to A.
    The payload holds the three tensors under their own keys."""
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in _batches(4, seed=5)]
    trainer, state = _port_trainer("resnet")
    for b in batches[:2]:
        trainer.train_step(state, *b)
    assert set(state.checkpoint_payload()) == {"params", "batch_stats",
                                               "opt.momentum"}
    path = ck.save_checkpoint(str(tmp_path), state)
    for b in batches[2:]:
        trainer.train_step(state, *b)
    trainer2, fresh = _port_trainer("resnet")
    fresh = ck.restore_checkpoint(path, fresh)
    assert fresh.step == 2
    for b in batches[2:]:
        trainer2.train_step(fresh, *b)
    for a, b in ((state.params, fresh.params),
                 (state.momentum, fresh.momentum),
                 (state.batch_stats, fresh.batch_stats)):
        assert torch.equal(a, b)
    ck.reset_saved_state()


def test_vit_preemption_drill_resumes_bit_equal(tmp_path, monkeypatch):
    """run_vit_benchmark's resilient path on the image state: SIGTERM at
    step 3 drains to an emergency checkpoint and Preempted (exit code
    215); the restart resumes from step_3 on the step-keyed stream and
    ends bit-equal to an uninterrupted run of the same 6 steps (params,
    momentum); the event log holds the drain, the emergency checkpoint
    and the restore."""
    from mpi_operator_tpu_torch.telemetry import events as tev
    from mpi_operator_tpu_torch.train.resilience import Preempted
    quiet = lambda s: None  # noqa: E731
    kw = dict(size="test", batch_per_device=2, image_size=32,
              warmup_steps=1, dtype_name="float32", device="cpu", log=quiet)
    a, _ = lmbench.run_vit_benchmark(num_steps=5, **kw)
    ck.reset_saved_state()
    train_dir = str(tmp_path / "b")
    monkeypatch.setenv("TPU_FAULT_INJECT", "sigterm-at-step:3")
    with pytest.raises(Preempted) as exc:
        lmbench.run_vit_benchmark(num_steps=5, train_dir=train_dir, **kw)
    assert exc.value.step == 3 and exc.value.exit_code == 215
    monkeypatch.delenv("TPU_FAULT_INJECT")
    ck.reset_saved_state()
    b, _ = lmbench.run_vit_benchmark(num_steps=2, train_dir=train_dir, **kw)
    assert a.step == b.step == 6
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.momentum, b.momentum)
    kinds = [e["event"] for e in tev.read_events(
        str(tmp_path / "b" / "events.jsonl"))]
    for kind in (tev.PREEMPTION_DRAIN, tev.EMERGENCY_CHECKPOINT,
                 tev.CHECKPOINT_RESTORE, tev.RUN_COMPLETE):
        assert kind in kinds, kinds
    ck.reset_saved_state()
