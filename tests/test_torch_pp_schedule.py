"""The pipeline's host half on the CPU, against the JAX package: the 1F1B
simulator's tables and depths, the interleaved layer order, the bubble,
the trainer's validation, and the stacked weights' conversion
(models/convert.py params_from_stacked)."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

from mpi_operator_tpu_torch.models import convert  # noqa: E402
from mpi_operator_tpu_torch.models import transformer as tt  # noqa: E402
from mpi_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mpi_operator_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from mpi_operator_tpu_torch.parallel import \
    pipeline_1f1b as t1f1b  # noqa: E402
from mpi_operator_tpu_torch.train import lm_trainer as tlm  # noqa: E402
from mpi_operator_tpu_torch.train import pp_trainer as tpp  # noqa: E402

j1f1b = importlib.import_module("mpi_operator_tpu.parallel.pipeline_1f1b")
jpipe = importlib.import_module("mpi_operator_tpu.parallel.pipeline")
jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpp = importlib.import_module("mpi_operator_tpu.train.pp_trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")

SCHEDULES = [(2, 4, 1), (4, 8, 1), (4, 8, 2), (2, 8, 2), (4, 16, 4),
             (4, 16, 2)]


@pytest.mark.parametrize("P,M,v", SCHEDULES)
def test_simulate_1f1b_equals_the_reference(P, M, v):
    got, want = t1f1b.simulate_1f1b(P, M, v), j1f1b.simulate_1f1b(P, M, v)
    for name in t1f1b.TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("ticks", "h_depth", "g_depth", "idle_slots",
                 "num_stages", "num_microbatches", "interleave"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.bubble_fraction == want.bubble_fraction


@pytest.mark.parametrize("P,M,v", SCHEDULES)
def test_schedule_invariants(P, M, v):
    """The reference's TestPipeline1F1B.test_schedule_invariants: every
    forward after its predecessor's, every backward after its
    successor's (the last virtual stage's after its own forward), each
    exactly once; and the in-flight count a rank never past its cap."""
    s = t1f1b.simulate_1f1b(P, M, v)
    VP = v * P
    done_f = np.full((VP, M), -1)
    done_b = np.full((VP, M), -1)
    for t in range(s.ticks):
        for d in range(P):
            if s.dir[t, d] == t1f1b.IDLE:
                continue
            k = s.chunk[t, d] * P + d
            m = s.mb[t, d]
            if s.dir[t, d] == t1f1b.FWD:
                assert done_f[k, m] == -1
                if k > 0:
                    assert 0 <= done_f[k - 1, m] < t
                done_f[k, m] = t
            else:
                assert done_b[k, m] == -1
                if k == VP - 1:
                    assert 0 <= done_f[k, m] < t
                else:
                    assert 0 <= done_b[k + 1, m] < t
                done_b[k, m] = t
    assert (done_f >= 0).all() and (done_b >= 0).all()
    flight = np.cumsum((s.dir == t1f1b.FWD).astype(int)
                       - (s.dir == t1f1b.BWD).astype(int), axis=0)
    assert flight.max() <= s.h_depth + 1


def test_bubble_fractions():
    assert tpipe.bubble_fraction(4, 16) == jpipe.bubble_fraction(4, 16) \
        == pytest.approx(3 / 19)
    s1, s2 = t1f1b.simulate_1f1b(4, 8, 1), t1f1b.simulate_1f1b(4, 8, 2)
    assert s2.bubble_fraction < 0.65 * s1.bubble_fraction
    assert s1.h_depth <= 4 and t1f1b.simulate_1f1b(4, 32, 1).h_depth <= 4
    # the card's [train-lm-pp] schedule: 1F1B x 2 at pp 4, M 16
    assert t1f1b.simulate_1f1b(4, 16, 2).bubble_fraction == pytest.approx(
        0.0857, abs=1e-4)


@pytest.mark.parametrize("L,P,v", [(4, 2, 1), (4, 2, 2), (8, 2, 2),
                                   (24, 4, 2), (16, 4, 4)])
def test_interleave_orders_equal_the_reference(L, P, v):
    blocks = {"w": np.arange(L)}
    want = np.asarray(j1f1b.interleave_blocks(blocks, P, v)["w"])
    assert t1f1b.interleave_order(L, P, v) == want.tolist()
    back = np.asarray(j1f1b.deinterleave_blocks({"w": want}, P, v)["w"])
    order = t1f1b.deinterleave_order(L, P, v)
    assert np.asarray(want)[order].tolist() == back.tolist() \
        == list(range(L))
    per = L // P
    for d in range(P):
        assert t1f1b.rank_layers(L, P, v, d) == want[d * per:
                                                     (d + 1) * per].tolist()


def _pp_mesh(**sizes):
    cfg = tmesh.MeshConfig(**sizes)
    return tmesh.Mesh(cfg, range(cfg.num_devices))


def _both(cfg_kw, mesh_kw, tcfg_kw, **kw):
    """The (port, reference) trainer constructors' error messages for the
    same arguments (None where it constructs)."""
    out = []
    family = cfg_kw.pop("family", "gpt2")
    for mod, make, mesh in (
            (tt, tpp.PipelineLMTrainer, _pp_mesh(**mesh_kw)),
            (jt, jpp.PipelineLMTrainer, jpar.make_mesh(
                jpar.MeshConfig(**mesh_kw), devices=jax.devices()[
                    :tmesh.MeshConfig(**mesh_kw).num_devices]))):
        cfg = getattr(mod, f"{family}_config")("test", **cfg_kw)
        tcfg = (tlm if mod is tt else jtr).LMTrainerConfig(**tcfg_kw)
        try:
            if mod is tt:
                make(cfg, mesh, tcfg, device="cpu", **kw)
            else:
                make(cfg, mesh, tcfg, **kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("cfg_kw,mesh_kw,tcfg_kw,kw", [
    ({}, dict(pp=2, dp=4), dict(global_batch_size=32, seq_len=8),
     dict(schedule="zb")),
    ({}, dict(pp=2, dp=4), dict(global_batch_size=32, seq_len=8),
     dict(interleave=2)),
    ({}, dict(pp=2, dp=4), dict(global_batch_size=24, seq_len=8),
     dict(num_microbatches=3)),
    ({}, dict(pp=2, dp=4), dict(global_batch_size=16, seq_len=8),
     dict(num_microbatches=8)),
    ({}, dict(pp=2, dp=4), dict(global_batch_size=32, seq_len=8),
     dict(schedule="1f1b", interleave=2)),
    (dict(family="llama"), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8), {}),
    (dict(num_experts=4, num_layers=4), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8), dict(schedule="1f1b")),
    (dict(num_experts=4, num_layers=2), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8), {}),
    (dict(num_experts=4, num_layers=4, moe_every=1), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8), {}),
    (dict(family="bert"), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8), {}),
    ({}, dict(pp=2, dp=4), dict(global_batch_size=32, seq_len=8,
                                masked_lm=True), {}),
    (dict(family="bert"), dict(pp=2, dp=4),
     dict(global_batch_size=32, seq_len=8, masked_lm=True,
          fused_xent=True), {}),
    ({}, dict(pp=2, sp=2, dp=2), dict(global_batch_size=32, seq_len=8), {}),
    (dict(attention="ring"), dict(pp=2, sp=2, dp=2),
     dict(global_batch_size=32, seq_len=9), {}),
])
def test_validation_equals_the_reference(cfg_kw, mesh_kw, tcfg_kw, kw):
    port, ref = _both(dict(cfg_kw), mesh_kw, tcfg_kw, **kw)
    assert port is not None and port == ref


def test_valid_configs_construct():
    port, ref = _both({}, dict(pp=2, dp=4),
                      dict(global_batch_size=32, seq_len=8),
                      num_microbatches=8)
    assert port is None and ref is None
    tr = tpp.PipelineLMTrainer(
        tt.gpt2_config("test"), _pp_mesh(pp=2, dp=4),
        tlm.LMTrainerConfig(global_batch_size=32, seq_len=8),
        num_microbatches=8, device="cpu")
    assert tr.bubble == pytest.approx(1 / 9)
    with pytest.raises(ValueError, match="flat trainer only"):
        tpp.PipelineLMTrainer(
            tt.gpt2_config("test", tp_overlap=True),
            _pp_mesh(pp=2, tp=2, dp=2),
            tlm.LMTrainerConfig(global_batch_size=32, seq_len=8),
            device="cpu")


_TREES = {}


def _tree(family, over):
    """A flax tree of an 8-layer test-width model of `family`: the init's
    structure and shapes (jax.eval_shape: nothing is compiled), every
    leaf seeded normal values (one tree a family and override, shared by
    the cases)."""
    import jax.numpy as jnp
    from flax.core import meta
    key = (family, tuple(sorted(over.items())))
    if key not in _TREES:
        common = dict(attention="dense", dtype=jnp.float32, vocab_size=96,
                      max_len=32, num_layers=8, **over)
        jcfg = getattr(jt, f"{family}_config")("test", **common)
        tcfg = getattr(tt, f"{family}_config")(
            "test", **dict(common, dtype=torch.float32))
        model = jt.CausalLM if jcfg.causal else jt.MaskedLM
        shapes = meta.unbox(jax.eval_shape(
            model(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, 4), jnp.int32)))["params"]
        rs = np.random.RandomState(len(_TREES))
        tree = jax.tree.map(
            lambda s: rs.standard_normal(s.shape).astype(np.float32),
            shapes)
        _TREES[key] = (jcfg, tcfg, tree)
    return _TREES[key]


@pytest.mark.parametrize("family,over,P,v", [
    ("gpt2", {}, 2, 1), ("gpt2", {}, 2, 2), ("gpt2", {}, 2, 4),
    ("bert", {}, 2, 2), ("gpt2", dict(num_experts=4), 2, 1)])
def test_params_from_stacked_round_trips(family, over, P, v):
    """The reference pp trainer's stacked (and interleaved) tree converts
    to the state dict params_from_flax makes of the unstacked tree."""
    jcfg, tcfg, tree = _tree(family, over)
    stack = (jpipe.stack_lm_params if jcfg.causal
             else jpipe.stack_mlm_params)
    stacked = stack(tree, 8, num_experts=jcfg.num_experts,
                    moe_every=jcfg.moe_every)
    if v > 1:
        stacked = dict(stacked, blocks=j1f1b.interleave_blocks(
            stacked["blocks"], P, v))
    got = convert.params_from_stacked(
        tcfg, jax.tree.map(np.asarray, stacked), P, v)
    want = convert.params_from_flax(tcfg, tree)
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_stage_names_are_the_whole_models():
    cfg = tt.gpt2_config("test", num_layers=4)
    names = tpipe.stage_param_names(cfg, [1, 3])
    assert {tpipe.block_of(n) for n in names} == {None, 1, 3}
    assert set(names) <= set(tt.param_shapes(cfg))
    assert tpipe._moe_layer_split(4, 4, 2) == \
        jpipe._moe_layer_split(4, 4, 2) == ([0, 2], [1, 3])
    with torch.device("meta"):
        stage = tpipe.StageLM(dataclasses.replace(cfg), [1, 3])
    assert [n for n, _ in stage.named_parameters()] == names
