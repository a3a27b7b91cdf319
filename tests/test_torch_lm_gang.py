"""Data-parallel LM training on the CPU: gloo gangs of the port's
LMTrainer, started by `launch.py` and joined through the bootstrap
(tests/torch_lm_gang_worker.py), against one process at the global
batch, and against the JAX LMTrainer on a dp = 2 mesh of the
conftest's virtual devices.

Two ranks, 3 AdamW steps, global batch 8 x 16, f32: gpt2-test, bert-test
(MLM over padded rows, so the ranks' mask counts differ) and gpt2-test
with 4 experts in capacity mode under accum_steps 2, all from the same
flax weights (the JAX package's init through models/convert.py). The
update (params after minus before) and both AdamW moments of every rank
must equal the single process's to UPDATE_REL / MOMENT_REL (relative
L2; Adam's 1/sqrt(nu) lifts f32 summation-order differences of the
smallest gradients to ~1e-5 in the update), the step losses to LOSS_ATOL,
and the ranks must hold the same parameters bit for bit. Each planted
fault must miss UPDATE_REL by more than a factor of FAULT_MARGIN.

Hazards, each with its test: H13 (the global mask count), H14 (global
MoE routing: capacity, queue positions, drop rate, aux loss), H15
(every rank takes the same guard and rollback decision), H16 (a rank's
rows are its share of each microbatch). Then 2 slices x 2 ranks (the
dcn x dp mesh, hybrid_mesh): gpt2 and a ResNet against one process,
and the hierarchical all-reduce against the flat one.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_gang_worker as worker  # noqa: E402
from torch_parity import perturbed_params, to_port  # noqa: E402

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tsyn = importlib.import_module("mpi_operator_tpu_torch.data.synthetic")
ttok = importlib.import_module("mpi_operator_tpu_torch.data.tokenstream")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")

UPDATE_REL, MOMENT_REL, LOSS_ATOL = 1e-4, 1e-5, 1e-5
FAULT_MARGIN = 100
# the JAX trainer against the gang: test_torch_moe.py's tolerances
JAX_LOSS_ATOL, JAX_PARAM_ATOL = 1e-5, 5e-6


def _jax_configs():
    """The flax modules of the parity models, the worker's configs."""
    common = dict(attention="dense", dtype=jnp.float32,
                  vocab_size=worker.VOCAB, max_len=32)
    return {"gpt2": jt.gpt2_config("test", **common),
            "bert": jt.bert_config("test", **common),
            "moe": jt.gpt2_config("test", num_experts=4, **common)}


@pytest.fixture(scope="module")
def weights():
    """The same flax weights for every run: {name: port state dict}."""
    tcfgs = worker.parity_configs()
    out = {}
    for name, jcfg in _jax_configs().items():
        tree = perturbed_params(jt.CausalLM(jcfg) if jcfg.causal
                                else jt.MaskedLM(jcfg))
        out[name] = (tree, to_port(tcfgs[name][0], tree))
    return out


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """(the 2-rank gang's results per rank, one process's results)."""
    tmp = tmp_path_factory.mktemp("lm-gang")
    path = tmp / "weights.pt"
    state_dicts = {k: v[1] for k, v in weights.items()}
    torch.save(state_dicts, path)
    got, _ = worker.gang(2, str(tmp / "r"), "--faults", "--checks",
                         "--weights", str(path), "--train-dir",
                         str(tmp / "ckpt"))
    want = worker.run(0, 1, "cpu", 3, checks=True, weights=state_dicts)
    return got, want


@pytest.mark.parametrize("name", worker.MODELS)
def test_two_gloo_ranks_equal_one_process_at_the_global_batch(runs, name):
    got, want = runs
    assert got[0]["backend"] == "gloo" and got[0]["mesh"]["dp"] == 2
    for rank in got:
        err = worker.compare(rank[name], want[name])
        assert err["update"] < UPDATE_REL, (name, err)
        assert max(err["mu"], err["nu"]) < MOMENT_REL, (name, err)
        assert err["loss"] < LOSS_ATOL, (name, err)
        assert rank[name]["count"] == want[name]["count"] == 3
    assert torch.equal(got[0][name]["params"], got[1][name]["params"])
    assert torch.equal(got[0][name]["start"], want[name]["start"])


@pytest.mark.parametrize("name,fault", worker.FAULTS)
def test_planted_faults_fail_the_comparison(runs, name, fault):
    """Per-rank mask counts (H13), per-rank routing (H14) and rows cut
    into microbatches after the split (H16) each miss the single
    process's update by orders of magnitude."""
    got, want = runs
    for rank in got:
        err = worker.compare(rank[f"{name}/{fault}"], want[name])
        assert err["update"] > FAULT_MARGIN * UPDATE_REL, (fault, err)


def test_h13_the_normaliser_is_the_global_mask_count(runs):
    """The ranks' own mask counts differ; each normalises by their sum,
    the single process's count."""
    got, want = runs
    mine = [[c[0] for c in r["bert"]["mask_counts"]] for r in got]
    assert any(a != b for a, b in zip(*mine))
    for r in got:
        assert [c[1] for c in r["bert"]["mask_counts"]] == \
            [a + b for a, b in zip(*mine)] == \
            [c[1] for c in want["bert"]["mask_counts"]]


def test_h14_routing_is_the_global_batchs(runs):
    """One MoE layer over a seeded global input, each rank its rows:
    capacity from the global token count; the ranks' queue positions and
    kept flags, in rank order, are the single process's (ints, exact);
    the outputs concatenate to its output, the aux shares sum to its aux
    loss, and every rank reads its drop rate. The trained MoE's drop
    rates equal the single process's, and tokens were dropped."""
    got, want = runs
    w = want["routing"]
    for key in ("slot", "keep"):
        assert torch.equal(torch.cat([r["routing"][key] for r in got]),
                           w[key]), key
    assert all(r["routing"]["cap"] == w["cap"] for r in got)
    np.testing.assert_allclose(
        torch.cat([r["routing"]["out"] for r in got]).numpy(),
        w["out"].numpy(), atol=1e-6)
    assert sum(r["routing"]["aux"] for r in got) == \
        pytest.approx(w["aux"], abs=1e-6)
    assert all(r["routing"]["drop_rate"] == w["drop_rate"] > 0 for r in got)
    rates = want["moe"]["drop_rates"]
    assert max(rates) > 0
    for r in got:
        np.testing.assert_allclose(r["moe"]["drop_rates"], rates, atol=1e-7)


def test_h15_every_rank_takes_the_same_guard_decision(runs):
    """A non-finite loss on the last rank only: every rank reports the
    global (NaN) loss, skips the update and counts the streak; with the
    loss poisoned for a whole window every rank rolls back to the
    checkpoint, and the ranks end equal."""
    got, _ = runs
    for r in got:
        skip = r["guard"]["skip"]
        assert np.isnan(skip["loss"]) and skip["streak"] == 1
        assert skip["count"] == 1 and skip["unchanged"]
        assert r["guard"]["rolled_back"]
    assert got[0]["guard"]["step"] == got[1]["guard"]["step"]
    assert torch.equal(got[0]["guard"]["params"], got[1]["guard"]["params"])
    assert torch.isfinite(got[0]["guard"]["params"]).all()


def test_h16_a_ranks_rows_are_its_share_of_each_microbatch(monkeypatch,
                                                           tmp_path):
    """rank_share over 2 ranks and 2 microbatches: rank r's chunk m is
    rows [m B/A + r b, m B/A + (r + 1) b) of the global batch. The step
    streams (synthetic, MLM mask included, and the npy shards) draw the
    same global window on every rank, and the ranks' shares, chunk by
    chunk, rebuild it."""
    x = np.arange(8 * 3).reshape(8, 3)
    a, b = (tsyn.rank_share(x, r, 2, 2) for r in (0, 1))
    np.testing.assert_array_equal(a, x[[0, 1, 4, 5]])
    np.testing.assert_array_equal(b, x[[2, 3, 6, 7]])
    with pytest.raises(ValueError, match="microbatch"):
        tsyn.rank_share(x, 0, 3)

    def rebuild(make):
        shares = []
        for rank in (0, 1):
            monkeypatch.setattr(tsyn, "rank_and_world", lambda r=rank: (r, 2))
            monkeypatch.setattr(ttok, "rank_and_world", lambda r=rank: (r, 2))
            shares.append(make())
        monkeypatch.setattr(tsyn, "rank_and_world", lambda: (0, 1))
        monkeypatch.setattr(ttok, "rank_and_world", lambda: (0, 1))
        whole = make()
        for got0, got1, want in zip(*shares, whole):
            got = torch.cat([torch.cat(p) for p in zip(got0.chunk(2),
                                                      got1.chunk(2))])
            assert torch.equal(got, want)

    rebuild(lambda: tsyn.TokenStream(8, 16, 50, seed=3, device="cpu",
                                     masked_lm=True,
                                     accum_steps=2).batch(5))
    ttok.write_token_shard(str(tmp_path), "a",
                           np.arange(20 * 17, dtype=np.int32) % 50)

    def shard_batch():
        ds = ttok.NpyTokenDataset(str(tmp_path), 8, 16, device="cpu",
                                  vocab_size=50, accum_steps=2,
                                  host_transform=ttok.mlm_host_transform(50))
        try:
            return next(ds)
        finally:
            ds.close()
    rebuild(shard_batch)


def test_moe_gang_matches_the_jax_trainer_on_a_dp2_mesh(runs, weights):
    """The MoE gang (2 ranks, capacity mode, accum_steps 2) against the
    JAX LMTrainer jitted over a dp = 2 mesh of the virtual devices from
    the same flax weights and global batches: every step's loss and
    every parameter after the third step."""
    got, _ = runs
    jcfg = _jax_configs()["moe"]
    tcfg, accum = worker.parity_configs()["moe"]
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2), devices=jax.devices()[:2])
    tr = jtr.LMTrainer(jt.CausalLM(jcfg), mesh, jtr.LMTrainerConfig(
        global_batch_size=worker.GLOBAL_BATCH, seq_len=worker.SEQ["test"],
        warmup_steps=2, accum_steps=accum))
    state = tr.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda ref, x: jax.device_put(jnp.asarray(x),
                                                        ref.sharding),
                          state.params, weights["moe"][0])
    state = state.replace(params=params)
    losses = []
    for toks, tgts in worker.batches(tcfg, 3, worker.SEQ["test"]):
        state, m = tr.train_step(
            state, jax.device_put(jnp.asarray(toks, jnp.int32),
                                  tr.batch_sharding),
            jax.device_put(jnp.asarray(tgts, jnp.int32), tr.batch_sharding))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got[0]["moe"]["losses"], losses,
                               atol=JAX_LOSS_ATOL)
    want = to_port(tcfg, jax.tree.map(np.asarray, state.params))
    flat = torch.cat([want[n].reshape(-1) for n in tt.param_shapes(tcfg)])
    np.testing.assert_allclose(got[0]["moe"]["params"].numpy(),
                               flat.numpy(), atol=JAX_PARAM_ATOL, rtol=0)


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slices")
    got, _ = worker.gang(4, str(tmp / "r"), "--only", "gpt2,resnet",
                         "--checks", "--train-dir", str(tmp / "ckpt"),
                         slices=2)
    want = worker.run(0, 1, "cpu", 3, only=["gpt2", "resnet"])
    return got, want


def test_two_slices_of_two_ranks_equal_one_process(slices):
    """4 ranks as 2 slices x 2 (two launch.py trees, TPU_NUM_SLICES 2):
    the mesh is dcn 2 x dp 2, gpt2 and the ResNet (its DDP buckets and
    BN statistics over both dims, the gradient through the hierarchical
    hook) equal one process, and the two-phase mean the flat one."""
    got, want = slices
    assert [r["mesh"]["dcn"] for r in got] == [2] * 4
    assert all(r["mesh"]["dp"] == 2 for r in got)
    for r in got:
        err = worker.compare(r["gpt2"], want["gpt2"])
        assert err["update"] < UPDATE_REL and err["loss"] < LOSS_ATOL, err
        for label, a, b in zip(("start", "params", "momentum", "stats"),
                               r["resnet"], want["resnet"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=label)
        assert r["hierarchical"]["max_diff"] < 1e-6
        assert r["guard"]["rolled_back"]
