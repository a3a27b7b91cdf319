"""Expert parallelism on the CPU: the MoE FFN (parallel/moe.py) and the
LMTrainer over ep, one gang of 8 gloo ranks (tests/torch_mp_worker.py)
against the JAX package on the conftest's 8 virtual devices, and the
benchmark's CLI over a dp x ep x sp x tp mesh.

- The reference's TestMoE.test_ep_sharded_matches_dense layer (4
  experts, E 32, mlp 64, top 2, capacity factor 2.0) at (dp, ep) =
  (2, 4) and (dp, ep, tp) = (2, 2, 2): each rank's output rows equal the
  JAX MoeMlp's on the whole input, the aux shares sum to its aux; the
  gradients of x and of each rank's expert blocks (summed over dp)
  equal one process's.
- The trainer: gpt2-test with 4 experts (capacity mode, accum_steps 2)
  at (dp, ep) = (2, 4) equals the JAX LMTrainer on the same mesh and one
  process; at (2, 2, 2) with tp, dropless at (2, 4), and at (dp, sp,
  ep) = (2, 2, 2), where the global routing counts per row (the
  sequence shards of a row precede the next row's), equal one process.
- `python -m mpi_operator_tpu_torch.examples.lm_benchmark --tp 2 --sp 2
  --ep 2 --moe-experts 4` runs as a gang of 8 through launch.py and
  prints its headline.
"""
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_parity as mp  # noqa: E402
import torch_mp_worker as worker  # noqa: E402

jmoe = importlib.import_module("mpi_operator_tpu.parallel.moe")
tmesh = importlib.import_module("mpi_operator_tpu_torch.parallel.mesh")
tsh = importlib.import_module("mpi_operator_tpu_torch.parallel.sharding")

LAYERS = ("moe-layer/dp2-ep4", "moe-layer/dp2-ep2-tp2")
#: relative L2 limit of the layer's gradients (f32 sums in other orders)
GRAD_REL = 1e-5
TRAIN = ("moe/dp2-ep4", "moe/dp2-ep2-tp2", "moe/dp2-ep4-dropless",
         "moe/dp2-sp2-ep2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mp.run_gang(tmp_path_factory.mktemp("ep"), LAYERS + TRAIN,
                       ("moe",))


def _jax_layer():
    router, w_in, w_out, x = (t.numpy() for t in worker.moe_weights())
    m = jmoe.MoeMlp(num_experts=4, embed_dim=32, mlp_dim=64, top_k=2,
                    capacity_factor=2.0, dtype=jnp.float32)
    params = {"params": {"router": {"kernel": router.T}, "w_in": w_in,
                         "w_out": w_out}}
    out, aux = m.apply(params, jnp.asarray(x))
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("name", LAYERS)
def test_ep_sharded_layer_matches_the_reference(runs, name):
    """Each rank's rows of the ep (x tp) layer's output equal the JAX
    MoeMlp's over the whole input; the aux shares of the dp ranks sum to
    its aux."""
    got, _ = runs
    out, aux = _jax_layer()
    ranks = mp.ranks(got, name)
    assert len(ranks) == 8
    for r in ranks:
        dp = r["coords"]["dp"]
        np.testing.assert_allclose(r["out"].numpy(), out[dp:dp + 1],
                                   atol=1e-5)
    shares = {r["coords"]["dp"]: r["aux"] for r in ranks}
    assert sum(shares.values()) == pytest.approx(aux, abs=1e-6)


@pytest.mark.parametrize("name", LAYERS)
def test_ep_sharded_layer_gradients_equal_one_process(runs, name):
    """x's gradient rows and each rank's expert blocks' gradients (the
    router's rows of its experts too), summed over dp, equal one
    process's over the whole batch."""
    got, _ = runs
    one = worker.moe_layer()
    x = worker.moe_weights()[3].clone().requires_grad_()
    out, aux = one(x)
    ((out ** 2).sum() + aux).backward()
    mesh = tmesh.Mesh(tmesh.MeshConfig(**worker.LEGS[name]["mesh"]),
                      range(8))
    layout = tsh.ModelLayout(
        mesh, worker.tt.gpt2_config("test", num_experts=4, embed_dim=32,
                                    mlp_dim=64))
    place = layout.placements
    pre = next(n for n in place if n.endswith("moe.w_in"))[:-len("w_in")]
    ranks = mp.ranks(got, name)
    for r in ranks:
        dp = r["coords"]["dp"]
        assert worker.rel(r["dx"], x.grad[dp:dp + 1]) < GRAD_REL
    for pname, p in one.named_parameters():
        for r in ranks:
            if r["coords"]["dp"]:
                continue
            total = sum(q["grads"][pname] for q in ranks
                        if all(q["coords"][a] == r["coords"][a]
                               for a in ("ep", "tp")))
            want = tsh.local_block(p.grad, place[pre + pname], r["coords"],
                                   mesh.shape)
            assert worker.rel(total, want) < GRAD_REL, pname


def test_trainer_over_ep_equals_the_jax_trainer(runs):
    got, weights = runs
    name = "moe/dp2-ep4"
    want = mp.jax_run(name, weights)
    r = mp.ranks(got, name)[0]
    np.testing.assert_allclose(r["losses"], want["losses"],
                               atol=mp.LOSS_ATOL)
    np.testing.assert_allclose(r["params"].numpy(), want["params"].numpy(),
                               atol=mp.JAX_PARAM_ATOL, rtol=0)
    assert worker.rel(r["mu"], want["mu"]) < mp.MOMENT_REL
    assert worker.rel(r["nu"], want["nu"]) < mp.MOMENT_REL


@pytest.mark.parametrize("name", TRAIN)
def test_trainer_over_ep_equals_one_process(runs, name):
    got, weights = runs
    want = mp.one_process(name, weights)
    ranks = mp.ranks(got, name)
    assert len(ranks) == 8
    err = worker.compare(ranks[0], want)
    assert err["update"] < mp.UPDATE_REL, (name, err)
    assert max(err["mu"], err["nu"]) < mp.MOMENT_REL, (name, err)
    for r in ranks:
        assert max(abs(a - b) for a, b in zip(r["losses"], want["losses"])) \
            < mp.LOSS_ATOL, (name, r["losses"])
        assert r["digest"] == ranks[0]["digest"]


def test_cli_over_tp_sp_ep():
    """The CLI with --tp 2 --sp 2 --ep 2 --moe-experts 4 as 8 gloo ranks
    under the controller's env contract (TPU_WORKER_ID a process): dp is
    1, attention is the ring, rank 0 prints the headline and every rank
    exits 0."""
    ports = {worker.free_port()}
    while len(ports) < 2:
        ports.add(worker.free_port())
    coordinator, status = sorted(ports)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{coordinator}",
               TPU_NUM_PROCESSES="8", TPU_STATUS_PORT=str(status),
               PYTHONPATH=worker.ROOT)
    for k in ("TPU_LOCAL_RANK", "TPU_LAUNCHER", "TPU_SLOTS_PER_WORKER",
              "TPU_NUM_SLICES", "TPU_SLICE_ID", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m",
           "mpi_operator_tpu_torch.examples.lm_benchmark", "--size", "test",
           "--batch-per-device", "1", "--seq-len", "16", "--dtype",
           "float32", "--warmup-steps", "1", "--num-steps", "2", "--device",
           "cpu", "--tp", "2", "--sp", "2", "--ep", "2", "--moe-experts", "4"]
    procs = [subprocess.Popen(cmd, cwd=worker.ROOT,
                              env={**env, "TPU_WORKER_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(8)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 8, \
        [e[-2000:] for _, e in outs]
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")][-1]
    head = json.loads(line)
    assert head["metric"] == "gpt2_tokens_per_sec" and head["value"] > 0
    assert all(not o.strip() for o, _ in outs[1:])     # rank 0 prints
