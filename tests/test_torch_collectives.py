"""The port's mesh (`parallel/mesh.py`) and data-parallel collectives
(`parallel/collectives.py`) against the JAX package's, and the allreduce
harness (`examples/allreduce_bench.py`): the counterparts of the mesh,
collective and harness tests of tests/test_data_plane.py.

The JAX side runs on the conftest's 8 virtual CPU devices inside
shard_map; the port's side is a gang of 8 gloo processes, one rank a
device, each holding the shard its device holds. Each rank's output
must equal its device's (f32 summation order aside: rtol 1e-6,
atol 1e-6), the hierarchical mean the flat mean over 2 slices x 4 ranks
with an odd inner dim (33, zero-padded). The harness runs through its
CLI as a gang of 4 (the curve's structure) and alone (the empty curve).
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_operator_tpu.parallel import MeshConfig as JMeshConfig
from mpi_operator_tpu.parallel import make_mesh as jmake_mesh
from mpi_operator_tpu.parallel import collectives as jcol
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.utils.compat import shard_map
from mpi_operator_tpu_torch.parallel import collectives as tcol
from mpi_operator_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    # one thread a process: the suite runs beside other test processes
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_LAUNCHER",
              "TPU_NUM_SLICES", "TPU_SLICE_ID", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    return env


# the global arrays, row r (or rows 8r..8r+7 of z) rank r's shard; the
# gang's ranks run this source too (they import no JAX)
_INPUTS = """
def _inputs():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(8, 4).astype(np.float32),
            "y": rs.randn(8, 33).astype(np.float32),
            "z": rs.randn(64, 3).astype(np.float32),
            "w": rs.randn(8, 2).astype(np.float32),
            "b": rs.randn(8).astype(np.float32)}
"""
exec(_INPUTS)


_WORKER = "import numpy as np\n" + _INPUTS + """
import sys, torch, torch.distributed as dist
from mpi_operator_tpu_torch.parallel import collectives as c
from mpi_operator_tpu_torch.parallel.mesh import MeshConfig, make_mesh
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=8)
g = {k: torch.from_numpy(v) for k, v in _inputs().items()}
x, y = g["x"][rank:rank + 1], g["y"][rank:rank + 1]
z = g["z"][8 * rank:8 * rank + 8]
m8 = make_mesh(MeshConfig(dp=8))
m24 = make_mesh(MeshConfig(dp=4, dcn=2))
grads = c.allreduce_gradients({"w": g["w"][rank:rank + 1],
                               "b": g["b"][rank:rank + 1]}, m8, ("dp",))
res = {"mean": c.allreduce_mean(x, m8, "dp"),
       "sum": c.allreduce_sum(x, m8, ("dp",)),
       "gather": c.allgather(x, m8, "dp"),
       "gather_stack": c.allgather(x, m8, "dp", tiled=False),
       "bcast": c.broadcast(x, m8, "dp", root=3),
       "rs": c.reduce_scatter(z, m8, "dp"),
       "a2a": c.alltoall(z, m8, "dp"),
       "sharded": c.sharded_allreduce_fn(m8, ("dp",))(x.clone()),
       "grad_w": grads["w"], "grad_b": grads["b"],
       "hier": c.hierarchical_allreduce_mean(y, m24, ("dp",), "dcn"),
       "hier1": c.hierarchical_allreduce_mean(y, m8, ("dp",), "dcn"),
       "flat": c.allreduce_mean(y, m24, ("dcn", "dp")),
       "slice_mean": c.allreduce_mean(y, m24, "dp"),
       "dcn_mean": c.allreduce_mean(y, m24, "dcn"),
       "position": torch.tensor(m24.position())}
torch.save({k: v.numpy() for k, v in res.items()}, f"{out}-{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    """Every rank's results of the 8-rank gloo gang."""
    out = tmp_path_factory.mktemp("col") / "r"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(out)],
        cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(8)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    return [torch.load(f"{out}-{r}.pt", weights_only=False)
            for r in range(8)]


def _per_device(fn, mesh, spec, *args):
    """fn inside shard_map over `mesh`, each device's output stacked
    along axis 0 in device order."""
    f = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                  out_specs=spec, check_vma=False)
    placed = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
              for a in args]
    return np.asarray(jax.jit(f)(*placed))


def _stacked(results, key):
    return np.concatenate([r[key] for r in results])


@pytest.mark.parametrize("key,jfn", [
    ("mean", lambda v: jcol.allreduce_mean(v, ("dp",))),
    ("sum", lambda v: jcol.allreduce_sum(v, ("dp",))),
    ("gather", lambda v: jcol.allgather(v, "dp")),
    ("gather_stack", lambda v: jcol.allgather(v, "dp", tiled=False)),
    ("bcast", lambda v: jcol.broadcast(v, "dp", root=3)),
    ("sharded", lambda v: jcol.allreduce_mean(v, ("dp",))),
])
def test_collective_matches_jax_on_eight_devices(gang8, key, jfn):
    mesh = jmake_mesh(JMeshConfig.data_parallel(8))
    want = _per_device(jfn, mesh, P("dp"), _inputs()["x"])
    np.testing.assert_allclose(_stacked(gang8, key), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("key,jfn", [
    ("rs", lambda v: jcol.reduce_scatter(v, "dp")),
    ("a2a", lambda v: jcol.alltoall(v, "dp")),
])
def test_scatter_and_alltoall_match_jax(gang8, key, jfn):
    mesh = jmake_mesh(JMeshConfig.data_parallel(8))
    want = _per_device(jfn, mesh, P("dp"), _inputs()["z"])
    np.testing.assert_allclose(_stacked(gang8, key), want, rtol=RTOL,
                               atol=ATOL)


def test_allreduce_gradients_pytree(gang8):
    g = _inputs()
    for name in ("w", "b"):
        want = np.broadcast_to(g[name].mean(0, keepdims=True), g[name].shape)
        np.testing.assert_allclose(_stacked(gang8, f"grad_{name}"), want,
                                   rtol=RTOL, atol=ATOL)


def test_hierarchical_allreduce_matches_flat(gang8):
    """Over 2 slices x 4 ranks, an odd inner dim (33): the two-phase
    mean equals the flat mean, and both equal the JAX functions'; a
    mean over dp alone is each slice's, over dcn alone each column's.
    Over one slice of 8 (dcn of size 1) the two-phase mean is the mean
    over dp, as the reference's."""
    mesh = jmake_mesh(JMeshConfig(dp=4, dcn=2))
    y = _inputs()["y"]
    spec = P(("dcn", "dp"))
    flat = _per_device(lambda v: jax.lax.pmean(v, ("dcn", "dp")), mesh,
                       spec, y)
    hier = _per_device(lambda v: jcol.hierarchical_allreduce_mean(
        v, ici_axes=("dp",), dcn_axis="dcn"), mesh, spec, y)
    for key, want in (("hier", hier), ("flat", flat), ("hier", flat)):
        np.testing.assert_allclose(_stacked(gang8, key), want, rtol=1e-5,
                                   atol=1e-6)
    for key, axis in (("slice_mean", "dp"), ("dcn_mean", "dcn")):
        want = _per_device(lambda v, a=axis: jax.lax.pmean(v, a), mesh,
                           spec, y)
        np.testing.assert_allclose(_stacked(gang8, key), want, rtol=RTOL,
                                   atol=ATOL)
    assert [int(r["position"]) for r in gang8] == list(range(8))
    m8 = jmake_mesh(JMeshConfig.data_parallel(8))
    want = _per_device(lambda v: jcol.hierarchical_allreduce_mean(
        v, ici_axes=("dp",), dcn_axis="dcn"), m8, P("dp"), y)
    np.testing.assert_allclose(_stacked(gang8, "hier1"), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dp,slices", [(8, 1), (8, 2), (4, 1), (6, 3)])
def test_mesh_config_matches_the_reference(dp, slices):
    """MeshConfig.data_parallel, axis_sizes and num_devices read as the
    reference's; local_batch_size divides over the batch axes."""
    want = JMeshConfig.data_parallel(dp, num_slices=slices)
    got = tmesh.MeshConfig.data_parallel(dp, num_slices=slices)
    assert got.axis_sizes() == want.axis_sizes()
    assert got.num_devices == want.num_devices == dp
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    if dp == 8:
        jm = jmake_mesh(want)
        assert dict(jm.shape) == got.axis_sizes()
        assert jmesh.local_batch_size(64, jm) == 8


def test_gang_of_one_mesh_and_its_collectives_are_the_identity():
    """A process that joined no group gets a valid mesh of one; every
    collective over it is the identity, and the wrong device count
    raises as the reference's make_mesh does."""
    mesh = tmesh.make_mesh(tmesh.MeshConfig.data_parallel(1))
    assert mesh.size == 1 and mesh.shape["dp"] == 1 and mesh.position() == 0
    assert tmesh.local_batch_size(64, mesh) == 64
    assert mesh.group(("dcn", "dp")) is None
    x = torch.arange(12.0).view(4, 3)
    for out in (tcol.allreduce_mean(x, mesh), tcol.allreduce_sum(x, mesh),
                tcol.allgather(x, mesh, "dp"), tcol.broadcast(x, mesh, "dp"),
                tcol.reduce_scatter(x, mesh, "dp"),
                tcol.alltoall(x, mesh, "dp"),
                tcol.hierarchical_allreduce_mean(x, mesh)):
        assert torch.equal(out, x)
    assert tcol.allgather(x, mesh, "dp", tiled=False).shape == (1, 4, 3)
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(tmesh.MeshConfig(dp=4))        # 4 != 1
    with pytest.raises(ValueError, match="devices"):
        jmake_mesh(JMeshConfig(dp=4))                  # 4 != 8
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.local_batch_size(3, tmesh.Mesh(tmesh.MeshConfig(dp=2), [0, 1]))


@pytest.mark.parametrize("axis,step", [("fsdp", "10b"), ("tp", "10c"),
                                       ("sp", "10c"), ("ep", "10c"),
                                       ("pp", "10d")])
def test_mesh_refuses_the_axes_of_later_steps(axis, step):
    """pp, still ROADMAP.md step 10d, raises naming it; the axes of the
    steps done (10b: fsdp; 10c: tp, sp, ep) lay a mesh over two ranks,
    whose coordinates run along that axis."""
    if axis == "pp":
        with pytest.raises(ValueError, match=f"step {step}"):
            tmesh.make_mesh(tmesh.MeshConfig(**{axis: 2}), ranks=[0, 1])
        return
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**{axis: 2}), ranks=[0, 1])
    assert mesh.shape[axis] == 2 and mesh.size == 2
    assert [mesh.coords(r)[axis] for r in (0, 1)] == [0, 1]


def _bench(world, tmp_path):
    """examples/allreduce_bench.py's CLI as `world` gloo ranks on the
    env contract; rank 0's JSON line."""
    env = dict(_env(), TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               TPU_NUM_PROCESSES=str(world))
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
           "allreduce_bench", "--device", "cpu", "--payload-mb", "0.25",
           "--iters", "2"]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, **(
        {"TPU_WORKER_ID": str(r)} if world > 1 else {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert all(not o.strip() for o, _ in outs[1:])     # rank 0 prints
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_allreduce_bench_curve_structure(tmp_path):
    """Over a gang of 4: a point for 1, 2 and 4 devices with positive
    times and rates, the efficiency relative to the smallest multi-device
    ring (2 -> 1.0), the worst of it as the value; alone: the n = 1
    point and an empty curve, said so, and no score."""
    result = _bench(4, tmp_path)
    assert [p["devices"] for p in result["points"]] == [1, 2, 4]
    for p in result["points"]:
        assert p["time_ms"] > 0 and p["algbw_gbs"] > 0
        n = p["devices"]
        # both rounded to 3 decimals
        assert p["busbw_gbs"] == pytest.approx(
            p["algbw_gbs"] * (2 * (n - 1) / n if n > 1 else 1), abs=2e-3)
    curve = result["efficiency_curve"]
    assert set(curve) == {"2", "4"} and curve["2"] == 1.0
    assert result["value"] == min(curve.values())
    assert result["world"] == 4 and result["backend"] == "gloo"
    alone = _bench(1, tmp_path)
    assert [p["devices"] for p in alone["points"]] == [1]
    assert alone["efficiency_curve"] == "insufficient devices (need >1)"
    assert alone["value"] is None
