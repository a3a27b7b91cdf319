"""The port's sharding rules (`parallel/sharding.py`) and mesh layout
(`parallel/mesh.py`) against the JAX package's, on the conftest's 8
virtual devices; no process group is needed.

- Every parameter of gpt2, llama, bert and the MoE config gets the
  spec the reference's `param_shardings` gives its flax leaf, on meshes
  that shard every rule's axis, including the replicated non-divisible
  cases (H26: 4 heads on tp = 8, a vocab that tp x fsdp does not
  divide, experts that ep does not divide).
- A placement's local shape is the global shape split over tp and ep
  only (fsdp shards the trainer's flat buffer instead).
- Rank r of the port's mesh holds device r's coordinates on the JAX
  mesh, for every axis order the tests use.
- `shard_init` draws exactly `init_params`' values and keeps the rank's
  blocks; from a state dict it slices the same blocks.
- The rules' helpers (`logical_to_spec`, `tp_manual_spec`,
  `tp_overlap_activation_spec`, `path_match`, `spec_for_path`,
  `sharding_for_path`) give the reference's specs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
jsh = importlib.import_module("mpi_operator_tpu.parallel.sharding")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
tconv = importlib.import_module("mpi_operator_tpu_torch.models.convert")
tmesh = importlib.import_module("mpi_operator_tpu_torch.parallel.mesh")
tsh = importlib.import_module("mpi_operator_tpu_torch.parallel.sharding")

#: the model configs, by name: (JAX config, port config); vocab 100 does
#: not divide tp x fsdp = 8, 96 does
_COMMON = dict(vocab_size=96, max_len=32)


def _configs():
    out = {}
    for name, jfn, tfn, kw in (
            ("gpt2", jt.gpt2_config, tt.gpt2_config, {}),
            ("llama", jt.llama_config, tt.llama_config, {}),
            ("bert", jt.bert_config, tt.bert_config, {}),
            ("moe", jt.gpt2_config, tt.gpt2_config, dict(num_experts=4)),
            ("moe6-vocab100", jt.gpt2_config, tt.gpt2_config,
             dict(num_experts=6, vocab_size=100))):
        common = {**_COMMON, **kw}
        out[name] = (jfn("test", **common), tfn("test", **common))
    return out


MESHES = [dict(dp=2, fsdp=2, tp=2), dict(tp=8), dict(fsdp=8),
          dict(dp=2, ep=4), dict(ep=2, tp=4), dict(dp=2, sp=2, tp=2),
          dict(fsdp=2, ep=2, tp=2)]


def _jax_specs(jcfg, mesh):
    """{flax path: spec tuple} of the reference's param_shardings."""
    model = (jt.CausalLM if jcfg.causal else jt.MaskedLM)(jcfg)
    abstract = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((2, 8), jnp.int32)), jax.random.PRNGKey(0))
    tree = jsh.param_shardings(mesh, abstract)["params"]
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {tuple(k.key for k in path): tuple(s.spec) for path, s in flat}


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("sizes", MESHES,
                         ids=["-".join(f"{k}{v}" for k, v in m.items())
                              for m in MESHES])
@pytest.mark.parametrize("name", list(_configs()))
def test_specs_equal_the_reference(name, sizes):
    """Each port parameter's spec equals the reference's for its flax
    leaf; every flax leaf has its port parameter."""
    jcfg, tcfg = _configs()[name]
    jmesh = jpar.make_mesh(jpar.MeshConfig(**sizes))
    want = _jax_specs(jcfg, jmesh)
    mesh = tmesh.Mesh(tmesh.MeshConfig(**sizes), range(8))
    got = tsh.param_shardings(mesh, tcfg)
    assert list(got) == list(tt.param_shapes(tcfg))
    assert {p.path[:-1] + (p.path[-1],) for p in got.values()} == set(want)
    for pname, p in got.items():
        n = len(p.spec)
        assert _pad(want[p.path], n) == p.spec, (pname, p.path)
        assert tuple(p.shape) == tt.param_shapes(tcfg)[pname]


def test_non_divisible_dims_replicate():
    """H26: 4 heads on tp = 8 leave q/k/v/out replicated (no tp block),
    a vocab of 100 on tp x fsdp = 8 leaves the table whole, 6 experts on
    ep = 4 stay on every rank; what divides splits."""
    _, tcfg = _configs()["moe6-vocab100"]
    mesh = tmesh.Mesh(tmesh.MeshConfig(tp=8), range(8))
    p = tsh.param_shardings(mesh, tcfg)
    q = p["backbone.blocks.0.attn.query.weight"]
    assert q.spec[1:] == (None, None) and q.local_shape == q.shape
    assert p["wte.weight"].local_shape == (100, 128)
    fc = p["backbone.blocks.0.mlp.fc_in.weight"]
    assert fc.port_spec[0] == "tp" and fc.local_shape == (512 // 8, 128)
    mesh = tmesh.Mesh(tmesh.MeshConfig(dp=2, ep=4), range(8))
    p = tsh.param_shardings(mesh, tcfg)
    w_in = p["backbone.blocks.1.moe.w_in"]
    assert w_in.spec[0] is None and w_in.local_shape == (6, 128, 512)
    _, tcfg = _configs()["moe"]
    p = tsh.param_shardings(mesh, tcfg)
    assert p["backbone.blocks.1.moe.w_in"].local_shape == (1, 128, 512)
    assert p["backbone.blocks.1.moe.router.weight"].local_shape == (1, 128)
    assert p["wte.weight"].local_shape == (96, 128)


def test_local_shapes_split_over_tp_and_ep_only():
    """fsdp leaves the port's block whole (the trainer shards its flat
    buffer); tp splits heads, mlp and vocab."""
    _, tcfg = _configs()["gpt2"]
    mesh = tmesh.Mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2), range(8))
    p = tsh.param_shardings(mesh, tcfg)
    assert p["wte.weight"].spec == (("tp", "fsdp"), None)
    assert p["wte.weight"].local_shape == (48, 128)
    assert p["backbone.blocks.0.attn.query.weight"].local_shape == (64, 128)
    assert p["backbone.blocks.0.attn.out.weight"].local_shape == (128, 64)
    assert p["backbone.blocks.0.attn.out.bias"].local_shape == (128,)
    assert p["backbone.blocks.0.mlp.fc_out.weight"].local_shape == (128, 256)
    mesh = tmesh.Mesh(tmesh.MeshConfig(fsdp=8), range(8))
    for q in tsh.param_shardings(mesh, tcfg).values():
        assert q.local_shape == q.shape


@pytest.mark.parametrize("sizes", [dict(dp=2, fsdp=2, tp=2),
                                   dict(dcn=2, dp=2, sp=2),
                                   dict(dp=2, ep=2, tp=2), dict(sp=8)])
def test_rank_r_holds_device_rs_coordinates(sizes):
    jm = jpar.make_mesh(jpar.MeshConfig(**sizes))
    mesh = tmesh.Mesh(tmesh.MeshConfig(**sizes), range(8))
    order = jpar.mesh.AXIS_ORDER
    assert tuple(jm.axis_names) == order == tmesh.AXIS_ORDER
    for pos in np.ndindex(*jm.devices.shape):
        r = jm.devices[pos].id
        assert tuple(mesh.coords(r)[a] for a in order) == pos


def test_mesh_refuses_pp_and_bad_sizes():
    with pytest.raises(ValueError, match="step 10d"):
        tmesh.make_mesh(tmesh.MeshConfig(pp=2), ranks=[0, 1])
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(tmesh.MeshConfig(tp=3), ranks=[0, 1])
    mesh = tmesh.make_mesh(tmesh.MeshConfig(fsdp=2, tp=2),
                           ranks=range(4))
    assert mesh.size == 4 and mesh.group(("tp",)) is None
    assert [mesh.index(("tp",), r) for r in range(4)] == [0, 1, 0, 1]
    assert [mesh.index(("fsdp",), r) for r in range(4)] == [0, 0, 1, 1]


@pytest.mark.parametrize("name", ["gpt2", "llama", "moe"])
def test_shard_init_keeps_the_ranks_blocks(name):
    """From a seed the blocks are init_params' values (drawn whole, in
    order); from a state dict the same blocks; stitched back over tp and
    ep they are the whole parameter."""
    _, tcfg = _configs()[name]
    sizes = dict(dp=2, ep=2, tp=2) if name == "moe" else dict(fsdp=2, tp=4)
    mesh = tmesh.Mesh(tmesh.MeshConfig(**sizes), range(8))
    whole = tconv.init_params(tcfg, torch.Generator().manual_seed(3))
    place = tsh.param_shardings(mesh, tcfg)
    blocks = {}
    for r in range(8):
        c = mesh.coords(r)
        got = {n: tsh.local_block(t, place[n], c, mesh.shape)
               for n, t in whole.items()}
        blocks[(c["tp"], c["ep"])] = got
        for n, t in got.items():
            assert tuple(t.shape) == place[n].local_shape
    for n, p in place.items():
        d_tp, d_ep = p.split("tp"), p.split("ep")
        ts, es = mesh.shape["tp"], mesh.shape["ep"]
        x = torch.cat([torch.cat([blocks[(i, j)][n] for i in range(ts)],
                                 d_tp) if d_tp is not None
                       else blocks[(0, j)][n] for j in range(es)],
                      d_ep) if d_ep is not None else (
            torch.cat([blocks[(i, 0)][n] for i in range(ts)], d_tp)
            if d_tp is not None else blocks[(0, 0)][n])
        assert torch.equal(x, whole[n]), n
    # shard_init itself, this process at coordinate 0 of every axis
    drawn = tsh.shard_init(tcfg, mesh, seed=3)
    given = tsh.shard_init(tcfg, mesh, state_dict=whole)
    for n in whole:
        assert torch.equal(drawn[n], blocks[(0, 0)][n])
        assert torch.equal(given[n], blocks[(0, 0)][n])


def test_rule_helpers_equal_the_reference():
    jm = jpar.make_mesh(jpar.MeshConfig(dp=2, fsdp=2, tp=2))
    mesh = tmesh.Mesh(tmesh.MeshConfig(dp=2, fsdp=2, tp=2), range(8))
    for axes in (("embed", "heads", "kv"), ("embed", "embed"),
                 ("vocab", "embed"), ("expert", "embed", "expert_mlp"),
                 ("batch", "seq", "embed"), (None, "pos"), ("norm",)):
        assert tsh.logical_to_spec(axes) == _pad(
            tuple(jsh.logical_to_spec(axes)), len(axes))
        assert tsh.tp_manual_spec(axes) == _pad(
            tuple(jsh.tp_manual_spec(axes)), len(axes))
        assert tsh.logical_to_spec(axes, tsh.ACTIVATION_RULES) == _pad(
            tuple(jsh.logical_to_spec(axes, jsh.ACTIVATION_RULES)),
            len(axes))
    for rank in (2, 3):
        assert tsh.tp_overlap_activation_spec(rank) == tuple(
            jsh.tp_overlap_activation_spec(rank))
    rules = [((r"block_\d+", "attn", ".*", "kernel"), ("fsdp", "tp", None)),
             (("wte",), None)]
    for path, shape in ((("params", "backbone", "block_3", "attn", "query",
                          "kernel"), (128, 4, 32)),
                        (("params", "wte", "embedding"), (96, 128)),
                        (("params", "backbone", "ln_f", "scale"), (128,))):
        assert tsh.path_match(("attn", "query"), path) == \
            jsh.path_match(("attn", "query"), path)
        want = jsh.spec_for_path(path, rules)
        assert tsh.spec_for_path(path, rules) == (
            None if want is None else tuple(want))
        js = jsh.sharding_for_path(jm, path, rules, shape)
        ps = tsh.sharding_for_path(mesh, path, rules, shape)
        assert (ps is None) == (js is None)
        if js is not None:
            assert ps == _pad(tuple(js.spec), len(ps))
