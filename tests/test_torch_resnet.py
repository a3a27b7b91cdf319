"""The port's ResNet (mpi_operator_tpu_torch/models/resnet.py) against the
JAX package's flax ResNet, on the CPU at 32 px: resnet18 (basic blocks)
and a bottleneck ResNet with one block a stage, both stems, the same
weights (converted by `resnet_params_from_flax`) and the same numpy
images.

f32 is compared at atol 2e-4 on logits (|logits| ~ 1-10 after 8-18
layers of f32 convs summed in another order) and rtol 1e-4 / atol 1e-5
on the running statistics; bf16 by relative error ||port - flax|| /
||flax|| <= 2e-2 (a few bf16 ulps through every layer).

Hazards: H1 (flax pads a stride-2 SAME window on an even input by
(0, 1), the max-pool with -inf), H2 (momentum 0.9 keeps 0.9 of the
running value; the last BN of a block starts at scale 0; statistics in
f32 under bf16) and H11 (flax folds the BIASED batch variance into the
running average, torch.nn.BatchNorm2d the unbiased one).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from mpi_operator_tpu.models import resnet as jres
from mpi_operator_tpu_torch.models import convert
from mpi_operator_tpu_torch.models import resnet as tres

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

IMG, CLASSES, B = 32, 10, 4
BLOCKS = {"basic": ("resnet18", None), "bottleneck": (None, [1, 1, 1, 1])}


def flax_model(block, stem, dtype=jnp.float32):
    name, stages = BLOCKS[block]
    if name:
        return jres.create_model(name, num_classes=CLASSES, dtype=dtype,
                                 stem=stem)
    return jres.ResNet(stage_sizes=stages,
                       block_cls=jres.BottleneckResNetBlock,
                       num_classes=CLASSES, dtype=dtype, stem=stem)


def port_model(block, stem, dtype=torch.float32):
    name, stages = BLOCKS[block]
    stages, cls = (tres._STAGES[name] if name
                   else (stages, tres.BottleneckResNetBlock))
    with torch.device("meta"):
        return tres.ResNet(stages, cls, num_classes=CLASSES, dtype=dtype,
                           stem=stem)


@functools.lru_cache(maxsize=None)
def flax_init(block, stem, seed=0):
    """flax's own init of the model, as numpy trees."""
    v = jax.jit(flax_model(block, stem).init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3)), train=False)
    return jax.tree.map(np.asarray, dict(v))


@functools.lru_cache(maxsize=None)
def variables(block, stem, seed=0):
    """flax params and batch_stats as numpy trees, every BN scale, bias,
    mean and var moved off its init (so the zero-scale BNs pass their
    branch and eval reads real statistics)."""
    v = flax_init(block, stem, seed)
    rs = np.random.RandomState(seed + 1)

    def walk(node):
        out = {}
        for k, val in node.items():
            if isinstance(val, dict):
                out[k] = walk(val)
                continue
            a = np.array(val, np.float32)
            if k in ("scale", "bias", "mean"):
                a = a + 0.2 * rs.randn(*a.shape).astype(np.float32)
            elif k == "var":
                a = a * rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(v["params"]), walk(v["batch_stats"])


def loaded(block, stem, dtype=torch.float32):
    params, stats = variables(block, stem)
    model = port_model(block, stem, dtype)
    model.load_state_dict(convert.resnet_params_from_flax(
        model, params, stats), assign=True)
    return model


def images(seed=0, n=B):
    return np.random.RandomState(seed).randn(n, IMG, IMG, 3).astype(
        np.float32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def flat_stats(tree, model):
    """flax batch_stats in the port's `new_batch_stats()` order."""
    conv = convert.resnet_params_from_flax(
        model, variables(*model._key)[0], tree)
    return np.concatenate([conv[n].numpy().ravel()
                           for n, _ in model.named_buffers()])


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_flax_f32(block, stem, train):
    """Logits in train and eval mode, and in train mode the new running
    statistics, equal flax's (apply with mutable batch_stats)."""
    params, stats = variables(block, stem)
    x = images()
    jm = flax_model(block, stem)
    if train:
        want, mut = jax.jit(lambda v: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats})
    else:
        want = jax.jit(lambda v: jm.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats})
    model = loaded(block, stem)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    if train:
        model._key = (block, stem)
        new = model.new_batch_stats().numpy()
        np.testing.assert_allclose(
            new, flat_stats(jax.tree.map(np.asarray,
                                         mut["batch_stats"]), model),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("block,stem", [("basic", "s2d"),
                                        ("bottleneck", "conv7")])
def test_grads_match_flax_f32(block, stem):
    """The gradients of the mean cross-entropy of a train-mode forward
    (through the batch statistics) equal jax.grad's, every parameter at
    a relative error under 1e-3."""
    params, stats = variables(block, stem)
    x = images(1)
    labels = np.arange(B) % CLASSES
    jm = flax_model(block, stem)

    def loss_fn(p):
        logits, _ = jm.apply({"params": p, "batch_stats": stats}, x,
                             train=True, mutable=["batch_stats"])
        return -jax.nn.log_softmax(logits)[jnp.arange(B), labels].mean()
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = loaded(block, stem)
    loss = torch.nn.functional.cross_entropy(
        model(torch.from_numpy(x), train=True), torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(jloss)) < 1e-5
    want = convert.resnet_params_from_flax(
        model, jax.tree.map(np.asarray, jgrads), stats)
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), want[name].numpy()) < 1e-3, name


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_logits_match_flax(block, stem, train):
    """bf16 compute over f32 params and statistics: logits by relative
    error. (bf16 gradients are not compared here: at 32 px the last
    stage's BN normalises over B x 1 x 1 = 4 values, where bf16
    rounding of the features moves the gradients by tens of per cent on
    both sides; the f32 test above holds the backward.)"""
    params, stats = variables(block, stem)
    x = images(1)
    jm = flax_model(block, stem, jnp.bfloat16)
    # eager, as the reference's bf16 rounds at every op: under jit XLA's
    # CPU fusions keep some bf16 intermediates in f32
    want = jm.apply({"params": params, "batch_stats": stats}, x,
                    train=train, mutable=["batch_stats"])[0]
    model = loaded(block, stem, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < 2e-2


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (31, 3, 2), (16, 1, 2),
                                   (8, 2, 1), (112, 3, 2), (56, 3, 1),
                                   (7, 3, 2)])
def test_same_padding_is_xlas(n, k, s):
    """H1: the padding same_pad applies (F.pad or the conv's own) equals
    XLA's SAME for the conv, on even and odd sizes: the outputs of a
    strided conv agree with lax.conv_general_dilated(..., "SAME")."""
    rs = np.random.RandomState(n + k + s)
    x = rs.randn(1, n, n, 2).astype(np.float32)
    w = rs.randn(k, k, 2, 3).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = tres.Conv(2, 3, k, s, torch.float32)
    conv.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    assert tres._same(n, k, s) == ((0, 1) if (n % 2 == 0 and s == 2
                                              and k == 3) else
                                   tres._same(n, k, s))


def test_max_pool_pads_with_minus_infinity():
    """H1: the stem's 3x3/2 SAME max-pool on an even input pads (0, 1)
    with -inf: on all-negative inputs a zero pad (or torch's symmetric
    padding=1) would give other maxima."""
    x = -1.0 - np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    xp, pad = tres.same_pad(t, 3, 2, value=float("-inf"))
    got = torch.nn.functional.max_pool2d(xp, 3, 2, padding=pad)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    sym = torch.nn.functional.max_pool2d(t, 3, 2, padding=1)
    assert not np.array_equal(sym.permute(0, 2, 3, 1).numpy(),
                              np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_running_stats_equal_flax_after_three_steps(dtype):
    """H2 and H11: three train-mode forwards on three batches, each
    folding its statistics in (flax: the mutated batch_stats fed back;
    the port: commit_batch_stats), leave the port's running mean and
    var equal to flax's — the biased variance at momentum 0.9, in f32
    under either compute dtype. torch.nn.BatchNorm2d's own update (the
    unbiased variance) is shown to differ."""
    block, stem = "bottleneck", "s2d"
    params, stats = variables(block, stem)
    jm = flax_model(block, stem, getattr(jnp, dtype))
    model = loaded(block, stem, getattr(torch, dtype))
    model._key = (block, stem)
    jstats = stats
    for step in range(3):
        x = images(10 + step)
        _, mut = jm.apply({"params": params, "batch_stats": jstats}, x,
                          train=True, mutable=["batch_stats"])
        jstats = jax.tree.map(np.asarray, mut["batch_stats"])
        with torch.no_grad():
            model(torch.from_numpy(x), train=True)
        model.commit_batch_stats()
    got = torch.cat([b.reshape(-1) for _, b in model.named_buffers()])
    want = flat_stats(jstats, model)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:       # statistics of bf16 features that differ by bf16 ulps
        assert rel(got.numpy(), want) < 2e-3
    # torch's BatchNorm2d on the stem's features folds n / (n - 1) var
    feats = torch.randn(B, 8, 4, 4)
    bn = torch.nn.BatchNorm2d(8, momentum=0.1)
    bn(feats)
    ours = tres.BatchNorm(8, torch.float32)
    ours.weight.data.fill_(1.0)
    ours.bias.data.zero_()
    ours.running_mean.zero_()
    ours.running_var.fill_(1.0)
    with torch.no_grad():
        ours(feats, train=True)
    n = B * 4 * 4
    biased = feats.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.pending[1].numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased * n / (n - 1)).numpy(),
                               rtol=1e-5)
    assert not torch.allclose(bn.running_var, ours.pending[1], rtol=1e-4)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_init_zero_scales_and_shapes_come_across(block):
    """H2: the port's draw (create_model's `init_resnet`) has the
    reference's shapes, the zero scale on the last BN of every block
    (and only there), unit running var and zero running mean; flax's
    init converts onto the same names and shapes."""
    model = port_model(block, "conv7")
    drawn = tres.init_resnet(model, torch.Generator().manual_seed(0),
                             device="cpu")
    jv = flax_init(block, "conv7")
    conv = convert.resnet_params_from_flax(model, jv["params"],
                                           jv["batch_stats"])
    assert set(conv) == set(drawn) == set(model.state_dict())
    for k, t in drawn.items():
        assert tuple(t.shape) == tuple(conv[k].shape), k
        if t.dim() == 1 and not k.endswith(".bias"):   # BN scale, stats
            assert torch.equal(t, conv[k]), k
    zeros = [k for k, t in drawn.items() if k.endswith(".weight")
             and t.dim() == 1 and not t.any()]
    last = "bn1" if block == "basic" else "bn2"
    assert zeros and all(k.endswith(f"{last}.weight") for k in zeros)
    assert len(zeros) == len(model.blocks)
    if block == "basic":       # the entry point draws the same on the CPU
        built = tres.create_model("resnet18", num_classes=CLASSES,
                                  device="cpu", seed=0)
        for k, t in built.state_dict().items():
            assert torch.equal(t, drawn[k]), k
