"""The port's ViT (`ViT`, `vit_config`, `create_vit`,
`vit_params_from_flax`) against the JAX package's flax ViT, on the CPU:
`vit_config("test")` (2 layers, E=128, H=4) at 32 px with patch 4, so
S = 64 patches + cls = 65 tokens, one past a 64-row tile (ragged, as
ViT-B/16's S = 197 is on the card).

Same weights on both sides (flax params with biases, norm scales, `cls`
and the position table moved off their init) and the same numpy
images. Attention dense and flash (the reference's Pallas kernels in
interpret mode; the port's plain K1-K3 behind its autograd Function),
non-causal, no mask. f32 tolerances as the LM parity tests (summation
order only): logits atol 1e-4, loss 1e-5, gradients 2e-5; bf16 logits by
relative error under 2e-2.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")
tflops = importlib.import_module("mpi_operator_tpu_torch.utils.flops")

IMG, P, CLASSES, B = 32, 4, 10, 4
LOGIT_ATOL, LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-5, 2e-5


def _models(attention="dense", dtype="float32"):
    jm = jt.ViT(jt.vit_config("test", attention=attention,
                              dtype=getattr(jnp, dtype)),
                num_classes=CLASSES, patch_size=P)
    cfg = tt.vit_config("test", attention=attention,
                        dtype=getattr(torch, dtype))
    return jm, cfg


@functools.lru_cache(maxsize=None)
def _tree(seed=0):
    """flax ViT params (numpy), every bias, scale, cls and pos entry
    moved off its init."""
    jm, _ = _models()
    from flax.core import meta
    v = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, IMG, IMG, 3))))
    rs = np.random.RandomState(seed + 1)

    def walk(node, path=()):
        out = {}
        for k, val in node.items():
            if isinstance(val, dict):
                out[k] = walk(val, path + (k,))
                continue
            a = np.array(val, np.float32)
            if k in ("bias", "scale", "cls") or "pos" in path:
                a = a + 0.1 * rs.randn(*a.shape).astype(np.float32)
            out[k] = a
        return out
    return walk(jax.tree.map(np.asarray, v["params"]))


def _port(cfg, tree):
    with torch.device("meta"):
        model = tt.ViT(cfg, num_classes=CLASSES, patch_size=P,
                       image_size=IMG)
    model.load_state_dict(convert.vit_params_from_flax(cfg, tree),
                          assign=True)
    return model


def _images(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, IMG, IMG, 3).astype(np.float32),
            rs.randint(0, CLASSES, B))


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_logits_and_grads_match_flax(attention):
    """ViT(images) logits, the mean cross-entropy and its gradients
    (patch embedding, cls, positions, backbone, head) against flax."""
    jm, cfg = _models(attention)
    tree = _tree()
    x, labels = _images()

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x))
        ce = -jax.nn.log_softmax(logits)[jnp.arange(B), labels].mean()
        return ce, logits
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    model = _port(cfg, tree)
    logits = model(torch.from_numpy(x), train=True)
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(labels))
    loss.backward()
    assert logits.shape == (B, CLASSES) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jl), atol=LOSS_ATOL)
    want = convert.vit_params_from_flax(cfg, jax.tree.map(np.asarray,
                                                          jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_vit_bf16_logits_match_flax():
    """bf16 compute (the patch GEMM, backbone and casts in bf16, the head
    in f32): logits by relative error."""
    jm, cfg = _models("dense", "bfloat16")
    tree = _tree()
    x, _ = _images(1)
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(x)), np.float64)
    with torch.no_grad():
        got = _port(cfg, tree)(torch.from_numpy(x)).double().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_vit_shapes_init_and_flop_count():
    """ViT-B/16 at 224 px has a 197-row position table (not max_len) and
    the reference's parameter names and shapes (flax's init of the test
    config converts onto the port's names); create_vit draws cls and
    biases zero, norm scales one; the analytic FLOP count is the
    backbone's 6N + attention over 197 tokens plus the patch GEMM and the
    head."""
    with torch.device("meta"):
        b16 = tt.ViT(tt.vit_config("b16"))
    assert b16.pos.num_embeddings == 197
    assert b16.patch_embed.weight.shape == (768, 16 * 16 * 3)
    nb = sum(p.numel() for p in b16.backbone.parameters())
    assert 85.0e6 < nb < 85.3e6
    per_image = tflops.vit_train_flops_per_image(
        nb, 12, 768, 196, 768, 1000)
    want = 197 * (6 * nb + 12 * 12 * 768 * 197) + 6 * 196 * 768 * 768 \
        + 6 * 768 * 1000
    assert per_image == pytest.approx(want)
    assert 1.04e11 < per_image < 1.07e11
    model = tt.create_vit("vit-test", num_classes=CLASSES, device="cpu",
                          patch_size=P, image_size=IMG)
    assert not model.cls.any() and not model.head.bias.any()
    assert torch.equal(model.backbone.ln_f.weight,
                       torch.ones_like(model.backbone.ln_f.weight))
    _, cfg = _models()
    conv = convert.vit_params_from_flax(cfg, _tree())
    sd = model.state_dict()
    assert set(conv) == set(sd)
    assert all(tuple(conv[k].shape) == tuple(sd[k].shape) for k in sd)
    with pytest.raises(ValueError, match="position table"):
        model(torch.zeros(1, 16, 16, 3))
