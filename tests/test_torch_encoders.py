"""The port's pixels-in encoders against the reference's flax modules, with
the reference's own parameters converted: ResNet-50 at full depth (JAX
initialized, non-trivial batch-norm statistics) and VGG-19 on the trained
``results/enc_pretrain_v3_r4/encoder_params.npz``; the input
normalizations; the flax ↔ state_dict converter.

Tolerance: 1e-4 x max|ref| in float32 (float32 sums in another order,
compounded over 16 to 53 layers). bfloat16 runs against the reference in
bfloat16: both round at the same points, so only a float32 sum taken in
another order flips a rounding, which the layers carry on; the bounds there
are stated beside each test.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg.models.resnet import ResNet50Features as JaxResNet50
from sgg.models.vgg import VGG19Features as JaxVGG19
from sgg.models.vgg import load_npy_weights as jax_load_npy_weights
from sgg.train.pretrain import load_params_npz as jax_load_params_npz
from sgg_torch.convert_flax import (
    encoder_flax_to_state_dict,
    encoder_state_dict_to_flax,
    load_params_npz,
)
from sgg_torch.models.encoders import make_encoder, normalize_for
from sgg_torch.kernels.conv import fold_batchnorm, max_pool_nhwc
from sgg_torch.models.resnet import ResNet50Features
from sgg_torch.models.vgg import VGG19Features, conv_names, load_npy_weights
from sgg_torch.models.vit import ViTB16Features

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_VGG = os.path.join(REPO, "results", "enc_pretrain_v3_r4", "encoder_params.npz")


def _randomize_bn(tree, r):
    """Give every BN vector non-trivial statistics, so folding is tested."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, r)
            continue
        v = np.asarray(v)
        n = v.shape
        out[k] = {
            "bn_scale": lambda: 1.0 + 0.2 * r.randn(*n),
            "bn_bias": lambda: 0.1 * r.randn(*n),
            "bn_mean": lambda: 0.1 * r.randn(*n),
            "bn_var": lambda: 0.5 + r.rand(*n),
        }.get(k, lambda: v)().astype(np.float32)
    return out


@pytest.fixture(scope="module")
def resnet_params():
    init = jax.jit(JaxResNet50().init)
    p = init(jax.random.key(0), jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
    return {"params": _randomize_bn(jax.tree.map(np.asarray, p), np.random.RandomState(1))}


def _images(size, batch, seed):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(np.float32)


# (image size, the port's conv route, the reference's route): the port's
# kernel routes against the reference's default (XLA) route, and the direct
# routes against each other (the reference's through its Pallas kernels in
# interpret mode).
@pytest.mark.parametrize("size,impl,ref_impl", [
    (32, "auto", None), (32, "pallas", None), (32, "xla", None), (32, "direct", "direct"),
    (64, "auto", None),
])
def test_resnet50_matches_reference(resnet_params, size, impl, ref_impl):
    x = _images(size, 2, seed=size)
    want = np.asarray(JaxResNet50(conv_impl=ref_impl).apply(resnet_params, jnp.asarray(x)))
    model = ResNet50Features(conv_impl=impl)
    model.load_state_dict(encoder_flax_to_state_dict(resnet_params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (size // 32) ** 2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bf16_agrees(got, want, max_tol, l2_tol):
    """Within max_tol x max|want| everywhere and l2_tol in relative L2."""
    return np.abs(got - want).max() <= max_tol * np.abs(want).max() and _rel_l2(got, want) <= l2_tol


@pytest.fixture(scope="module")
def resnet_bf16(resnet_params):
    """The reference's bfloat16 output of the stem and of each bottleneck
    block on two 64 px images."""
    x = _images(64, 2, seed=100)
    _, inter = JaxResNet50(dtype=jnp.bfloat16).apply(
        resnet_params, jnp.asarray(x), capture_intermediates=True, mutable=["intermediates"])
    inter = inter["intermediates"]
    outs = {n: np.asarray(v["__call__"][0].astype(jnp.float32))
            for n, v in inter.items() if n != "__call__"}
    return x, outs


def _bf16(a):
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _resnet50_bf16_blocks(resnet_params, resnet_bf16, impl):
    """(block, port, reference) for the stem and each bottleneck block, each
    block fed the reference's bf16 output of the block before it, so a
    rounding flip does not carry from block to block."""
    x, want = resnet_bf16
    model = ResNet50Features(conv_impl=impl, dtype=torch.bfloat16)
    model.load_state_dict(encoder_flax_to_state_dict(resnet_params))
    out = []
    with torch.no_grad():
        got = model.stem(_bf16(x))
        out.append(("stem", got, want["stem"]))
        prev = max_pool_nhwc(_bf16(want["stem"]), 3, 2, "SAME")
        for name in model.blocks:
            got = getattr(model, name)(prev)
            out.append((name, got, want[name]))
            prev = _bf16(want[name])
    return [(n, g.float().numpy(), w) for n, g, w in out]


def _blocks_agree(blocks):
    """Per block: at most 1 % of the elements differ from the reference at
    all (a flipped rounding moves one element by an ulp), and rel L2 <= 1e-3."""
    return all((g != w).mean() <= 1e-2 and _rel_l2(g, w) <= 1e-3 for _, g, w in blocks)


# ResNet-50 in bfloat16 against the reference in bfloat16, block by block.
# A misplaced cast moves 15 % or more of a block's elements (below).
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_resnet50_bf16_blocks_match_reference_bf16(resnet_params, resnet_bf16, impl):
    blocks = _resnet50_bf16_blocks(resnet_params, resnet_bf16, impl)
    assert len(blocks) == 17 and _blocks_agree(blocks)
    model = ResNet50Features(conv_impl=impl, dtype=torch.bfloat16)
    with torch.no_grad():
        out = model(torch.from_numpy(resnet_bf16[0]))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4, 2048)


def _cast_before_epilogue(monkeypatch):
    """Round the float32 sums to the output dtype before scale and bias."""
    from sgg_torch.kernels import conv, conv_direct, matmul

    plain = matmul.epilogue

    def early(y, scale, bias, relu, out_dtype):
        return plain(y.to(out_dtype).float(), scale, bias, relu, out_dtype)

    for mod in (conv, conv_direct, matmul):
        monkeypatch.setattr(mod, "epilogue", early)


def _unrounded_residual(monkeypatch):
    """Add conv3's float32 output, not its bf16 rounding, to the residual."""
    from sgg_torch.kernels.conv import conv2d_reference
    from sgg_torch.models.resnet import _Bottleneck

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        c = self.conv3
        scale, bias = fold_batchnorm(c.bn_scale, c.bn_bias, c.bn_mean, c.bn_var)
        y = conv2d_reference(y.float(), c.kernel.to(c.dtype).float(), bias=bias,
                             scale=scale, relu=False)
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(y + residual.float()).to(x.dtype)

    monkeypatch.setattr(_Bottleneck, "forward", forward)


def _float32_weights(monkeypatch):
    """Leave the conv weights in float32 instead of casting them first."""
    from sgg_torch.kernels.conv import conv2d_fused
    from sgg_torch.models.resnet import _ConvBN

    def forward(self, x):
        scale, bias = fold_batchnorm(self.bn_scale, self.bn_bias, self.bn_mean, self.bn_var)
        return conv2d_fused(x, self.kernel, bias=bias, scale=scale, stride=self.stride,
                            relu=self.relu, impl=self.conv_impl)

    monkeypatch.setattr(_ConvBN, "forward", forward)


@pytest.mark.parametrize("fault", [_cast_before_epilogue, _unrounded_residual,
                                   _float32_weights])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_resnet50_bf16_bounds_fail_a_misplaced_cast(
        resnet_params, resnet_bf16, monkeypatch, fault, impl):
    """The bounds above are tight enough to fail each misplaced bf16 cast."""
    fault(monkeypatch)
    assert not _blocks_agree(_resnet50_bf16_blocks(resnet_params, resnet_bf16, impl))


def test_resnet50_converter_round_trips_every_leaf(resnet_params):
    sd = encoder_flax_to_state_dict(resnet_params)
    model = ResNet50Features()
    assert sd.keys() == model.state_dict().keys() and len(sd) == 265
    back = encoder_state_dict_to_flax(sd, "resnet50")
    assert jax.tree.structure(back) == jax.tree.structure(resnet_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(resnet_params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trained_vgg():
    return {"params": jax_load_params_npz(TRAINED_VGG)}


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_vgg19_trained_weights_match_reference(trained_vgg, impl):
    """The pretrained encoder of the repo, read by the port's own npz reader."""
    images = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    x = jax_normalize_for("vgg19", jnp.asarray(images))
    want = np.asarray(JaxVGG19().apply(trained_vgg, x))
    model = VGG19Features(conv_impl=impl)
    model.load_state_dict(encoder_flax_to_state_dict({"params": load_params_npz(TRAINED_VGG)}))
    with torch.no_grad():
        got = model(normalize_for("vgg19", torch.from_numpy(images))).numpy()
    assert got.shape == want.shape == (1, 16, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _vgg19_bf16(trained_vgg, impl):
    """(port, reference) bfloat16 features of one 64 px image."""
    images = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    x = jax_normalize_for("vgg19", jnp.asarray(images))
    want = JaxVGG19(dtype=jnp.bfloat16).apply(trained_vgg, x).astype(jnp.float32)
    model = VGG19Features(conv_impl=impl, dtype=torch.bfloat16)
    model.load_state_dict(encoder_flax_to_state_dict(trained_vgg))
    with torch.no_grad():
        got = model(normalize_for("vgg19", torch.from_numpy(images)))
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want)


# VGG-19 in bfloat16 on the trained weights: within 1e-2 x max|ref| and
# 7e-3 rel L2 of the reference in bfloat16; a cast before the epilogue is not.
@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_vgg19_bf16_matches_reference_bf16(trained_vgg, impl):
    assert _bf16_agrees(*_vgg19_bf16(trained_vgg, impl), 1e-2, 7e-3)


def test_vgg19_bf16_bounds_fail_a_cast_before_epilogue(trained_vgg, monkeypatch):
    _cast_before_epilogue(monkeypatch)
    assert not _bf16_agrees(*_vgg19_bf16(trained_vgg, "auto"), 1e-2, 7e-3)


def test_vgg19_npz_reader_and_converter_match_reference(trained_vgg):
    port = load_params_npz(TRAINED_VGG)
    ref = trained_vgg["params"]
    assert port.keys() == ref.keys() and len(port) == 32
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])
    back = encoder_state_dict_to_flax(encoder_flax_to_state_dict(trained_vgg), "vgg19")
    assert back["params"].keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back["params"][k], ref[k])


def test_vgg19_npy_weight_dict_matches_reference():
    r = np.random.RandomState(2)
    shapes = dict(VGG19Features().state_dict().items())
    raw = {n: [r.randn(*shapes[f"{n}.kernel"].shape).astype(np.float32),
               r.randn(*shapes[f"{n}.bias"].shape).astype(np.float32)] for n in conv_names()}
    got = load_npy_weights(raw)
    want = encoder_flax_to_state_dict(jax.tree.map(np.asarray, jax_load_npy_weights(raw)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


@pytest.mark.parametrize("name", ["vgg19", "resnet50"])
def test_normalize_for_matches_reference(name):
    images = np.random.RandomState(3).randint(0, 256, (2, 5, 4, 3)).astype(np.uint8)
    want = np.asarray(jax_normalize_for(name, jnp.asarray(images)))
    got = normalize_for(name, torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_make_encoder_routes_and_refusals():
    assert make_encoder("precomputed") is None
    enc = make_encoder("resnet50", use_pallas=True, dtype=torch.bfloat16)
    assert isinstance(enc, ResNet50Features)
    assert not any(p.requires_grad for p in enc.parameters())
    assert enc.stem.dtype == torch.bfloat16 and enc.stem.use_pallas
    assert isinstance(make_encoder("vgg19"), VGG19Features)
    vit = make_encoder("vit_b16", use_pallas=True, image_size=64, vit_dims=(64, 2, 4))
    assert isinstance(vit, ViTB16Features) and vit.num_patches == 16
    assert not any(p.requires_grad for p in vit.parameters())
    assert vit.block0.attn.use_pallas
    int8 = make_encoder("resnet50", quant="int8")  # the PTQ tier, inference only
    assert int8.stem.conv_impl == "int8" and not int8.stem.kernel.requires_grad
    with pytest.raises(ValueError):
        make_encoder("alexnet")
