"""The port's int8 post-training quantization (``sgg_torch.kernels.quant``)
against ``sgg.kernels.quant`` on the CPU, on the same numpy inputs.

- ``int8_linear`` against ``int8_dot_general`` (2-D and 3-D lhs, float32 and
  bfloat16) and ``conv2d_int8`` against the reference's (stride 1 and 2, SAME
  and VALID, 1x1, 3x3 and 7x7, with and without scale, bias and ReLU), the
  reference called op by op: bit for bit, both routes. Both sum integers
  exactly, and each float32 epilogue rounds at the same points: no case needed
  the 1-ulp allowance.
- The plain route (float64 sums) against ``torch._int_mm`` (which runs on this
  CPU, so the padding to K, N multiples of 8 and more than 16 rows and the
  int8 im2col are tested here), bit for bit.
- Small int8 encoders (32 px) on seeded weights, converted, against the
  reference's int8 encoders under ``jax.jit`` (float32). Under jit XLA
  rewrites the scale's ``absmax / 127`` into ``absmax * float32(1/127)`` (seen
  in the compiled HLO) and rounds some epilogues differently, so the jitted
  reference sits up to an ulp a layer away from its own op-by-op result, which
  the port follows (seed 3, op by op: VGG-19 bit for bit, ResNet-50 within
  3.1e-7 x max|ref|, the ViT within 1.8e-7 x max|ref|; too slow to run here:
  13 s and 22 s for the two CNNs). A per-tensor absmax scale moved by an ulp
  shifts every later quantization step, so against the jitted reference a
  CNN's features lie either within 1.1e-6 x max|ref| or, when such a scale
  moved, as far as int8 noise reaches. Measured on seeds 3, 5, 7 and 11: six
  of eight CNN cases within 1.1e-6 x max|ref|, the others at rel L2 1.25e-2
  (ResNet-50, seed 3, the test's) and 3.04e-2 (VGG-19, seed 11); the float
  encoders lie 3.3e-2 to 4.3e-2 away, so this bound does not tell int8 from
  float. What does: the function tests above, and the count of one
  ``conv2d_int8`` call per conv of each CNN (16 and 53) in the port's forward.
  The CNNs are held to rel L2 5e-2. The ViT, whose activations take one scale
  per token, stays within 1e-5 x max|ref| (measured at most 2.6e-7). The
  reference's accuracy contract against the float encoder is held on the card
  (``chip_smoke.py`` phase 23); here the per-region cosine medians read
  0.9991-0.9999.
- ``make_encoder(quant='int8')`` and its routes; the consumers: the generate
  CLI's ``--quant int8`` and ``make_batch_features`` against the reference's,
  and ``InferenceEngine(quant='int8')``.
- The state repair: with ``model.quant=int8`` the train state's encoder is
  float, and the in-loop probe encodes through an int8 ``make_image_encoder``.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.cli.common import load_dataset as jax_load_dataset
from sgg.cli.common import make_batch_features as jax_make_batch_features
from sgg.config import get_config as jax_get_config
from sgg.kernels import quant as jq
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.encoders import normalize_for as jax_normalize_for
from sgg_torch import serve
from sgg_torch.cli import generate
from sgg_torch.config import Config as PortConfig
from sgg_torch.convert_flax import encoder_state_dict_to_flax
from sgg_torch.data import Vocab
from sgg_torch.kernels import quant
from sgg_torch.kernels.conv import conv2d_fused
from sgg_torch.models.encoders import make_encoder, normalize_for
from sgg_torch.train.checkpoint import save_generator
from sgg_torch.train.eval_probe import EvalProbe
from sgg_torch.train.state import create_train_state, make_generator

torch.set_num_threads(1)

CNN_REL_L2, VIT_TOL = 5e-2, 1e-5
VIT_DIMS = (64, 2, 4)


def _dot(x, w):
    nd = x.ndim
    return np.asarray(jq.int8_dot_general(x, w, (((nd - 1,), (0,)), ((), ()))))


@pytest.mark.parametrize("x_shape,n,dtype", [((7, 13), 9, "float32"),
                                               ((2, 5, 24), 40, "bfloat16")])
def test_int8_linear_matches_reference(x_shape, n, dtype):
    r = np.random.RandomState(sum(x_shape) + n)
    x = r.randn(*x_shape).astype(np.float32)
    w = (0.1 * r.randn(x_shape[-1], n)).astype(np.float32)
    x[..., 0, 0] = 0.0  # a zero stays zero
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    for impl in ("plain", "int_mm"):
        got = quant.int8_linear(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                impl=impl)
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("k,stride,padding,epilogue", [
    (1, 1, "SAME", True), (1, 2, "SAME", False), (3, 1, "SAME", True), (3, 2, "SAME", False),
    (3, 1, "VALID", False), (3, 2, "VALID", True), (7, 2, "SAME", True), (7, 1, "VALID", False)])
def test_conv2d_int8_matches_reference(k, stride, padding, epilogue):
    r = np.random.RandomState(10 * k + stride)
    x = r.randn(2, 11, 9, 5).astype(np.float32)
    w = (0.2 * r.randn(k, k, 5, 12)).astype(np.float32)
    kw = {}
    if epilogue:
        kw = dict(bias=(0.1 * r.randn(12)).astype(np.float32),
                  scale=(0.5 + r.rand(12)).astype(np.float32))
    want = np.asarray(jq.conv2d_int8(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                     padding=padding, relu=epilogue,
                                     **{a: jnp.asarray(b) for a, b in kw.items()}))
    tkw = {a: torch.from_numpy(b) for a, b in kw.items()}
    for impl in ("plain", "int_mm"):
        got = quant.conv2d_int8(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                                padding=padding, relu=epilogue, impl=impl, **tkw)
        np.testing.assert_array_equal(got.numpy(), want)
    # conv2d_fused's 'int8' route is this function.
    got = conv2d_fused(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                       padding=padding, relu=epilogue, impl="int8", **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(5, 13, 7), (16, 8, 8), (17, 27, 64), (40, 147, 9)])
def test_plain_and_int_mm_routes_agree_bit_for_bit(m, k, n):
    """K and N off multiples of 8 and M <= 16 take the zero padding."""
    g = torch.Generator().manual_seed(m * k * n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    a[0], b[:, 0] = 127, -127  # the extreme products
    plain = quant.int8_mm(a, b, "plain")
    fast = quant.int8_mm(a, b, "int_mm")
    assert plain.dtype == fast.dtype == torch.int32 and fast.shape == (m, n)
    assert torch.equal(plain, fast)
    assert torch.equal(plain.long(), a.long() @ b.long())
    assert quant.route(a) == "plain"
    with pytest.raises(ValueError, match="unknown int8 route"):
        quant.int8_mm(a, b, "int4")


def _seeded_weights(name, seed, kw):
    """A seeded state_dict for encoder ``name``: He-normal kernels (ResNet-50
    with non-trivial batch-norm statistics, the ViT's LayerNorm scales 1),
    drawn from the shapes of a module built on the meta device (no init)."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in make_encoder(name, **kw).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith(("kernel", "weight", "wi", "wo", "router")) or k == "pos_embed":
            fan_in = max(1, int(np.prod(shape[:-1])))
            sd[k] = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif k.endswith("bn_var"):
            sd[k] = 0.5 + torch.rand(shape, generator=g)
        elif k.endswith(("bn_scale", "scale")):
            sd[k] = torch.ones(shape)
        else:  # biases, batch-norm means and shifts
            sd[k] = 0.1 * torch.randn(shape, generator=g)
    return sd


def _encoder_pair(name, seed, quant_mode="int8"):
    """(the reference's module, its params, the port's module with the same
    seeded weights, make_encoder's keywords)."""
    kw = dict(image_size=32, vit_dims=VIT_DIMS) if name == "vit_b16" else {}
    sd = _seeded_weights(name, seed, kw)
    with torch.device("meta"):
        port = make_encoder(name, quant=quant_mode, **kw)
    port.load_state_dict(sd, assign=True)
    return (jax_make_encoder(name, quant=quant_mode, **kw), encoder_state_dict_to_flax(sd, name),
            port.requires_grad_(False), kw)


N_CONVS = {"vgg19": 16, "resnet50": 53}


@pytest.mark.parametrize("name", ["vgg19", "resnet50", "vit_b16"])
def test_int8_encoders_match_reference(monkeypatch, name):
    """The int8 encoders against the reference's jitted ones; every conv of
    the CNNs (ResNet-50: the 7x7 stem, 48 block convs, the strided ones among
    them, and 4 1x1 projections) runs conv2d_int8 once per forward."""
    import sgg_torch.kernels.conv as conv_mod

    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("stride", 1))
        return quant.conv2d_int8(*args, **kw)

    monkeypatch.setattr(conv_mod, "conv2d_int8", counted)
    enc, params, port, _ = _encoder_pair(name, 3)
    imgs = np.random.RandomState(4).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(enc.apply)(params, jax_normalize_for(name, jnp.asarray(imgs))))
    with torch.no_grad():
        got = port(normalize_for(name, torch.from_numpy(imgs))).numpy()
    assert got.shape == want.shape
    if name == "vit_b16":
        np.testing.assert_allclose(got, want, rtol=0, atol=VIT_TOL * np.abs(want).max())
        return
    assert np.linalg.norm(got - want) <= CNN_REL_L2 * np.linalg.norm(want)
    assert all(m.conv_impl == "int8" for m in port.modules() if hasattr(m, "conv_impl"))
    assert len(calls) == N_CONVS[name]
    if name == "resnet50":  # the stem, and the 3x3 and the projection of stages 2-4
        assert calls.count(2) == 7


def test_make_encoder_int8_routes():
    with torch.device("meta"):
        vgg = make_encoder("vgg19", quant="int8")
        res = make_encoder("resnet50", quant="int8", use_pallas=True)
    assert vgg.conv_impl == "int8" and res.stem.conv_impl == "int8"
    vit = make_encoder("vit_b16", quant="int8", use_pallas=True, image_size=32,
                       vit_dims=VIT_DIMS)
    for i in range(VIT_DIMS[1]):
        b = getattr(vit, f"block{i}")
        assert all(d.dot_fn is quant.int8_linear
                   for d in (b.attn.qkv, b.attn.out, b.mlp1, b.mlp2))
        assert b.attn.use_pallas  # the attention stays on the flash route
    assert make_encoder("vit_b16", image_size=32, vit_dims=VIT_DIMS).block0.mlp1.dot_fn \
        is torch.matmul
    with pytest.raises(ValueError, match="inference only"):
        make_encoder("resnet50", quant="int8", trainable=True)
    with pytest.raises(ValueError, match="unknown quant"):
        make_encoder("resnet50", quant="int4")


def _vit_cfg():
    cfg = jax_get_config("vit_b16")
    cfg.data.image_size, cfg.data.regions, cfg.data.feat_dim = 32, 4, 64
    cfg.data.num_synthetic_images = 6
    cfg.model.vit_dim, cfg.model.vit_layers, cfg.model.vit_heads = VIT_DIMS
    cfg.model.hidden, cfg.model.num_heads, cfg.model.num_layers = 32, 4, 2
    cfg.model.noise_dim, cfg.model.compute_dtype = 8, "float32"
    return cfg


def test_batch_features_engine_and_generate_cli_int8(tmp_path, capsys):
    """make_batch_features(quant='int8') against the reference's; the serving
    engine's int8 features equal it; generate --quant int8 and --quant none
    run on the workdir and differ only where the encoder does."""
    cfg = _vit_cfg()
    ds, vocab = jax_load_dataset(cfg)
    cfg.model.vocab_size = len(vocab)
    sd = _seeded_weights("vit_b16", 5, dict(image_size=32, vit_dims=VIT_DIMS))
    params = encoder_state_dict_to_flax(sd, "vit_b16")
    pcfg = PortConfig.from_json(cfg.to_json())
    port_ds, pvocab = generate.load_dataset(pcfg)
    idx = np.array([5, 0, 3])
    want = jax_make_batch_features(cfg, ds, params, quant="int8")(idx)
    got = generate.make_batch_features(pcfg, port_ds, sd, torch.device("cpu"),
                                       quant="int8")(idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VIT_TOL * np.abs(want).max())
    flt = generate.make_batch_features(pcfg, port_ds, sd, torch.device("cpu"))(idx)
    assert not torch.equal(flt, got)

    torch.manual_seed(0)
    weights = serve.ServeWeights(1, make_generator(pcfg).state_dict(), None, sd)
    eng = serve.InferenceEngine(PortConfig.from_json(cfg.to_json()), pvocab, weights,
                                device="cpu", batch_size=2, num_samples=2, quant="int8")
    assert eng.cfg.model.quant == "int8"
    assert torch.equal(eng.encode_images(port_ds.images[idx]), got)

    wd = str(tmp_path)
    pcfg.workdir = wd
    with open(os.path.join(wd, "config.json"), "w") as f:
        f.write(pcfg.to_json())
    pvocab.save(os.path.join(wd, "vocab.json"))
    save_generator(wd, weights.g_params, step=1, enc_params=sd)
    for q in ("int8", "none"):
        out = os.path.join(wd, f"graphs_{q}.json")
        assert generate.main(["--workdir", wd, "--device", "cpu", "--num-samples", "2",
                              "--batch-size", "4", "--quant", q, "--out", out]) == 0
        assert os.path.getsize(out) > 0
    assert "[sgg.generate] 6 images, 12 triples" in capsys.readouterr().out


def test_train_state_encoder_stays_float_and_probe_quantizes(tmp_path):
    """With model.quant=int8 the train state's encoder is the float one (the
    reference's create_train_state ignores quant), trainable under
    train_encoder; the probe builds its own int8 encoder through
    make_image_encoder on the state's current weights, shared, not copied."""
    cfg = PortConfig.from_json(_vit_cfg().to_json())
    vocab = Vocab.build(Counter({f"obj{i}": 50 - i for i in range(10)}),
                        Counter({f"pred{i}": 50 - i for i in range(6)}))
    cfg.model.vocab_size = len(vocab)
    cfg.model.quant = "int8"
    cfg.workdir = str(tmp_path)
    cfg.train.eval_images, cfg.train.eval_samples, cfg.train.batch_size = 3, 2, 2
    cfg.train.train_encoder = True
    state = create_train_state(cfg, 0)
    dots = [state.encoder.block0.attn.qkv, state.encoder.block1.mlp2]
    assert all(d.dot_fn is torch.matmul for d in dots)
    assert all(p.requires_grad for p in state.encoder.parameters())
    probe = EvalProbe(cfg, vocab, "cpu")
    out = probe.run(state, 1)
    assert np.isfinite(out["eval_recall@50"])
    probe_enc = probe._encode.encoder
    assert probe_enc.block0.attn.qkv.dot_fn is quant.int8_linear
    assert not any(p.requires_grad for p in probe_enc.parameters())
    sd = state.encoder.state_dict()
    assert all(v.data_ptr() == sd[k].data_ptr() for k, v in probe_enc.state_dict().items())
    with torch.no_grad():  # the run's weights change; the probe reads them
        state.encoder.block0.attn.qkv.kernel.mul_(2.0)
    assert torch.equal(probe_enc.block0.attn.qkv.kernel, state.encoder.block0.attn.qkv.kernel)
    assert probe.run(state, 2)["eval_recall@50"] >= 0
