"""The port's ViT-B/16 encoder against the reference's flax module, with the
reference's own parameters converted, at ``vit_dims=(64, 2, 4)`` and 64 px
(16 patches, head width 16).

Routes: the port's ``use_pallas=False`` (unfused attention) against the
reference's ``use_pallas=False``; the port's ``use_pallas=True`` (flash
attention, its plain version on the CPU) against the reference with
``attn_fn=flash_attention`` (the Pallas kernel in interpret mode).

Tolerances: float32 features within 1e-4 x max|ref| (float32 sums in another
order). bfloat16 block by block, each block fed the reference's input: at
most 15 % of a block's elements differ and rel L2 within 2e-3. Both round
at the same points, but XLA's float32 ``rsqrt`` on the CPU is not correctly
rounded (14 % of values off by an ulp; torch's 27 %), so a LayerNorm output
can flip a bf16 rounding that the block's products then carry: here block 0
reads 8.2 % and 1.4e-3, block 1 nothing. A misplaced rounding reads 24-57 %
and 2.0e-3 to 4.6e-3 in the same test (GELU in one float32 pass, the Dense
bias fused into the product, p rounded to bf16 before P.V).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgg.kernels.flash_attention import flash_attention as jax_flash_attention
from sgg.models.encoders import make_encoder as jax_make_encoder
from sgg.models.vit import TransformerBlock as JaxBlock
from sgg.models.vit import ViTB16Features as JaxViT
from sgg_torch.convert_flax import encoder_flax_to_state_dict, encoder_state_dict_to_flax
from sgg_torch.kernels.flash_attention import flash_attention_plain
from sgg_torch.models.encoders import make_encoder
from sgg_torch.models.layers import gelu
from sgg_torch.models.vit import ViTB16Features

torch.set_num_threads(1)

DIMS = dict(embed_dim=64, num_layers=2, num_heads=4, num_patches=16)


@pytest.fixture(scope="module")
def vit():
    r = np.random.RandomState(0)
    x = r.randn(2, 64, 64, 3).astype(np.float32)
    params = JaxViT(**DIMS).init(jax.random.key(0), jnp.asarray(x))
    # Non-trivial LayerNorm and bias leaves, so every conversion is tested.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            (1.0 + 0.1 * r.randn(*v.shape)) if path[-1].key == "scale"
            else (0.1 * r.randn(*v.shape)) if path[-1].key == "bias" else v, np.float32),
        params)
    like = ViTB16Features(**DIMS).state_dict()
    return x, params, encoder_flax_to_state_dict(params, like=like)


def _port(sd, **kw):
    m = ViTB16Features(**DIMS, **kw)
    m.load_state_dict(sd)
    return m.eval()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_float32_features_match_reference(vit, use_pallas):
    x, params, sd = vit
    ref = JaxViT(**DIMS, attn_fn=jax_flash_attention if use_pallas else None)
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(sd, use_pallas=use_pallas)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def _bf16_blocks(x, params, sd, use_pallas):
    """(share of elements differing, rel L2) of the port against the
    reference in bfloat16 for embed, each block (fed the reference's
    input) and final."""
    attn = jax_flash_attention if use_pallas else None
    ref = JaxViT(**DIMS, attn_fn=attn, dtype=jnp.bfloat16)
    port = _port(sd, use_pallas=use_pallas, dtype=torch.bfloat16)
    out = []

    def dist(want, got):
        want, got = np.asarray(want).astype(np.float32), got.float().numpy()
        assert want.shape == got.shape and got.dtype == np.float32
        out.append(((want != got).mean(),
                    np.linalg.norm(want - got) / np.linalg.norm(want)))

    def port_in(h):
        return torch.from_numpy(np.asarray(h).astype(np.float32)).to(torch.bfloat16)

    with torch.no_grad():
        h = ref.apply(params, jnp.asarray(x), method="embed")
        dist(h, port.embed(torch.from_numpy(x)))
        for i in range(DIMS["num_layers"]):
            block = JaxBlock(DIMS["num_heads"], attn_fn=attn, dtype=jnp.bfloat16)
            want = block.apply({"params": params["params"][f"block{i}"]}, h)
            dist(want, getattr(port, f"block{i}")(port_in(h)))
            h = want
        dist(ref.apply(params, h, method="final"), port.final(port_in(h)))
        assert port(torch.from_numpy(x)).dtype == torch.bfloat16
    return out


def _within(dists):
    return all(share <= 0.15 and rel <= 2e-3 for share, rel in dists)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_bfloat16_block_by_block_matches_reference(vit, use_pallas):
    x, params, sd = vit
    assert _within(_bf16_blocks(x, params, sd, use_pallas))


def _gelu_one_pass(x):
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


def _dense_fused_bias(self, x):
    return torch.nn.functional.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                                      self.bias.to(self.dtype))


def _p_rounded(q, k, v):
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2))
                      * q.shape[-1] ** -0.5, dim=-1)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


@pytest.mark.parametrize("fault", ["gelu", "dense", "p"])
def test_bfloat16_bounds_catch_misplaced_roundings(vit, monkeypatch, fault):
    import sgg_torch.models.layers as layers
    import sgg_torch.models.vit as vit_mod

    x, params, sd = vit
    if fault == "gelu":
        monkeypatch.setattr(vit_mod, "gelu", _gelu_one_pass)
    elif fault == "dense":
        monkeypatch.setattr(layers.Dense, "forward", _dense_fused_bias)
    else:
        monkeypatch.setattr(vit_mod, "attention_reference", _p_rounded)
    assert not _within(_bf16_blocks(x, params, sd, use_pallas=False))


def test_attn_fn_override_and_gelu(vit):
    x, _, sd = vit
    calls = []

    def attend(q, k, v):
        calls.append(tuple(q.shape))
        return flash_attention_plain(q, k, v)

    with torch.no_grad():
        got = _port(sd, attn_fn=attend)(torch.from_numpy(x))
        want = _port(sd, use_pallas=True)(torch.from_numpy(x))
    assert calls == [(2, 4, 16, 16)] * 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    h = np.random.RandomState(1).randn(3, 40).astype(np.float32) * 3
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax.nn.gelu(jnp.asarray(h, jdt))).astype(np.float32)
        got = gelu(torch.from_numpy(h).to(dt)).float().numpy()
        # float32: tanh implementations differ in the last bits.
        tol = 1e-6 * np.abs(want).max() if dt == torch.float32 else 0
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_make_encoder_vit_matches_reference_shapes(vit):
    _, params, sd = vit
    enc = make_encoder("vit_b16", use_pallas=True, dtype=torch.bfloat16, image_size=64,
                       vit_dims=(64, 2, 4))
    assert isinstance(enc, ViTB16Features) and enc.num_patches == 16
    assert not any(p.requires_grad for p in enc.parameters())
    ref = jax_make_encoder("vit_b16", image_size=64, vit_dims=(64, 2, 4))
    ref_shapes = jax.eval_shape(ref.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    got = {k: tuple(v.shape) for k, v in enc.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in encoder_flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), ref_shapes)).items()}
    assert got == want
    assert make_encoder("vit_b16").num_patches == 196
    # MoE blocks, refused before they were ported (tests/test_torch_moe.py
    # holds them against the reference): the block's MLP becomes its MoE layer.
    moe_sd = make_encoder("vit_b16", moe_experts=4, vit_dims=(64, 2, 4)).state_dict()
    assert "block0.moe.wi" in moe_sd and "block0.mlp1.kernel" not in moe_sd
    with pytest.raises(ValueError, match="patches"):
        enc(torch.zeros(1, 32, 32, 3))


def test_vit_converter_round_trip_and_refusals(vit):
    _, params, sd = vit
    back = encoder_state_dict_to_flax(sd, "vit_b16")
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)
    like = ViTB16Features(**DIMS).state_dict()
    tree = {"params": dict(params["params"])}
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unknown"):
        encoder_flax_to_state_dict(tree, like=like)
    tree = {"params": {k: v for k, v in params["params"].items() if k != "ln_final"}}
    with pytest.raises(ValueError, match="missing"):
        encoder_flax_to_state_dict(tree, like=like)
    with pytest.raises(ValueError, match="shapes"):
        encoder_flax_to_state_dict(params, like=ViTB16Features(
            embed_dim=64, num_layers=2, num_heads=4, num_patches=4).state_dict())
