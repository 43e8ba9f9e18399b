"""ViT-B/16 patch-token encoder, from ``sgg/models/vit.py``.

224 px images cut into 16 × 16 patches give 196 tokens of width 768; a
learned position embedding (no class token), 12 pre-LN blocks of 12-head
self-attention and a tanh-GELU MLP (with ``moe_experts`` > 0 a top-k MoE
layer in every block, ``sgg_torch.models.moe``), then a final LayerNorm. With
``use_pallas=True`` the self-attention goes through
``sgg_torch.kernels.flash_attention.attention('auto')`` (the CUDA flash
kernel on a CUDA tensor); otherwise through ``attention_reference``. An
``attn_fn`` (q, k, v) → o overrides both. ``dot_fn`` replaces the product of
the qkv, out, mlp1 and mlp2 projections (the int8 tier's
``sgg_torch.kernels.quant.int8_linear``, as the reference's ``dot_general``);
the patch embed, the MoE experts and the attention itself stay float.

Parameter names and layouts are the flax module's: ``patch_embed.kernel``
(HWIO [16, 16, 3, E]) and ``.bias``, ``pos_embed`` [1, N, E],
``block{i}.{ln1,attn.qkv,attn.out,ln2,mlp1,mlp2}`` (MoE blocks:
``block{i}.moe.{router,wi,wo}`` in place of mlp1 and mlp2) and ``ln_final``, Dense
kernels [in, out], so the flax tree converts leaf by leaf. Parameters are
float32 and are cast to the compute dtype at the call.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from sgg_torch.kernels.flash_attention import attention, attention_reference
from sgg_torch.models.layers import Dense, LayerNorm, gelu, lecun_normal
from sgg_torch.models.moe import MoEMLP


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, use_pallas: bool = False,
                 attn_fn: Callable | None = None, dtype: torch.dtype = torch.float32,
                 dot_fn: Callable | None = None):
        super().__init__()
        self.num_heads, self.use_pallas, self.attn_fn = num_heads, use_pallas, attn_fn
        self.qkv = Dense(embed_dim, 3 * embed_dim, dtype, dot_fn=dot_fn)
        self.out = Dense(embed_dim, embed_dim, dtype, dot_fn=dot_fn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, E]
        B, S, E = x.shape
        H = self.num_heads
        q, k, v = self.qkv(x).split(E, dim=-1)

        def heads(t):  # [B, S, E] → [B, H, S, D], contiguous for the kernel
            return t.reshape(B, S, H, E // H).transpose(1, 2).contiguous()

        if self.attn_fn is not None:
            attend = self.attn_fn
        else:
            attend = attention if self.use_pallas else attention_reference
        o = attend(heads(q), heads(k), heads(v))  # [B, H, S, D]
        return self.out(o.transpose(1, 2).reshape(B, S, E))


class TransformerBlock(nn.Module):
    """Pre-LN block: self-attention, then the dense MLP, or with
    ``moe_experts`` > 0 a top-``moe_top_k`` MoE layer (``moe``)."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 use_pallas: bool = False, attn_fn: Callable | None = None,
                 dtype: torch.dtype = torch.float32, moe_experts: int = 0,
                 moe_top_k: int = 2, dot_fn: Callable | None = None):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim, dtype)
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads, use_pallas, attn_fn, dtype,
                                           dot_fn)
        self.ln2 = LayerNorm(embed_dim, dtype)
        if moe_experts > 0:
            self.moe = MoEMLP(embed_dim, moe_experts, top_k=moe_top_k, mlp_ratio=mlp_ratio,
                              dtype=dtype)
        else:
            self.moe = None
            self.mlp1 = Dense(embed_dim, embed_dim * mlp_ratio, dtype, dot_fn=dot_fn)
            self.mlp2 = Dense(embed_dim * mlp_ratio, embed_dim, dtype, dot_fn=dot_fn)

    def forward_aux(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(block output, the MoE layer's load-balance term, or None)."""
        x = x + self.attn(self.ln1(x))
        if self.moe is not None:
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        return x + self.mlp2(gelu(self.mlp1(self.ln2(x)))), None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_aux(x)[0]


class PatchEmbed(nn.Module):
    """A ``patch`` × ``patch`` stride-``patch`` VALID conv with bias, as one
    matmul over the patches (flax's HWIO kernel read as [p·p·3, E])."""

    def __init__(self, embed_dim: int, patch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(lecun_normal((patch, patch, 3, embed_dim)))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3] → [B, Hp, Wp, E]
        B, H, W, C = x.shape
        p, dt = self.patch, self.dtype
        Hp, Wp = H // p, W // p
        x = x[:, : Hp * p, : Wp * p].reshape(B, Hp, p, Wp, p, C).permute(0, 1, 3, 2, 4, 5)
        y = torch.matmul(x.reshape(B, Hp, Wp, p * p * C).to(dt),
                         self.kernel.reshape(p * p * C, -1).to(dt))
        return y + self.bias.to(dt)


class ViTB16Features(nn.Module):
    """Images [B, H, W, 3] (normalized) → patch tokens [B, (H/16)(W/16), E].

    ``embed`` and ``final`` are callable on their own, as in the reference
    (its pipeline-parallel path stages the block stack between them)."""

    def __init__(self, embed_dim: int = 768, num_heads: int = 12, num_layers: int = 12,
                 patch: int = 16, mlp_ratio: int = 4, use_pallas: bool = False,
                 attn_fn: Callable | None = None, moe_experts: int = 0,
                 dtype: torch.dtype = torch.float32, num_patches: int = 196,
                 moe_top_k: int = 2, dot_fn: Callable | None = None):
        super().__init__()
        self.dtype, self.num_patches, self.moe_experts = dtype, num_patches, moe_experts
        self.patch_embed = PatchEmbed(embed_dim, patch, dtype)
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, num_patches, embed_dim))
        self.blocks = []
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(
                embed_dim, num_heads, mlp_ratio, use_pallas, attn_fn, dtype, moe_experts,
                moe_top_k, dot_fn))
            self.blocks.append(f"block{i}")
        self.ln_final = LayerNorm(embed_dim, dtype)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Images → position-encoded patch tokens (pre-blocks)."""
        x = self.patch_embed(x.to(self.dtype))
        B, Hp, Wp, E = x.shape
        if Hp * Wp != self.num_patches:
            raise ValueError(f"input yields {Hp * Wp} patches; module built for "
                             f"{self.num_patches} (num_patches = (H // 16) * (W // 16))")
        return x.reshape(B, Hp * Wp, E) + self.pos_embed.to(self.dtype)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_final(x)

    def forward_aux(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(features, the mean of the MoE blocks' load-balance terms, float32;
        None without MoE). The reference sows each block's term into flax's
        ``"moe"`` collection, and its callers average the collected leaves."""
        x = self.embed(x)
        aux = {}
        for name in self.blocks:
            x, a = getattr(self, name).forward_aux(x)
            if a is not None:
                aux[name] = a
        # Summed in the collection's leaf order (block names sorted as strings).
        mean = sum(aux[k] for k in sorted(aux)) / len(aux) if aux else None
        return self.final(x), mean

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_aux(x)[0]
