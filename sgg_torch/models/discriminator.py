"""Wasserstein critic over (image features, triple) pairs, from
``sgg/models/discriminator.py``.

The triple arrives as three distributions over the vocabulary (one-hots for
real data, soft Gumbel-softmax points for generated data) and is embedded by a
product with the embedding table. A triple-conditioned additive attention
pools the image regions; an MLP trunk (Dense, LayerNorm, leaky ReLU 0.2) gives
a scalar score, returned in float32. No sigmoid and no batch norm.

Compute runs in the model dtype over float32 parameters, as flax's. Parameter
names and layouts are the flax module's (``token_embedding`` [V, E],
``query_proj``, ``key_proj`` and ``score`` without bias, ``trunk_{i}``,
``ln_{i}``, ``head``; Dense kernels [in, out]), so the flax tree converts leaf
by leaf. Under tensor parallelism (``vocab_shard``) the embedding holds this
rank's rows of V and the triple's embedding sums this rank's part of the
product over the model group.
"""

from __future__ import annotations

import torch
from torch import nn

from sgg_torch.config import Config
from sgg_torch.models.layers import Dense, LayerNorm, leaky_relu, softmax


class TripleCritic(nn.Module):
    def __init__(self, vocab_size: int, feat_dim: int, embed_dim: int = 256, hidden: int = 512,
                 attn_dim: int = 256, n_layers: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.n_layers = dtype, n_layers
        self.token_embedding = nn.Parameter(0.01 * torch.randn(vocab_size, embed_dim))
        self.query_proj = Dense(3 * embed_dim, attn_dim, dtype)
        self.key_proj = Dense(feat_dim, attn_dim, dtype, use_bias=False)
        self.score = Dense(attn_dim, 1, dtype, use_bias=False)
        width = feat_dim + 3 * embed_dim
        for i in range(n_layers):
            self.add_module(f"trunk_{i}", Dense(width, hidden, dtype))
            self.add_module(f"ln_{i}", LayerNorm(hidden, dtype))
            width = hidden
        self.head = Dense(hidden, 1, dtype)

    @classmethod
    def from_config(cls, cfg: Config) -> "TripleCritic":
        m = cfg.model
        return cls(vocab_size=m.vocab_size, feat_dim=cfg.data.feat_dim, embed_dim=m.embed_dim,
                   hidden=m.critic_hidden, attn_dim=m.attn_dim, n_layers=m.critic_layers,
                   dtype=m.dtype)

    def forward(self, feats: torch.Tensor, triple: torch.Tensor) -> torch.Tensor:
        """feats [B, R, F], triple [B, 3, V] (rows on the simplex) → float32 [B]."""
        dt = self.dtype
        feats, triple = feats.to(dt), triple.to(dt)
        vs = getattr(self, "vocab_shard", None)
        if vs is None:
            emb = torch.einsum("btv,ve->bte", triple, self.token_embedding.to(dt))
        else:
            emb = vs.embed(triple, self.token_embedding, dt)
        triple_vec = emb.reshape(emb.shape[0], -1)  # [B, 3E]

        # Triple-conditioned attention pooling of the image regions.
        q = self.query_proj(triple_vec)
        k = self.key_proj(feats)
        scores = self.score(torch.tanh(k + q[:, None, :])).squeeze(-1)
        alpha = softmax(scores, dim=-1)  # [B, R]
        ctx = torch.einsum("br,brf->bf", alpha, feats)

        x = torch.cat([ctx, triple_vec], dim=-1)
        for i in range(self.n_layers):
            x = getattr(self, f"ln_{i}")(getattr(self, f"trunk_{i}")(x))
            x = leaky_relu(x, negative_slope=0.2)
        return self.head(x).squeeze(-1).float()
