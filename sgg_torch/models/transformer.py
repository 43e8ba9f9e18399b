"""Transformer triple decoder, from ``sgg/models/transformer.py``.

The (subject, predicate, object) positions are three learned slot queries
decoded in parallel: per layer, self-attention over the 3 slots,
cross-attention over the projected image features, and a tanh-GELU MLP, all
pre-LN. The noise vector z conditions every slot; per-slot type masks keep
triples well formed. The interface is the attention-LSTM generator's: the
Gumbel noise is an input ([B, 3, V] float32), and hard tokens are the argmax
of the straight-through Gumbel-softmax sample cast to the compute dtype.

Attention here is plain tensor code, as in the reference (its cross-attention
has 3 queries, and its ``use_pallas`` is reserved). ``sample_temp``,
``sample_top_k``/``sample_top_p``, ``detach_sample`` (with ``log_prob``) and
``forced_steps`` are the attention-LSTM generator's. The slots are decoded in
parallel, so a forced slot replaces that slot's one-hot and token but cannot
condition the other slots' logits: PredCls through this decoder scores the
marginal predicate distribution, as the reference's does.

Parameter names and layouts are the flax module's (``feat_proj``,
``slot_embed``, ``noise_proj``, ``ln_self{i}``, ``self_qkv{i}``,
``self_out{i}``, ``ln_cross{i}``, ``cross{i}.{q,k,v,out}``, ``ln_mlp{i}``,
``mlp1_{i}``, ``mlp2_{i}``, ``ln_out``, ``vocab_proj``), Dense kernels
[in, out]. Under tensor parallelism (``vocab_shard``) ``vocab_proj`` holds
this rank's columns of V and its logits are all-gathered over the model
group; the decoder has no token embedding.
"""

from __future__ import annotations

import torch
from torch import nn

from sgg_torch.config import Config
from sgg_torch.models.generator import (
    MASK_VALUE,
    TRIPLE_LEN,
    sampling_logits,
    token_log_prob,
)
from sgg_torch.models.layers import Dense, LayerNorm, gelu
from sgg_torch.utils.gumbel import gumbel_softmax


def _scaled(s: torch.Tensor, D: int) -> torch.Tensor:
    """s · D^-0.5 with the scale rounded to s's dtype first, as JAX multiplies
    an array by a Python float."""
    return s * torch.full((), D ** -0.5, dtype=s.dtype, device=s.device)


class _CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, q_tokens, kv):  # [B,T,E], [B,R,E] → ([B,T,E], [B,T,R])
        B, T, E = q_tokens.shape
        H = self.num_heads
        D = E // H
        q = self.q(q_tokens).reshape(B, T, H, D)
        k = self.k(kv).reshape(B, -1, H, D)
        v = self.v(kv).reshape(B, -1, H, D)
        s = _scaled(torch.einsum("bthd,brhd->bhtr", q, k), D)
        a = torch.softmax(s.float(), dim=-1).to(self.dtype)
        o = torch.einsum("bhtr,brhd->bthd", a, v).reshape(B, T, E)
        return self.out(o), a.mean(dim=1)  # head-averaged map


class TransformerTripleGenerator(nn.Module):
    def __init__(
        self, vocab_size: int, feat_dim: int, hidden: int = 512, embed_dim: int = 256,
        noise_dim: int = 128, num_heads: int = 8, num_layers: int = 4, mlp_ratio: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        E = hidden
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_heads, self.num_layers, self.dtype = num_heads, num_layers, dtype
        self.feat_proj = Dense(feat_dim, E, dtype)
        self.slot_embed = nn.Parameter(0.02 * torch.randn(1, TRIPLE_LEN, E))
        self.noise_proj = Dense(noise_dim, E, dtype)
        for i in range(num_layers):
            self.add_module(f"ln_self{i}", LayerNorm(E, dtype))
            self.add_module(f"self_qkv{i}", Dense(E, 3 * E, dtype))
            self.add_module(f"self_out{i}", Dense(E, E, dtype))
            self.add_module(f"ln_cross{i}", LayerNorm(E, dtype))
            self.add_module(f"cross{i}", _CrossAttention(E, num_heads, dtype))
            self.add_module(f"ln_mlp{i}", LayerNorm(E, dtype))
            self.add_module(f"mlp1_{i}", Dense(E, E * mlp_ratio, dtype))
            self.add_module(f"mlp2_{i}", Dense(E * mlp_ratio, E, dtype))
        self.ln_out = LayerNorm(E, dtype)
        self.vocab_proj = Dense(E, vocab_size, dtype)

    @classmethod
    def from_config(cls, cfg: Config) -> "TransformerTripleGenerator":
        m = cfg.model
        return cls(
            vocab_size=m.vocab_size, feat_dim=cfg.data.feat_dim, hidden=m.hidden,
            embed_dim=m.embed_dim, noise_dim=m.noise_dim, num_heads=m.num_heads,
            num_layers=m.num_layers, mlp_ratio=m.mlp_ratio, dtype=m.dtype,
        )

    def forward(
        self,
        feats: torch.Tensor,  # [B, R, F]
        z: torch.Tensor,  # [B, noise_dim]
        gumbel: torch.Tensor,  # [B, 3, V] float32
        tau: float = 1.0,
        hard: bool = False,
        step_mask: torch.Tensor | None = None,  # bool[3, V]
        detach_sample: bool = False,
        forced_tokens: torch.Tensor | None = None,  # int [B, 3]
        forced_steps: tuple = (),  # the slots to clamp to forced_tokens
        sample_temp=None,  # number, or float32 [B]
        sample_top_k: int = 0,
        sample_top_p: float | None = None,
    ) -> dict[str, torch.Tensor]:
        """Decode one triple per image → soft [B,3,V], logits [B,3,V],
        attention [B,3,R] (the last layer's head-averaged cross-attention)
        and tokens [B,3]; with ``detach_sample`` exact Gumbel-max tokens and
        ``log_prob`` float32 [B], the sum of the three slots' untempered
        log-probabilities (the slots are independent given z). The slots in
        ``forced_steps`` take ``forced_tokens`` as their one-hot and token
        (and in ``log_prob``)."""
        dt = self.dtype
        feats = feats.to(dt)
        z = z.to(dt)
        B = feats.shape[0]
        E = self.slot_embed.shape[-1]
        H = self.num_heads
        D = E // H

        kv = self.feat_proj(feats)  # [B, R, E]
        x = self.slot_embed.to(dt).expand(B, TRIPLE_LEN, E) + self.noise_proj(z)[:, None, :]
        attn_map = None
        for i in range(self.num_layers):
            y = getattr(self, f"ln_self{i}")(x)
            q, k, v = getattr(self, f"self_qkv{i}")(y).split(E, dim=-1)
            s = _scaled(torch.einsum("bthd,bshd->bhts", q.reshape(B, TRIPLE_LEN, H, D),
                                     k.reshape(B, TRIPLE_LEN, H, D)), D)
            a = torch.softmax(s.float(), dim=-1).to(dt)
            sa = torch.einsum("bhts,bshd->bthd", a, v.reshape(B, TRIPLE_LEN, H, D))
            x = x + getattr(self, f"self_out{i}")(sa.reshape(B, TRIPLE_LEN, E))

            y = getattr(self, f"ln_cross{i}")(x)
            ca, attn_map = getattr(self, f"cross{i}")(y, kv)
            x = x + ca

            y = getattr(self, f"ln_mlp{i}")(x)
            x = x + getattr(self, f"mlp2_{i}")(gelu(getattr(self, f"mlp1_{i}")(y)))

        vs = getattr(self, "vocab_shard", None)
        if vs is None:
            logits = self.vocab_proj(self.ln_out(x))  # [B, 3, V]
        else:
            logits = vs.logits(self.vocab_proj, self.ln_out(x))
        if step_mask is not None:
            m = step_mask.to(device=logits.device, dtype=torch.bool)[None]
            logits = torch.where(
                m, logits, torch.full((), MASK_VALUE, dtype=logits.dtype, device=logits.device))
        logits32 = logits.float()
        samp32 = sampling_logits(logits32, sample_temp, sample_top_k, sample_top_p)

        def clamp(y, idx):
            if not forced_steps:
                return y, idx
            forced = forced_tokens.to(device=idx.device, dtype=torch.long)
            fy = torch.zeros_like(logits32).scatter_(-1, forced[..., None], 1.0).to(dt)
            keep = torch.tensor([t in forced_steps for t in range(TRIPLE_LEN)],
                                device=idx.device)[None, :]
            return torch.where(keep[..., None], fy, y), torch.where(keep, forced, idx)

        if detach_sample:
            idx = torch.argmax(samp32 + gumbel.float(), dim=-1)  # [B, 3]
            y = torch.zeros_like(samp32).scatter_(-1, idx[..., None], 1.0).to(dt)
            y, idx = clamp(y, idx)
            return {"soft": y, "logits": logits, "attention": attn_map, "tokens": idx,
                    "log_prob": token_log_prob(logits32, idx).sum(dim=-1)}
        y = gumbel_softmax(samp32, gumbel.float(), tau=tau, hard=hard).to(dt)
        y, tokens = clamp(y, torch.argmax(y, dim=-1))
        return {
            "soft": y,
            "logits": logits,
            "attention": attn_map,
            "tokens": tokens,
        }
