"""Soft (additive) attention over feature regions, from
``sgg/models/attention.py``: score_r = v·tanh(P_r + W_h h), alpha =
softmax(score), ctx = Σ alpha_r f_r. The feature projection P = W_f f is
computed once per image (``project_features``) and reused by every step.
"""

from __future__ import annotations

import torch
from torch import nn

from sgg_torch.models.layers import dense, init_dense_


class AdditiveAttention(nn.Module):
    def __init__(self, feat_dim: int, hidden: int, attn_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.feat_proj = init_dense_(nn.Linear(feat_dim, attn_dim, bias=False))
        self.state_proj = init_dense_(nn.Linear(hidden, attn_dim))
        self.score = init_dense_(nn.Linear(attn_dim, 1, bias=False))

    def project_features(self, feats: torch.Tensor) -> torch.Tensor:
        """[B,R,F] → [B,R,A], hoisted out of the decode loop."""
        return dense(self.feat_proj, feats, self.dtype)

    def forward(self, feats, h, proj_feats=None):
        """feats [B,R,F], h [B,H], proj_feats [B,R,A] → (ctx [B,F], alpha [B,R])."""
        if proj_feats is None:
            proj_feats = self.project_features(feats)
        hp = dense(self.state_proj, h, self.dtype)
        scores = dense(self.score, torch.tanh(proj_feats + hp[:, None, :]), self.dtype)
        alpha = torch.softmax(scores.squeeze(-1), dim=-1)  # [B, R]
        ctx = torch.einsum("br,brf->bf", alpha, feats)
        return ctx, alpha
