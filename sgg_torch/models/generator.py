"""Attention-LSTM triple generator, from ``sgg/models/generator.py``.

Conditioned on region features and a noise vector, it emits a (subject,
predicate, object) triple as three token distributions. Per decode step:
additive attention over the R regions gives a context vector; a TF1 LSTM step
runs on [context, previous-token embedding, z]; a deep-output layer and the
vocab projection give logits, masked to the step's legal tokens; a
Gumbel-softmax sample feeds back through the embedding.

The noise is an input: ``gumbel`` holds the [B, 3, V] float32 Gumbel draws
that the reference makes inside the step loop. The sampler's options are the
reference's: ``sample_temp`` (scalar or per row) and ``sample_top_k`` /
``sample_top_p`` shape the distribution tokens are drawn from, and
``detach_sample`` draws exact Gumbel-max tokens and returns ``log_prob``, the
untempered joint log-probability in float32. ``forced_steps`` clamp steps to
``forced_tokens`` (the PredCls scorer's conditional decode): a forced step's
one-hot feeds back through the embedding, so later steps condition on it.

Under tensor parallelism (``vocab_shard``, set by
``sgg_torch.dist.sharding.place_state``) the embedding and ``vocab_proj``
hold this rank's slice of V: ``vocab_proj`` computes this rank's logits and
all-gathers them, and the fed-back token's embedding sums this rank's part of
``y @ embedding`` over the model group (``VocabShard``). Without one the
module runs whole.
"""

from __future__ import annotations

import torch
from torch import nn

from sgg_torch.config import Config
from sgg_torch.models.attention import AdditiveAttention
from sgg_torch.models.layers import dense, init_dense_
from sgg_torch.models.lstm import TF1LSTMCell
from sgg_torch.utils.gumbel import gumbel_softmax, top_k_top_p_filter

TRIPLE_LEN = 3  # (subject, predicate, object)
MASK_VALUE = -1e9  # the reference masks with -1e9, not -inf


def sampling_logits(logits32: torch.Tensor, sample_temp=None, top_k: int = 0,
                    top_p=None) -> torch.Tensor:
    """The float32 logits tokens are drawn from: divided by ``sample_temp``
    (a number, or float32 [B] per row), then top-k/top-p filtered. The
    temperature is a tensor on the logits' device, so the division is a true
    one on every device, as the reference's."""
    samp = logits32
    if sample_temp is not None:
        t = torch.as_tensor(sample_temp, dtype=torch.float32, device=logits32.device)
        t = t.reshape(-1, *([1] * (logits32.dim() - 1))) if t.dim() == 1 else \
            t.reshape([1] * logits32.dim())
        samp = logits32 / t
    if top_k or top_p is not None:
        samp = top_k_top_p_filter(samp, top_k, top_p)
    return samp


def token_log_prob(logits32: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """log softmax(logits32) at the chosen tokens ``idx``."""
    return torch.log_softmax(logits32, dim=-1).gather(-1, idx[..., None])[..., 0]


class AttentionLSTMGenerator(nn.Module):
    def __init__(
        self, vocab_size: int, feat_dim: int, hidden: int = 512,
        embed_dim: int = 256, attn_dim: int = 256, noise_dim: int = 128,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.attention = AdditiveAttention(feat_dim, hidden, attn_dim, dtype)
        self.cell = TF1LSTMCell(feat_dim + embed_dim + noise_dim, hidden, dtype=dtype)
        self.token_embedding = nn.Parameter(torch.randn(vocab_size, embed_dim) * 0.01)
        self.init_c = init_dense_(nn.Linear(feat_dim, hidden))
        self.init_h = init_dense_(nn.Linear(feat_dim, hidden))
        self.deep_out = init_dense_(nn.Linear(hidden + feat_dim, embed_dim))
        self.vocab_proj = init_dense_(nn.Linear(embed_dim, vocab_size))

    @classmethod
    def from_config(cls, cfg: Config) -> "AttentionLSTMGenerator":
        m = cfg.model
        if m.decoder != "lstm":
            raise NotImplementedError(
                f"AttentionLSTMGenerator is the 'lstm' decoder, not {m.decoder!r}; "
                f"sgg_torch.train.state.make_generator builds either"
            )
        return cls(
            vocab_size=m.vocab_size, feat_dim=cfg.data.feat_dim,
            hidden=m.hidden, embed_dim=m.embed_dim, attn_dim=m.attn_dim,
            noise_dim=m.noise_dim, dtype=m.dtype,
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
        forced_steps: tuple = (),  # the steps to clamp to forced_tokens
        sample_temp=None,  # number, or float32 [B]
        sample_top_k: int = 0,
        sample_top_p: float | None = None,
    ) -> dict[str, torch.Tensor]:
        """Decode one triple per image → soft [B,3,V], logits [B,3,V],
        attention [B,3,R] and tokens [B,3] (argmax of soft, first index
        among ties). Each step's token comes from the logits divided by
        ``sample_temp`` and filtered by ``sample_top_k``/``sample_top_p``
        plus the step's Gumbel noise. With ``detach_sample`` the token is
        argmax(those + noise), its one-hot fed back without gradient, and
        ``log_prob`` float32 [B] = Σₜ log softmax(logitsₜ)[tokenₜ]. A step
        in ``forced_steps`` takes ``forced_tokens[:, t]`` instead (its
        log-probability joins ``log_prob``) and leaves ``gumbel[:, t]``
        unused."""
        dt = self.dtype
        feats = feats.to(dt)
        z = z.to(dt)
        B = feats.shape[0]
        embedding = self.token_embedding.to(dt)
        vs = getattr(self, "vocab_shard", None)

        # Show-Attend-Tell init: LSTM state from the mean image feature.
        mean_feat = feats.mean(dim=1)
        c = torch.tanh(dense(self.init_c, mean_feat, dt))
        h = torch.tanh(dense(self.init_h, mean_feat, dt))

        proj_feats = self.attention.project_features(feats)
        prev_emb = torch.zeros(B, self.embed_dim, dtype=dt, device=feats.device)
        if step_mask is not None:
            step_mask = step_mask.to(device=feats.device, dtype=torch.bool)

        soft_steps, logit_steps, attn_steps, logp_steps = [], [], [], []
        for t in range(TRIPLE_LEN):
            ctx, alpha = self.attention(feats, h, proj_feats)
            x = torch.cat([ctx, prev_emb, z], dim=-1)
            (c, h), _ = self.cell((c, h), x)
            dec = torch.tanh(dense(self.deep_out, torch.cat([h, ctx], dim=-1), dt))
            if vs is None:
                logits = dense(self.vocab_proj, dec, dt)
            else:
                logits = vs.logits(lambda x: dense(self.vocab_proj, x, dt), dec)
            if step_mask is not None:
                logits = torch.where(
                    step_mask[t][None, :], logits,
                    torch.full((), MASK_VALUE, dtype=logits.dtype, device=logits.device),
                )
            logits32 = logits.float()
            samp32 = sampling_logits(logits32, sample_temp, sample_top_k, sample_top_p)
            if t in forced_steps:
                idx = forced_tokens[:, t].to(device=feats.device, dtype=torch.long)
                y = torch.zeros_like(logits32).scatter_(-1, idx[:, None], 1.0).to(dt)
                if detach_sample:  # the clamped token's conditional likelihood
                    logp_steps.append(token_log_prob(logits32, idx))
            elif detach_sample:
                # Gumbel-max: an exact draw, its prefix a constant.
                idx = torch.argmax(samp32 + gumbel[:, t, :].float(), dim=-1)
                y = torch.zeros_like(samp32).scatter_(-1, idx[:, None], 1.0).to(dt)
                logp_steps.append(token_log_prob(logits32, idx))
            else:
                y = gumbel_softmax(samp32, gumbel[:, t, :].float(), tau=tau, hard=hard).to(dt)
            prev_emb = y @ embedding if vs is None else vs.embed(y, self.token_embedding, dt)
            soft_steps.append(y)
            logit_steps.append(logits)
            attn_steps.append(alpha)

        soft = torch.stack(soft_steps, dim=1)
        out = {
            "soft": soft,
            "logits": torch.stack(logit_steps, dim=1),
            "attention": torch.stack(attn_steps, dim=1),
            "tokens": torch.argmax(soft, dim=-1),
        }
        if detach_sample:
            out["log_prob"] = logp_steps[0] + logp_steps[1] + logp_steps[2]
        return out
