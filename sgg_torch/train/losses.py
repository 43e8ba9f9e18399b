"""WGAN-GP objective over (image features, triple) pairs, from
``sgg/train/losses.py``.

  L_D = E[D(fake)] − E[D(real)] + λ·E[(‖∇_x̂ D(x̂)‖₂ − 1)²]
  L_G = −E[D(fake)]

with x̂ = ε·real + (1−ε)·fake between the real one-hot triples and the fake
soft ones. The penalty's gradient is taken with ``create_graph=True``, so the
critic's own gradient differentiates through it. The noise ε is an input
([B, 1, 1] in ``real.dtype``). :func:`reinforce_generator_loss` is the
score-function generator objective, on exact samples and their ``log_prob``.
"""

from __future__ import annotations

from typing import Callable

import torch

Critic = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (feats, triple) -> [B]


def gradient_penalty(critic: Critic, feats: torch.Tensor, real: torch.Tensor,
                     fake: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """E[(‖∇_x̂ D(feats, x̂)‖₂ − 1)²] with x̂ = ε·real + (1−ε)·fake."""
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(feats, x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt((grads.float() ** 2).sum(dim=(1, 2)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


def critic_loss(critic: Critic, feats: torch.Tensor, real: torch.Tensor, fake: torch.Tensor,
                eps: torch.Tensor, gp_lambda: float = 10.0, drift: float = 0.0
                ) -> tuple[torch.Tensor, dict]:
    """Critic loss and its aux scalars; ``fake`` carries no gradient."""
    real_score = critic(feats, real)
    fake_score = critic(feats, fake)
    gp = gradient_penalty(critic, feats, real, fake, eps)
    w_dist = real_score.mean() - fake_score.mean()
    loss = -w_dist + gp_lambda * gp
    if drift:
        loss = loss + drift * (real_score ** 2).mean()
    aux = {"d_loss": loss, "w_dist": w_dist, "gp": gp,
           "real_score": real_score.mean(), "fake_score": fake_score.mean()}
    return loss, aux


def generator_loss(critic: Critic, feats: torch.Tensor, fake: torch.Tensor
                   ) -> tuple[torch.Tensor, dict]:
    fake_score = critic(feats, fake)
    loss = -fake_score.mean()
    return loss, {"g_loss": loss, "g_fake_score": fake_score.mean()}


def reinforce_generator_loss(critic: Critic, feats: torch.Tensor, fake: torch.Tensor,
                             log_prob: torch.Tensor, logits: torch.Tensor | None = None,
                             entropy_coef: float = 0.0) -> tuple[torch.Tensor, dict]:
    """Score-function generator objective: ∇θ E[D(x)] = E[(D(x) − b)·∇θ log πθ(x)]
    with x an exact categorical sample (``fake``, one-hot [B, 3, V] without
    gradient), ``log_prob`` float32 [B] its Σₜ log πₜ(tokenₜ) (which carries
    the gradient) and b the leave-one-out batch baseline (the mean of the other
    rows' rewards; 0 at B = 1). The critic's score is the reward, without
    gradient. With ``entropy_coef`` and ``logits`` [B, 3, V] the loss also
    subtracts coef · E[H(πₜ)]. ``g_loss`` keeps the Gumbel estimator's meaning,
    −E[D(fake)]; the surrogate is ``rl_surrogate``."""
    with torch.no_grad():
        reward = critic(feats, fake).float()
    B = reward.shape[0]
    baseline = (reward.sum() - reward) / (B - 1) if B > 1 else torch.zeros_like(reward)
    adv = reward - baseline
    loss = -(adv * log_prob.float()).mean()
    aux = {"g_loss": -reward.mean(), "g_fake_score": reward.mean(), "rl_surrogate": loss,
           "rl_adv_std": adv.std(correction=0), "rl_log_prob": log_prob.mean()}
    if entropy_coef and logits is not None:
        lp = torch.log_softmax(logits.float(), dim=-1)
        # Masked entries sit near -1e9: p underflows to 0 and adds nothing.
        ent = -(lp.exp() * lp).sum(-1).mean()
        loss = loss - entropy_coef * ent
        aux["rl_entropy"] = ent
        aux["rl_surrogate"] = loss
    return loss, aux
