#!/usr/bin/env python3
"""Probe of the vocab-parallel modules and the TP step on a card, two ranks
over gloo:

  python -m torch.distributed.run --standalone --nproc_per_node 2 scripts/tp_probe.py

Each rank builds the resnet50 config's state (V 8,192) from one seed in
float32 and keeps its slice of V (``place_state``); on seeded inputs:
  - a sum and a gather of a known tensor over the model group;
  - the critic's output and the generator's logits and sample against the
    whole modules;
  - the critic loss's gradients (the gradient penalty's double backward
    through the collectives) against the whole critic's, and the
    collectives that it calls, in order;
  - one train step (the frozen ResNet-50 on the library route, B 8) at
    n_critic 1 and 5: TP against the single-device step on the same batch
    and noise, and the single-device step against itself from a state one
    ulp apart at one element of the critic, which shows how far Adam's
    updates carry float32 rounding.
Prints each max |d|; exits 1 if the modules, the gradients or the step at
n_critic 1 pass their bounds (1e-4, 1e-3 relative, rtol 1e-4).
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgg_torch.config import get_config  # noqa: E402
from sgg_torch.dist import initialize_multihost, mesh_from_config  # noqa: E402
from sgg_torch.dist import multihost as mh  # noqa: E402
from sgg_torch.dist.sharding import place_state, state_sharding  # noqa: E402
from sgg_torch.train.state import create_train_state  # noqa: E402


def main() -> int:
    dev = initialize_multihost("cuda")
    cfg = get_config("resnet50").override(["mesh.model=2", "model.compute_dtype=float32",
                                           "model.encoder=precomputed"])
    mesh = mesh_from_config(cfg.mesh, dev)
    r = dist.get_rank()
    bad = []
    x = torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * r
    s = mh.sum_tensor(x, mesh.model_group)
    g = mh.gather_tensor(x, mesh.model_group, -1)
    want_s = 2 * torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10
    print(f"rank {r}: sum {float((s - want_s).abs().max())}, gather {g.tolist()}", flush=True)
    if not torch.equal(s, want_s):
        bad.append("sum")
    whole = create_train_state(cfg, 0, device=dev)
    part = create_train_state(cfg, 0, device=dev)
    place_state(part, state_sharding(part, mesh, tp=True), mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    B, V, F, R = 8, cfg.model.vocab_size, cfg.data.feat_dim, cfg.data.regions
    feats = torch.randn(B, R, F, generator=gen, device=dev)
    tri = torch.softmax(torch.randn(B, 3, V, generator=gen, device=dev), -1)
    z = torch.randn(B, cfg.model.noise_dim, generator=gen, device=dev)
    gum = torch.randn(B, 3, V, generator=gen, device=dev)
    with torch.no_grad():
        d = float((part.critic(feats, tri) - whole.critic(feats, tri)).abs().max())
        a_ = part.generator(feats, z, gum)
        b_ = whole.generator(feats, z, gum)
        dl = float((a_["logits"] - b_["logits"]).abs().max())
        ds = float((a_["soft"] - b_["soft"]).abs().max())
    print(f"rank {r}: critic max |d| {d}, generator logits {dl}, soft {ds}", flush=True)
    if max(d, dl, ds) > 1e-4:
        bad.append("modules")
    # The critic loss's gradients (the penalty's double backward through the
    # collectives), this rank's slice of V against the whole module's.
    from sgg_torch.train.losses import critic_loss

    calls = []
    for name_ in ("gather_tensor", "sum_tensor"):
        fn_ = getattr(mh, name_)

        def logged(x_, *a, _fn=fn_, _n=name_, **k):
            calls.append((_n, tuple(x_.shape), round(float(x_.double().sum()), 3)))
            return _fn(x_, *a, **k)

        setattr(mh, name_, logged)
    real = torch.nn.functional.one_hot(torch.randint(0, V, (B, 3), generator=gen, device=dev),
                                       V).float()
    eps = torch.rand(B, 1, 1, generator=gen, device=dev)
    grads = []
    for st in (part, whole):
        params = list(st.critic.parameters())
        loss, _ = critic_loss(st.critic, feats, real, tri, eps)
        grads.append(torch.autograd.grad(loss, params))
    names = [n for n, _ in part.critic.named_parameters()]
    worst = {}
    for n, gp_, gw in zip(names, *grads):
        if gp_.shape != gw.shape:  # this rank's slice of V
            gw = gw.narrow(0, r * gp_.shape[0], gp_.shape[0]) if gw.dim() and \
                gw.shape[0] != gp_.shape[0] else gw
        worst[n] = float((gp_ - gw).abs().max() / (gw.abs().max() + 1e-12))
    print(f"rank {r}: critic loss gradients, max |d| / max per tensor {worst}", flush=True)
    print(f"rank {r}: {len(calls)} collectives: {calls[:40]}", flush=True)
    if max(worst.values()) > 1e-3:
        bad.append("gradients")
    for k_, v_ in list(vars(mh).items()):
        if k_ in ("gather_tensor", "sum_tensor"):
            setattr(mh, k_, v_.__wrapped__ if hasattr(v_, "__wrapped__") else v_)
    # One whole train step (resnet50's frozen encoder, pixels in), TP against
    # the single-device step on the same batch and noise, at n_critic 1 and 5;
    # and at 5 the single-device step against itself from a state one ulp
    # apart at one element (how far Adam carries float32 rounding).
    from sgg_torch.train.step import make_step_fn

    for nc in (1, 5):
        cfg2 = get_config("resnet50").override([
            "mesh.model=2", "model.compute_dtype=float32", "model.use_pallas=false",
            "train.batch_size=8", f"train.n_critic={nc}"])
        states = [create_train_state(cfg2, 0, device=dev) for _ in range(3)]
        place_state(states[0], state_sharding(states[0], mesh, tp=True), mesh)
        with torch.no_grad():
            w_ = states[2].critic.trunk_0.kernel
            w_.view(-1)[0] = torch.nextafter(w_.view(-1)[0], torch.tensor(1.0, device=dev))
        batch = {"images": torch.randint(0, 256, (nc + 1, 8, 224, 224, 3), generator=gen,
                                         device=dev, dtype=torch.uint8),
                 "triples": torch.randint(2, V, (nc + 1, 8, 3), generator=gen, device=dev)}
        step_w = make_step_fn(cfg2, None)
        noise = step_w.inputs(0, 8, dev)
        ms = [make_step_fn(cfg2, None, mesh=mesh)(states[0], batch, noise),
              step_w(states[1], batch, noise), step_w(states[2], batch, noise)]
        ms = [{k_: float(v_) for k_, v_ in m_.items()} for m_ in ms]
        rel = [max(abs(m_[k_] - ms[1][k_]) / (abs(ms[1][k_]) + 1e-6) for k_ in ms[1])
               for m_ in (ms[0], ms[2])]
        print(f"rank {r}: n_critic {nc}: metrics TP {ms[0]}; one {ms[1]}; one, an ulp apart "
              f"{ms[2]}; max relative |d| TP {rel[0]:.3g}, ulp {rel[1]:.3g}", flush=True)
        if nc == 1 and rel[0] > 1e-4:
            bad.append("step")
    dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
