"""Phase 29 (c)'s gradient gate over seeds: how far the card's and the CPU's
float32 gradients of a ``vg_full`` ``train_encoder`` step sit from the float64
oracle.

  python3 scripts/cnn_grad_spread.py [--seeds 0,1,2] [--float64-on-card] [--tf32]
      [--device cpu] [--size 224] [--batch 4]

For each seed runs ``chip_smoke.cnn_hold`` (VGG-19, 224 px, B 4, n_critic 1,
float32) and prints, for the critic's and the encoder's gradients of the
first critic update, the card's and the CPU's distance from the float64
oracle (the largest over a module's tensors, each relative to the oracle
tensor's largest element), their ratio, the card's distance from the CPU, the
tensor where the card sits farthest, and each run's seconds; then the
largest ratio over the seeds. ``--float64-on-card`` also computes the oracle
on the card and prints how far the two float64 results sit apart.
``--tf32`` lets cuDNN use TF32 for the float32 convs (the fault that the gate
must refuse). Prints the card's name and power limit first; ``--device cpu``
(a dry run at ``--size 32``) prints none.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SMALL = {"model.hidden": 32, "model.embed_dim": 16, "model.attn_dim": 16,
         "model.noise_dim": 8, "model.critic_hidden": 32, "data.regions": 4,
         "data.feat_dim": 512}  # decoder widths of a dry run on the CPU


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch", type=int, default=chip_smoke.P29_HOLD_BATCH)
    p.add_argument("--float64-on-card", action="store_true")
    p.add_argument("--tf32", action="store_true",
                   help="cuDNN's TF32 on for float32 convs (the seeded fault)")
    args = p.parse_args()
    from sgg_torch.kernels import conv_direct

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    if args.tf32:
        conv_direct.tf32_allowed = lambda dtype: dtype.is_floating_point
    extra = SMALL if args.device == "cpu" else None
    ratios = {"d": [], "enc": []}
    for seed in (int(x) for x in args.seeds.split(",")):
        ok, nums = chip_smoke.cnn_hold(
            args.device, seed=seed, batch=args.batch, size=args.size, extra_sets=extra,
            second_oracle=args.device if args.float64_on_card else None)
        for key, g in nums["grads"].items():
            ratios[key].append(g["card"] / g["cpu"])
            print(f"seed {seed} {'critic' if key == 'd' else 'encoder'}: card {g['card']:.4e}, "
                  f"CPU {g['cpu']:.4e} from the float64 oracle (ratio {g['card'] / g['cpu']:.3f}; "
                  f"limit {g['limit']:.4e}); card from CPU {g['card_cpu']:.4e}; the card's "
                  f"worst tensor #{g['worst_tensor']} (the CPU there {g['cpu_at_worst']:.4e})",
                  flush=True)
        for key, g in nums["grads"].items():
            top = sorted(enumerate(g["per_tensor"]),
                         key=lambda x: -x[1][0] / max(x[1][1], 1e-300))[:4]
            print(f"seed {seed} {'critic' if key == 'd' else 'encoder'}: the tensors where the "
                  f"card sits farthest beyond the CPU (#, card, CPU): "
                  f"{[(i, f'{c:.3e}', f'{p:.3e}') for i, (c, p) in top]}", flush=True)
        print(f"seed {seed}: hold {'ok' if ok else 'FAILED ' + '; '.join(nums['bad'])}; "
              f"seconds {nums['seconds']}", flush=True)
        if "oracles_apart" in nums:
            print(f"seed {seed}: the float64 oracle on {args.device} against the CPU's "
                  f"(largest relative distance a module): {nums['oracles_apart']}", flush=True)
    print(f"largest ratio card/CPU over seeds {args.seeds}: critic {max(ratios['d']):.3f}, "
          f"encoder {max(ratios['enc']):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
