"""VGG-19's library conv in float32, layer by layer, on the card and on the CPU
against float64: where a trainable CNN's float32 gradients part from the
oracle.

  python3 scripts/cnn_layer_spread.py [--seeds 0,2] [--device cpu] [--size 224]
      [--batch 4]

For each seed, ``chip_smoke.cnn_hold``'s images and seeded VGG-19
(``create_train_state`` of its config) run the 16 convs' chain in float64 on
the CPU. At each conv its float64 input, rounded to float32, and its float32
kernel go through ``conv2d_nhwc_f32`` (the library conv a trainable CNN runs:
cuDNN on the card, TF32 off for float32 operands) on the card and on the
CPU, forward and backward (a seeded upstream gradient), and each output, dx
and dw is held against float64 on the same float32 values: the largest
distance relative to the float64 result's largest element, card and CPU
side by side. Then the whole encoder's features and the features' distance
on both devices. Prints the card's name and power limit first; ``--device
cpu`` (a dry run at ``--size 32``) prints none.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def rel(a, ref) -> float:
    return float((a.double().cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", default="0,2")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch", type=int, default=chip_smoke.P29_HOLD_BATCH)
    args = p.parse_args()
    import torch
    import torch.nn.functional as F

    from sgg_torch.kernels.conv import max_pool_nhwc
    from sgg_torch.kernels.conv_direct import conv2d_nhwc_f32
    from sgg_torch.models.encoders import normalize_for
    from sgg_torch.models.vgg import conv_names
    from sgg_torch.train.state import create_train_state

    dev = args.device
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
    extra = {"data.regions": 4} if dev == "cpu" else None
    for seed in (int(x) for x in args.seeds.split(",")):
        cfg, data, _ = chip_smoke.cnn_hold_inputs(seed, args.batch, args.size, extra)
        enc = create_train_state(cfg, seed).encoder
        x64 = normalize_for("vgg19", torch.from_numpy(data["images"][0])).double()
        g = torch.Generator().manual_seed(seed + 7)
        rows = []
        for i, name in enumerate(conv_names()):
            conv = getattr(enc, name)
            x32, w32 = x64.float(), conv.kernel.detach().float()
            gy = torch.randn(*x32.shape[:3], w32.shape[3], generator=g)

            def run(device, dtype):
                x = x32.to(device, dtype).requires_grad_(True)
                w = w32.to(device, dtype).requires_grad_(True)
                y = conv2d_nhwc_f32(x, w) if dtype == torch.float32 else F.conv2d(
                    F.pad(x, (0, 0, 1, 1, 1, 1)).permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
                dx, dw = torch.autograd.grad((y * gy.to(device, dtype)).sum(), (x, w))
                return y.detach(), dx, dw

            ref = [t.cpu() for t in run("cpu", torch.float64)]
            card, cpu = run(dev, torch.float32), run("cpu", torch.float32)
            rows.append((name, [(rel(c, r), rel(q, r)) for c, q, r in zip(card, cpu, ref)]))
            # the next layer's float64 input: bias, ReLU and the block's pool
            x64 = torch.relu(ref[0] + conv.bias.detach().double())
            if name.endswith(("1_2", "2_2", "3_4", "4_4")):
                x64 = max_pool_nhwc(x64, 2, 2, "VALID")
        for name, errs in rows:
            print(f"seed {seed} {name} (card, CPU) from float64: "
                  + ", ".join(f"{what} ({c:.3e}, {q:.3e}; {c / max(q, 1e-300):.2f}x)"
                              for what, (c, q) in zip(("y", "dx", "dw"), errs)), flush=True)
        worst = max(c / max(q, 1e-300) for _, errs in rows for c, q in errs)
        feats = {}
        with torch.no_grad():
            img = normalize_for("vgg19", torch.from_numpy(data["images"][0]))
            for device in (dev, "cpu"):
                feats[device] = enc.to(device)(img.to(device)).cpu()
            enc64 = enc.to("cpu").double()
            with chip_smoke.float64_mode():
                f64 = enc64(img.double())
        print(f"seed {seed}: the largest card/CPU ratio over the convs {worst:.2f}; the "
              f"encoder's features from float64: card {rel(feats[dev], f64):.3e}, CPU "
              f"{rel(feats['cpu'], f64):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
