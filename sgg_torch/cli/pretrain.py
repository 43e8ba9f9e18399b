"""``pretrain`` entry point — supervised encoder pretraining on object labels,
from ``sgg/cli/pretrain.py``.

The grounded recipe's second stage: the VG relationships file names every
image's objects (and, on the grounded corpus or real VG, their boxes), so
object presence (and per-cell ownership, ``--spatial``) is a free supervised
task for the encoder. The product is an ``encoder_params.npz`` (the
reference's flat layout) with ``vocab.json`` and ``pretrain_meta.json``,
which ``preprocess --encoder-ckpt`` of either package reads:

  python -m sgg_torch.cli.pretrain --vg-dir /data/vg --image-dir /data/vg/images \\
      --out-dir /tmp/enc --steps 2000 --batch-size 64

Images decode once through the port's JPEG loader into a uint8 store on the
device (the image size for the spatial task from the first JPEG's header);
each step gathers its batch there (``sgg_torch.train.pretrain``). VGG-19 and
ResNet-50 train on the library conv, the ViT on the CUDA flash kernels; the
held-out report runs on the kernel route. It runs on CUDA unless ``--device
cpu`` is given. A stall watchdog exits 86 when no log line lands for
``--stall-exit-sec``, and ``--checkpoint-every`` writes
``pretrain_resume.npz`` (the port's layout: ``step``, ``count``, and
``p::``, ``mu::`` and ``nu::`` per parameter of the model's state_dict), which
a relaunch resumes from and a finished run removes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sgg_torch.cli.common import add_device_arg, resolve_device
from sgg_torch.data.vg import (
    build_vocab_from_relationships,
    filter_and_encode,
    parse_entity_boxes,
    parse_relationships,
    train_test_split,
)
from sgg_torch.data.vocab import Vocab

RESUME = "pretrain_resume.npz"


def save_resume(path: str, step: int, model, opt) -> None:
    """The run's state at ``step`` in the port's resume layout (atomic)."""
    arrays = {"step": np.asarray(step), "count": np.asarray(opt.count)}
    names = [n for n, _ in model.named_parameters()]
    for n, p, mu, nu in zip(names, opt.params, opt.mu, opt.nu, strict=True):
        arrays[f"p::{n}"] = p.detach().cpu().numpy()
        arrays[f"mu::{n}"] = mu.cpu().numpy()
        arrays[f"nu::{n}"] = nu.cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_resume(path: str, model, opt) -> int:
    """Copy a resume file into the model and optimizer → its step."""
    names = [n for n, _ in model.named_parameters()]
    with np.load(path) as z, torch.no_grad():
        for n, p, mu, nu in zip(names, opt.params, opt.mu, opt.nu, strict=True):
            p.copy_(torch.from_numpy(z[f"p::{n}"]))
            mu.copy_(torch.from_numpy(z[f"mu::{n}"]))
            nu.copy_(torch.from_numpy(z[f"nu::{n}"]))
        opt.load_state_dict({"count": int(z["count"]), "mu": opt.mu, "nu": opt.nu})
        return int(z["step"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vg-dir", required=True, help="dir with relationships.json")
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--vocab", default=None,
                   help="existing vocab.json (e.g. from preprocess) so label ids match the "
                        "GAN vocabulary; default: build one with preprocess's defaults")
    p.add_argument("--encoder", default="vgg19", choices=["vgg19", "resnet50", "vit_b16"])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--max-images", type=int, default=None,
                   help="subsample the train images (decode/device memory budget)")
    p.add_argument("--test-fraction", type=float, default=0.1)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spatial", default="auto", choices=["auto", "on", "off"],
                   help="per-cell owner supervision from entity boxes (grounded corpus / "
                        "real VG): teaches what and where. auto = on iff the relationships "
                        "carry boxes")
    p.add_argument("--spatial-weight", type=float, default=1.0)
    p.add_argument("--moe-experts", type=int, default=0,
                   help="vit_b16 only: each block's MLP becomes a top-k MoE layer with this "
                        "many experts (sgg_torch.models.moe; load-balance term at 0.01)")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--vit-dims", default="768,12,12",
                   help="vit_b16 only: embed_dim,layers,heads (default true B/16)")
    p.add_argument("--stall-exit-sec", type=int, default=900,
                   help="exit 86 when no step readback lands for this long (a hung device "
                        "call; a supervisor relaunches into --checkpoint-every's resume "
                        "file). 0 disables")
    p.add_argument("--checkpoint-every", type=int, default=5000,
                   help="write a resume file (params, optimizer state, step) every N "
                        "steps; a relaunch continues from it. 0 disables")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rel_path = os.path.join(args.vg_dir, "relationships.json")
    if not os.path.exists(rel_path):
        print(f"[sgg.pretrain] missing {rel_path}", file=sys.stderr)
        return 1
    with open(rel_path) as f:  # loaded once, parsed twice (triples + boxes)
        rel_obj = json.load(f)
    images = parse_relationships(rel_obj)
    boxes = parse_entity_boxes(rel_obj) if args.spatial != "off" else {}
    del rel_obj
    have_boxes = any(boxes.values())
    spatial = args.spatial == "on" or (args.spatial == "auto" and have_boxes)
    if args.spatial == "on" and not have_boxes:
        print("[sgg.pretrain] --spatial on but no entity boxes in JSON", file=sys.stderr)
        return 1
    vocab = Vocab.load(args.vocab) if args.vocab else build_vocab_from_relationships(images)
    ids, enc = filter_and_encode(images, vocab)
    train_ids, test_ids = train_test_split(ids, args.test_fraction, args.seed)
    pos = {im: i for i, im in enumerate(ids)}
    if args.max_images is not None and len(train_ids) > args.max_images:
        rng = np.random.RandomState(args.seed)
        keep = rng.choice(len(train_ids), size=args.max_images, replace=False)
        train_ids = [train_ids[i] for i in sorted(keep)]
    test_ids = test_ids[: max(64, args.batch_size)]  # a bounded held-out slice
    print(f"[sgg.pretrain] {len(train_ids)} train / {len(test_ids)} held-out images, "
          f"vocab={len(vocab)}, encoder={args.encoder}", flush=True)

    from sgg_torch import native
    from sgg_torch.data.extract import load_batch, resolve_image_paths
    from sgg_torch.train.pretrain import (
        cell_labels,
        encoder_params_tree,
        evaluate_presence,
        feature_grid,
        make_pretrain_state,
        make_pretrain_step,
        multi_hot_labels,
        save_params_npz,
    )

    t0 = time.time()
    train_paths = resolve_image_paths(train_ids, args.image_dir)
    test_paths = resolve_image_paths(test_ids, args.image_dir)
    n, S = len(train_paths), args.image_size
    images_d = torch.empty((n, S, S, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, 256):
        chunk = torch.from_numpy(load_batch(train_paths[lo:lo + 256], S))
        images_d[lo:lo + 256].copy_(chunk.pin_memory() if device.type == "cuda" else chunk)
        if lo % 5120 == 0 and lo:
            rate = lo / (time.time() - t0)
            print(f"[sgg.pretrain] decoded {lo}/{n} ({rate:.0f}/s)", flush=True)
    test_imgs = load_batch(test_paths, S)
    labels_host = multi_hot_labels([enc[pos[i]] for i in train_ids], len(vocab))
    test_labels = multi_hot_labels([enc[pos[i]] for i in test_ids], len(vocab))
    cells_d = test_cells = None
    if spatial:
        img_wh = native.image_size(train_paths[0])  # corpus-constant (w, h)
        grid = feature_grid(args.encoder, S)
        cells_host = cell_labels([boxes.get(i, []) for i in train_ids], vocab, grid, img_wh)
        test_cells = cell_labels([boxes.get(i, []) for i in test_ids], vocab, grid, img_wh)
        fg = float((cells_host > 0).mean())
        print(f"[sgg.pretrain] spatial task ON: {grid}x{grid} cells, {fg:.0%} foreground, "
              f"image {img_wh[0]}x{img_wh[1]}", flush=True)
        cells_d = torch.from_numpy(cells_host).to(device)
    print(f"[sgg.pretrain] decoded {n} images in {time.time() - t0:.0f}s "
          f"({images_d.numel() / 1e9:.2f} GB)", flush=True)
    labels_d = torch.from_numpy(labels_host).to(device)
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
        print(f"[sgg.pretrain] HBM in use {torch.cuda.memory_allocated(device) / 1e9:.2f} GB / "
              f"limit {total / 1e9:.2f} GB", flush=True)

    vit_dims = tuple(int(v) for v in args.vit_dims.split(","))
    model, opt = make_pretrain_state(
        args.encoder, len(vocab), image_size=S, lr=args.lr,
        dtype=getattr(torch, args.dtype), seed=args.seed, moe_experts=args.moe_experts,
        moe_top_k=args.moe_top_k, vit_dims=vit_dims, device=device)
    step_fn = make_pretrain_step(model, opt, args.batch_size, seed=args.seed, spatial=spatial,
                                 spatial_weight=args.spatial_weight)

    ckpt_path = os.path.join(args.out_dir, RESUME)
    start = 0
    if args.checkpoint_every > 0 and os.path.exists(ckpt_path):
        start = load_resume(ckpt_path, model, opt)
        print(f"[sgg.pretrain] resumed at step {start} ← {ckpt_path}", flush=True)

    from sgg_torch.cli.train import StallWatchdog

    watchdog = StallWatchdog(args.stall_exit_sec, tag="sgg.pretrain")
    try:
        t0 = time.time()
        for i in range(start, args.steps):
            metrics = step_fn(images_d, labels_d, cells_d, step_idx=i)
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                m = {k: float(v) for k, v in metrics.items()}
                cell = f" cell_acc={m['cell_acc']:.3f}" if spatial else ""
                rate = (i + 1 - start) * args.batch_size / (time.time() - t0)
                print(f"[sgg.pretrain] step {i + 1}: loss={m['loss']:.4f} "
                      f"presence_recall={m['presence_recall']:.3f}{cell} img/s={rate:.0f}",
                      flush=True)
                watchdog.stamp()
            if args.checkpoint_every > 0 and (i + 1) % args.checkpoint_every == 0 \
                    and i + 1 < args.steps:
                os.makedirs(args.out_dir, exist_ok=True)
                save_resume(ckpt_path, i + 1, model, opt)
                print(f"[sgg.pretrain] resume checkpoint @ {i + 1}", flush=True)

        report = evaluate_presence(model, test_imgs, test_labels, batch_size=args.batch_size,
                                   cells=test_cells)
    finally:
        watchdog.stop()
    cell = f" cell_acc={report['cell_acc']:.3f}" if spatial else ""
    print(f"[sgg.pretrain] held-out: loss={report['loss']:.4f} "
          f"presence_recall={report['presence_recall']:.3f} "
          f"precision@k={report['precision_at_k']:.3f}{cell}", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    out_npz = os.path.join(args.out_dir, "encoder_params.npz")
    save_params_npz(out_npz, encoder_params_tree(model))
    vocab.save(os.path.join(args.out_dir, "vocab.json"))
    with open(os.path.join(args.out_dir, "pretrain_meta.json"), "w") as f:
        json.dump({
            "encoder": args.encoder,
            "image_size": S,
            "vit_dims": list(vit_dims),
            "moe_experts": args.moe_experts,
            "moe_top_k": args.moe_top_k,
            "steps": args.steps,
            "train_images": n,
            "spatial": spatial,
            "held_out": report,
        }, f, indent=2)
    print(f"[sgg.pretrain] encoder params → {out_npz}", flush=True)
    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # the run is complete; the final npz is the product
    return 0


if __name__ == "__main__":
    sys.exit(main())
