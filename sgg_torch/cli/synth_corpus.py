"""``synth_corpus`` entry point — write a VG-shaped corpus of JPEGs, from
``sgg/cli/synth_corpus.py``.

Real JPEGs on disk plus a VG-schema ``relationships.json`` at Visual Genome
volume (108,077 images of 500 × 375 by default), so preprocess, pretrain and
training run end to end without the real dataset. Plain corpora draw colored
rectangles keyed to token names; ``--grounded`` derives every predicate from
the rendered rectangles' geometry and records VG-style boxes, the corpus the
grounded recipe pretrains an encoder on (``sgg_torch.cli.pretrain``):

  python -m sgg_torch.cli.synth_corpus --out-dir /data/synthvg --grounded

The images and the JSON are the reference's for the same flags (host numpy,
the same draws). The JPEGs are coded by the port's native library, libjpeg at
PIL's default settings (the same bytes as the reference's PIL) or, where
libjpeg's headers are missing, nvJPEG's encoder on the card; the route is
printed. The same flags and the same stats line as the reference.
"""

from __future__ import annotations

import argparse
import json
import sys

from sgg_torch.data.synthetic import write_synthetic_vg_corpus


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--num-images", type=int, default=108077,
                   help="Visual Genome has 108,077 images")
    p.add_argument("--max-rels", type=int, default=12)
    p.add_argument("--vocab-objects", type=int, default=200)
    p.add_argument("--vocab-predicates", type=int, default=60)
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--jpeg-quality", type=int, default=75)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grounded", action="store_true",
                   help="derive predicates from rendered rectangle geometry "
                        "(pixel-learnable image→triple mapping, VG-style boxes in the JSON)")
    args = p.parse_args(argv)

    from sgg_torch import native

    print(f"[sgg.synth_corpus] JPEG encoder: {native.route()}", flush=True)
    stats = write_synthetic_vg_corpus(
        args.out_dir, args.num_images, seed=args.seed, max_rels=args.max_rels,
        vocab_objects=args.vocab_objects, vocab_predicates=args.vocab_predicates,
        width=args.width, height=args.height, jpeg_quality=args.jpeg_quality,
        grounded=args.grounded,
    )
    print("[sgg.synth_corpus] " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
