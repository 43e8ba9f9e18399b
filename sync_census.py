#!/usr/bin/env python3
"""Where the eager pipeline_v4 step waits for the card, for checkouts of the port.

  python3 sync_census.py [TREE ...]

Each TREE is a directory that holds a ``sgg_torch/`` package (default: this
repository). The script writes a seeded pipeline_v4 corpus once (1,024 train
and 64 held-out images of 196 x 512 float16 features, the trained run's
vocab; ``chip_smoke.v4_corpus``), then, for the trees in the order TREE1,
TREE2, ..., TREE2, TREE1, runs ``python -m sgg_torch.cli.train --config
pipeline_v4 --profile`` from that tree in a subprocess at the config's
widths for 16 steps with the whole int8 store on the card, and reads the
trace of its profile window (steps 10-14) with this repository's
``sgg_torch.utils.profiling.sync_sites``: the host's waits for the device
(``SYNC_CALLS``) per step, by the chain of operators that made them, and
the window's s/step. Needs the card.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS, IMAGES, TEST_IMAGES = 16, 1024, 64


def write_corpus(data_dir):
    import numpy as np
    import torch

    import chip_smoke
    from sgg_torch.data import Vocab, write_feature_shard
    from sgg_torch.data.shards import shard_name

    vocab = Vocab.load(os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt", "vocab.json"))
    os.makedirs(os.path.join(data_dir, "test"))
    vocab.save(os.path.join(data_dir, "vocab.json"))
    for sub, n, seed in (("", IMAGES, 1), ("test", TEST_IMAGES, 2)):
        feats, triples = chip_smoke.v4_corpus(vocab, n, seed, torch.device("cuda"))
        write_feature_shard(os.path.join(data_dir, sub, shard_name(0, 1)), np.arange(n),
                            feats, triples)


def run(tree, data_dir, wd):
    argv = [sys.executable, "-m", "sgg_torch.cli.train", "--config", "pipeline_v4",
            "--workdir", wd, "--steps", str(STEPS), "--profile"]
    for k, v in (("data.data_dir", data_dir), ("data.device_resident_max_bytes", 2_000_000_000),
                 ("train.log_every", STEPS), ("train.eval_every", 0),
                 ("train.steps_per_dispatch", 1)):
        argv += ["--set", f"{k}={v}"]
    env = dict(os.environ, PYTHONPATH=tree)
    out = subprocess.run(argv, cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise SystemExit(f"sync_census: the run from {tree} failed:\n{out.stdout}\n{out.stderr}")
    from sgg_torch.utils.profiling import sync_sites

    sites = sync_sites(os.path.join(wd, "profile", "trace.json"))
    with open(os.path.join(wd, "profile", "top_ops.txt")) as f:
        first = f.readline().strip()
    steps = int(re.search(r"\((\d+) steps\)", first).group(1))
    return {"window": first, "steps": steps, "syncs": sum(sites.values()),
            "per_step": sum(sites.values()) / steps, "sites": sites}


def main():
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sync_census: CUDA is not available; this script needs the card")
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "corpus")
        write_corpus(data_dir)
        order = trees + trees[::-1] if len(trees) > 1 else trees
        for i, tree in enumerate(order):
            r = run(tree, data_dir, os.path.join(tmp, f"wd{i}"))
            print(json.dumps({"tree": tree, **{k: v for k, v in r.items() if k != "sites"}}),
                  flush=True)
            for chain, n in r["sites"].items():
                print(f"  {n / r['steps']:8.2f} a step  {chain}", flush=True)


if __name__ == "__main__":
    main()
