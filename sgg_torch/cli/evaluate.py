"""Recall of a trained run on the held-out split, from ``sgg/cli/evaluate.py``.

Sample K draws per held-out image, rank each image's triples and score them
against the ground truth: recall@k at every ``--k``, optionally with
bootstrap intervals (``--bootstrap``), zero-shot recall (``--zero-shot``) and
predicate-balanced mean recall (``--per-predicate``). ``--num-samples``,
``--temperature``, ``--rank``, ``--predicate-adjust`` and ``--exclude-seen``
take comma-separated sweeps that share one sampling pass per temperature (the
first K' of K draws are a K'-draw run; the rankings re-rank the same tokens
on the host); ``--json-out`` writes the whole grid.

  python -m sgg_torch.cli.evaluate --workdir W --ema --avg-last 5 --rank logp \\
      --k 20,50,100 --zero-shot --per-predicate [--device cpu]

The weights are the workdir's latest (``generator.pt``), or with
``--avg-last N`` the mean of the generator's weights (and of their EMA) over
the last N retained checkpoints; ``--ema`` samples from the EMA weights.
``--decode xla`` (the default) runs the generator's forward per draw;
``--decode fused`` one ``fused_decode`` launch per draw and batch, which
draws at temperature 1 without log-probabilities, so it refuses ``--rank
freq_logp|logp``, a temperature sweep and ``--top-k``/``--top-p``, as the
reference does. ``--predcls`` also reports predicate classification: every
ground-truth triple of the evaluated images is a row, the decode is clamped to
its subject and object, the predicate's log-probability is mixture-averaged
over ``--predcls-samples`` draws (``sgg_torch.eval.sampler.make_predcls_scorer``)
and P-R@k counts the rows whose true predicate ranks in the top k.
Pixels-in workdirs encode each batch as ``sgg_torch.cli.generate`` does (the
``vg`` source's held-out JPEGs decoded per batch). It runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from sgg_torch.cli.common import add_device_arg, load_dataset, resolve_device
from sgg_torch.cli.generate import make_batch_features
from sgg_torch.eval.recall import (
    corpus_mean_recall,
    corpus_recall_bootstrap,
    corpus_recall_multi,
    corpus_zero_shot_recall,
    predicate_recall,
)
from sgg_torch.eval.sampler import (
    make_fused_sampler,
    make_predcls_scorer,
    make_sampler,
    rank_triples,
)
from sgg_torch.kernels.build import load_library
from sgg_torch.train.checkpoint import load_workdir, restore_weights

RANKS = ("freq", "freq_logp", "logp")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--k", default="50",
                   help="recall cutoff(s); comma-separated for several (one sampling pass)")
    p.add_argument("--per-predicate", action="store_true",
                   help="also report mean recall (mR@k at the largest k) and the worst and "
                        "best predicates")
    p.add_argument("--num-samples", default="100",
                   help="noise draws per image; comma-separated values sweep from one pass "
                        "at the largest (each K' takes the first K' draws)")
    p.add_argument("--temperature", default=None,
                   help="sampling temperature(s): tokens ~ softmax(logits / T), default 1.0; "
                        "comma-separated to sweep")
    p.add_argument("--rank", default="freq",
                   help="triple order(s) the recall cut uses: freq, freq_logp or logp; "
                        "comma-separated to sweep")
    p.add_argument("--predicate-adjust", default="0", metavar="ALPHA",
                   help="rank=logp only: subtract ALPHA * log p(predicate), the train "
                        "split's smoothed prior, from each triple's score; "
                        "comma-separated to sweep")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling per decode step (--decode xla only)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling per decode step, 0 = off (--decode xla only)")
    p.add_argument("--num-images", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--split", default="test", choices=["train", "test"])
    p.add_argument("--decode", default="xla", choices=["xla", "fused"],
                   help="decode path (see sgg_torch.cli.generate --decode)")
    p.add_argument("--ema", action="store_true", help="sample from the EMA generator weights")
    p.add_argument("--avg-last", type=int, default=0, metavar="N",
                   help="average the generator's weights (and their EMA) over the last N "
                        "retained checkpoints; 0 or 1 = the latest")
    p.add_argument("--zero-shot", action="store_true",
                   help="also report recall over held-out triples never seen in training")
    p.add_argument("--predcls", action="store_true",
                   help="also report predicate classification (PredCls): rank predicates "
                        "with the decode clamped to each GT (subject, object) pair; P-R@k = "
                        "GT predicate in the top k of the conditional distribution")
    p.add_argument("--predcls-samples", type=int, default=16,
                   help="noise draws mixture-averaged per PredCls row")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="also report 95%% percentile-bootstrap intervals over images "
                        "(N replicates)")
    p.add_argument("--json-out", default=None, metavar="PATH",
                   help="write the whole result grid as one JSON file")
    p.add_argument("--exclude-seen", default="off", choices=["off", "on", "sweep"],
                   help="drop train-seen triples from each image's draws before ranking; "
                        "'sweep' scores both")
    p.add_argument("--stall-exit-sec", type=int, default=900,
                   help="exit 86 when no sampling batch lands for this long; 0 disables")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    say = lambda m: print(f"[sgg.evaluate] {m}", flush=True)  # noqa: E731
    err = lambda m: print(f"[sgg.evaluate] {m}", file=sys.stderr)  # noqa: E731
    temps = ([None] if args.temperature in (None, "") else
             [float(x) for x in str(args.temperature).split(",") if x.strip()])
    ranks = [r.strip() for r in str(args.rank).split(",") if r.strip()]
    for r in ranks:
        if r not in RANKS:
            err(f"unknown --rank {r!r}")
            return 2
    with_logp = any(r != "freq" for r in ranks)
    if args.decode == "fused":
        if args.top_k or args.top_p is not None:
            err("--top-k/--top-p filter the sampling distribution, which the fused kernel "
                "does not implement; use --decode xla")
            return 2
        if with_logp:
            err("--rank freq_logp/logp needs per-draw log-probs, which the fused kernel "
                "does not emit; use --decode xla")
            return 2
        if len(temps) > 1 or (temps[0] is not None and temps[0] != 1.0):
            err("the fused kernel samples at temperature 1.0 only; use --decode xla for "
                "--temperature")
            return 2
    device = resolve_device(args.device)

    cfg, vocab = load_workdir(args.workdir)
    cfg.model.vocab_size = len(vocab)
    if args.decode == "fused" and cfg.model.decoder != "lstm":
        err(f"--decode fused runs the attention-LSTM decoder only; this workdir's "
            f"model.decoder is {cfg.model.decoder!r}: use --decode xla")
        return 2
    ds, _ = load_dataset(cfg, split=args.split)
    n_images = min(args.num_images or len(ds), len(ds))

    restored = restore_weights(args.workdir, cfg, args.avg_last, device)
    if restored is None:
        err(f"no checkpoint in {args.workdir}")
        return 1
    step, g_params, g_ema, enc_params, avg_steps = restored
    say(f"restored step {step}")
    if avg_steps is not None:
        say(f"--avg-last: generator weights averaged over {len(avg_steps)} checkpoints "
            f"(steps {avg_steps})")
    if args.ema:
        if g_ema is None:
            err("--ema: checkpoint has no EMA weights (train with train.ema_decay > 0)")
            return 1
        g_params = g_ema
    g_params = {k: v.to(device) for k, v in g_params.items()}
    if cfg.model.encoder != "precomputed" and enc_params is None:
        err(f"encoder {cfg.model.encoder!r}: no encoder weights in {args.workdir}")
        return 1

    ex_opts = {"off": [False], "on": [True], "sweep": [False, True]}[args.exclude_seen]
    kss = sorted({int(x) for x in str(args.num_samples).split(",") if x.strip()}) or [100]
    n_draws = kss[-1]  # one pass at the largest K; smaller Ks are its prefixes
    if args.decode == "fused":
        sampler = make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=n_draws,
                                     tau=temps[0])
    else:
        sampler = make_sampler(cfg, step_mask=vocab.step_mask(), num_samples=n_draws,
                               tau=temps[0], with_logp=with_logp, top_k=args.top_k or 0,
                               top_p=args.top_p)
    batch_features = make_batch_features(cfg, ds, enc_params, device)

    alphas = [float(x) for x in str(args.predicate_adjust).split(",") if x.strip()] or [0.0]
    log_prior = None
    if any(a != 0 for a in alphas):
        if "logp" not in ranks:
            err("--predicate-adjust applies to --rank logp only")
            return 2
        train_ds, _ = load_dataset(cfg, split="train")
        counts = np.zeros(len(vocab), np.float64)
        for trips in train_ds.triples:
            for t in trips:
                counts[int(t[1])] += 1.0
        prior = (counts + 1.0) / (counts.sum() + len(vocab))  # smoothed
        log_prior = np.log(prior)
    # The α sweep applies to rank=logp only; it and the exclude-seen filter
    # re-rank the same tokens on the host.
    rcombos = [(r, a, e) for r in ranks for a in (alphas if r == "logp" else [0.0])
               for e in ex_opts]
    adj_map = {(r, a): (a * log_prior if (r == "logp" and a != 0) else None)
               for r, a, _ in rcombos}
    seen = None
    if args.zero_shot or any(e for _, _, e in rcombos):
        train_ds, _ = load_dataset(cfg, split="train")
        seen = {tuple(int(x) for x in t) for trips in train_ds.triples for t in trips}

    progress = {"t": time.time()}
    if args.stall_exit_sec > 0:
        def _stall_watchdog():
            while True:
                time.sleep(30)
                dt = time.time() - progress["t"]
                if dt > args.stall_exit_sec:
                    print(f"[sgg.evaluate] STALL: no batch for {dt:.0f}s, exit 86",
                          flush=True)
                    os._exit(86)

        threading.Thread(target=_stall_watchdog, daemon=True,
                         name="sgg-torch-evaluate-stall").start()

    if device.type == "cuda" and args.decode == "fused":
        load_library()  # build and load the kernels outside the timing
    generator = torch.Generator(device=device).manual_seed(args.seed)
    B = args.batch_size
    gen = {(ti, ks, r, a, e): [] for ti in range(len(temps)) for ks in kss
           for (r, a, e) in rcombos}
    gt_triples = []
    n_sampled = 0
    t0 = time.perf_counter()
    for lo in range(0, n_images, B):
        idx = np.arange(lo, min(lo + B, n_images))
        feats = batch_features(idx)
        if feats.shape[0] < B:  # pad to the batch shape with the last row
            feats = torch.cat([feats, feats[-1:].expand(B - feats.shape[0],
                                                        *feats.shape[1:])])
        for ti, T in enumerate(temps):
            if args.decode == "fused":
                out = sampler(g_params, feats, generator)
            else:
                out = sampler(g_params, feats, generator, temp=T)
            if with_logp:
                tokens, logp = (x.cpu().numpy() for x in out)
            else:
                tokens, logp = out.cpu().numpy(), None
            score_batch(gen, tokens, logp, len(idx), kss, rcombos, adj_map, seen, ti)
            n_sampled += len(idx) * n_draws
        gt_triples.extend([tuple(map(int, t)) for t in ds.triples[i]] for i in idx)
        progress["t"] = time.time()
    dt = time.perf_counter() - t0
    say(f"sampled {n_images} images x {n_draws} draws x {len(temps)} temperature(s) in "
        f"{dt:.2f}s ({n_sampled / dt if dt > 0 else 0.0:.0f} triples/sec, decode "
        f"{args.decode})")
    report(args, temps, kss, rcombos, gen, gt_triples, seen, vocab, n_images)
    if args.predcls:
        # Last, as the reference runs it: the grid's JSON is written already.
        scorer = make_predcls_scorer(cfg, step_mask=vocab.step_mask(),
                                     num_samples=args.predcls_samples, tau=temps[0])
        predcls(args, scorer, g_params, batch_features, gt_triples, len(vocab), generator)
    return 0


def predcls(args, scorer, g_params, batch_features, gt_triples, V: int, generator) -> dict:
    """Score every GT triple of ``gt_triples`` (one list per image) in chunks
    of ``--batch-size`` rows, the last padded with its last row, and print
    P-R@k; returns {k: P-R@k}."""
    rows = np.asarray([(i, s, p, o) for i, trips in enumerate(gt_triples) for s, p, o in trips],
                      np.int64).reshape(-1, 4)
    n_rows, B = len(rows), args.batch_size
    scores = np.zeros((n_rows, V), np.float32)
    t0 = time.perf_counter()
    for lo in range(0, n_rows, B):
        chunk = rows[lo:lo + B]
        if len(chunk) < B:  # pad to the batch shape with the last row
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - len(chunk), axis=0)])
        feats = batch_features(chunk[:, 0])
        out = scorer(g_params, feats, chunk[:, 1], chunk[:, 3], generator)
        scores[lo:lo + B] = out.cpu().numpy()[:min(B, n_rows - lo)]
    dt = time.perf_counter() - t0
    ks = sorted({int(k) for k in str(args.k).split(",") if k.strip()})
    pr = predicate_recall(scores, rows[:, 2], ks)
    rep = " ".join(f"P-R@{k} = {pr[k]:.4f}" for k in ks)
    print(f"[sgg.evaluate] predcls ({n_rows} GT triples, {args.predcls_samples} draws/row): "
          f"{rep}", flush=True)
    print(f"[sgg.evaluate] predcls: {n_rows} rows scored in {dt:.3f}s "
          f"({n_rows / dt if dt > 0 else 0.0:.0f} rows/sec)", flush=True)
    return pr


def score_batch(gen: dict, tokens, logp, n: int, kss, rcombos, adj_map, seen, ti) -> None:
    """Rank the first ``n`` rows of one batch's draws (tokens [B, K, 3],
    logp [B, K] or None) for every (K', rank, alpha, exclude-seen) combo at
    temperature index ``ti``, appending to ``gen``."""
    for j in range(n):
        for ks in kss:
            lp_j = None if logp is None else logp[j, :ks]
            novel_mask = None
            for r, a, e in rcombos:
                tk, lp2 = tokens[j, :ks], lp_j
                if e:
                    if novel_mask is None or len(novel_mask) != ks:
                        novel_mask = np.fromiter(
                            (tuple(map(int, t)) not in seen for t in tk), bool, ks)
                    tk = tk[novel_mask]
                    lp2 = None if lp2 is None else lp2[novel_mask]
                gen[(ti, ks, r, a, e)].append(
                    rank_triples(tk, lp2, rank=r, pred_adjust=adj_map[(r, a)]))


def report(args, temps, kss, rcombos, gen, gt_triples, seen, vocab, n_images) -> dict:
    """Print (and with ``--json-out`` write) the result grid; returns its
    records."""
    ks = sorted({int(k) for k in str(args.k).split(",") if k.strip()})
    combos = [(ti, ksamp, r, a, e) for ti in range(len(temps)) for ksamp in kss
              for (r, a, e) in rcombos]
    multi = len(combos) > 1

    def combo_tag(ti, ksamp, r, a, e):
        if not multi:
            return ""
        tag = f" T={1.0 if temps[ti] is None else temps[ti]:g} rank={r}"
        if len(kss) > 1:
            tag += f" K={ksamp}"
        tag += f" adj={a:g}" if a else ""
        return tag + (" novel-only" if e else "")

    records = {}
    for combo in combos:
        ti, ksamp, r, a, e = combo
        gen_triples, tag = gen[combo], combo_tag(*combo)
        recalls = corpus_recall_multi(gen_triples, gt_triples, ks)
        rec = {"temperature": 1.0 if temps[ti] is None else temps[ti],
               "num_samples": ksamp, "rank": r, "predicate_adjust": a,
               "exclude_seen": bool(e), "recall": {str(k): recalls[k] for k in ks}}
        records[combo] = rec
        rep = " ".join(f"recall@{k} = {recalls[k]:.4f}" for k in ks)
        print(f"[sgg.evaluate]{tag} split={args.split} images={n_images} "
              f"samples/image={ksamp} {rep}", flush=True)
        if args.bootstrap > 0:
            cis = corpus_recall_bootstrap(gen_triples, gt_triples, ks,
                                          n_boot=args.bootstrap, seed=args.seed)
            rec["recall_ci95"] = {str(k): [cis[k][1], cis[k][2]] for k in ks}
            rep = " ".join(f"recall@{k} in [{cis[k][1]:.4f}, {cis[k][2]:.4f}]" for k in ks)
            print(f"[sgg.evaluate]{tag} bootstrap 95% CI ({args.bootstrap} replicates over "
                  f"images): {rep}", flush=True)
        if seen is not None and args.zero_shot:
            zs, n_zs = corpus_zero_shot_recall(gen_triples, gt_triples, seen, ks)
            rec["zero_shot_recall"] = {str(k): zs[k] for k in ks}
            rec["zero_shot_images"] = n_zs
            rep = " ".join(f"zsR@{k} = {zs[k]:.4f}" for k in ks)
            print(f"[sgg.evaluate]{tag} zero-shot ({n_zs}/{n_images} images with GT "
                  f"triples unseen in {len(seen)} train triples): {rep}", flush=True)

    def write_json(partial: bool) -> None:
        if not args.json_out:
            return
        with open(args.json_out, "w") as f:
            json.dump({"workdir": args.workdir, "split": args.split, "images": int(n_images),
                       "seed": args.seed, "ema": bool(args.ema), "decode": args.decode,
                       "avg_last": int(args.avg_last), "partial": partial,
                       "combos": list(records.values())}, f, indent=2)
        print(f"[sgg.evaluate] wrote {args.json_out} "
              f"({len(records)} combos{', partial' if partial else ''})", flush=True)

    write_json(partial=bool(args.per_predicate))
    if args.per_predicate:
        kmax = max(ks)
        for combo in combos:
            mr, table = corpus_mean_recall(gen[combo], gt_triples, k=kmax)
            records[combo][f"mean_recall@{kmax}"] = mr
            print(f"[sgg.evaluate]{combo_tag(*combo)} mR@{kmax} = {mr:.4f} "
                  f"over {len(table)} predicates with support", flush=True)
            if multi:
                continue  # worst/best tables only for single-combo runs
            by_r = sorted(table.items(), key=lambda kv: kv[1][0])
            for tag, rows in (("worst", by_r[:5]), ("best", by_r[-5:])):
                for p, (rr, n) in rows:
                    print(f"[sgg.evaluate]   {tag}: {vocab.token(p):<24} "
                          f"recall@{kmax} = {rr:.4f}  (n={n})", flush=True)
        write_json(partial=False)
    return records


if __name__ == "__main__":
    sys.exit(main())
