"""``serve`` entry point, from ``sgg/cli/serve.py``: a dynamic-batching
scene-graph inference server over a trained port workdir, or over an exported
sampler (``--artifact``, ``sgg_torch.cli.export``; no workdir or model code).

  python -m sgg_torch.cli.serve --workdir /runs/v4 --ema --avg-last 5 --port 8500
  python -m sgg_torch.cli.serve --artifact model.pt2 --port 8500

  curl -s localhost:8500/healthz
  curl -s -X POST localhost:8500/v1/generate \\
      -d '{"features": [[[0.1, ...], ...]]}'

Restores the weights and drives one padded batch through the sampler (and
the encoder, with its kernels, on pixels-in configs) before it binds the
port, then serves until SIGTERM or SIGINT, which drain the server and shut it
down (exit code 0). ``--port 0`` binds a free port; the ready line names the
address bound. It runs on CUDA unless ``--device cpu`` is given, and raises if
CUDA is not there. ``--quant int8`` serves the encoder's int8 PTQ (pixels-in
workdirs; a precomputed-feature workdir refuses it). An artifact bakes its
weights, sampling and quantization, so ``--artifact`` refuses ``--rank
freq_logp/logp``, ``--top-k``/``--top-p``, ``--ema``/``--avg-last`` and
``--quant`` (exit code 2). ``--dp N`` splits each batch's rows over N devices
(``make_dp_sampler``; the batch must divide): ``cuda:0`` to ``cuda:N-1``, which
must be visible (else exit code 2), or with ``--device cpu`` N CPU devices;
``--artifact`` refuses it (an artifact is one device's program).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import torch

from sgg_torch.cli.common import add_device_arg, resolve_device


def _refusal(args) -> str | None:
    if bool(args.workdir) == bool(args.artifact):
        return "pass exactly one of --workdir / --artifact"
    if args.artifact:
        if args.dp:
            return "--dp needs --workdir (an artifact is a single-device program)"
        if args.rank not in (None, "freq"):
            return ("--rank freq_logp/logp needs --workdir (exported programs emit tokens, "
                    "not log-probs)")
        if args.top_k or args.top_p is not None:
            return "--top-k/--top-p need --workdir (exported programs bake their sampling)"
        if args.ema or args.avg_last:
            return ("--ema/--avg-last need --workdir (artifacts bake their weights at export; "
                    "re-export with sgg_torch.cli.export --ema/--avg-last instead)")
        if args.quant is not None:
            return ("--quant needs --workdir (an artifact bakes its encoder's quantization; "
                    "re-export with sgg_torch.cli.export --quant)")
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None, help="trained run directory")
    p.add_argument("--artifact", default=None,
                   help="serve an exported sampler (sgg_torch.cli.export) instead of a "
                        "workdir: no checkpoint or model code needed; batch, samples, "
                        "temperature and the encoder are baked into it")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500, help="0 binds a free port")
    p.add_argument("--batch-size", type=int, default=32,
                   help="device batch; requests pad/coalesce to it (an artifact's own "
                        "batch wins unless it was exported with a symbolic batch)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max batching delay after the first queued item")
    p.add_argument("--num-samples", type=int, default=50,
                   help="noise draws per image")
    p.add_argument("--temperature", type=float, default=None,
                   help="sampling temperature: tokens ~ softmax(logits / T) "
                        "(default 1.0)")
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: keep the smallest token set with "
                        "cumulative probability >= p per decode step")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling: keep only the k most likely tokens "
                        "per decode step (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", type=int, default=0,
                   help="split each batch over this many devices (0 = one device; "
                        "batch-size must divide): cuda:0..N-1, or N CPU devices with "
                        "--device cpu")
    p.add_argument("--quant", default=None, choices=["none", "int8"],
                   help="the encoder's PTQ mode (overrides cfg.model.quant): int8 sums "
                        "s8 x s8 products into int32 (torch._int_mm on the card)")
    p.add_argument("--avg-last", type=int, default=0, metavar="N",
                   help="serve the mean of the last N retained checkpoints' "
                        "generator weights; composes with --ema")
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA generator weights (requires a run "
                        "trained with train.ema_decay > 0)")
    p.add_argument("--rank", default=None,
                   choices=["freq", "freq_logp", "logp"],
                   help="triple order in responses: sample frequency, "
                        "log-prob tiebreak, or probability mass "
                        "(sgg_torch.eval.sampler.rank_triples); default logp with "
                        "--workdir, freq with --artifact")
    add_device_arg(p)
    args = p.parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        print(f"[sgg.serve] {refusal}", file=sys.stderr)
        return 2
    if args.rank is None:
        args.rank = "freq" if args.artifact else "logp"
    device = resolve_device(args.device)

    from sgg_torch.serve import ArtifactEngine, DynamicBatcher, InferenceEngine, make_http_server

    where = device
    if args.artifact:
        engine = ArtifactEngine(args.artifact, device=device, seed=args.seed,
                                batch_size=args.batch_size)
    else:
        mesh = None
        if args.dp:
            from sgg_torch.dist import MeshSpec, make_mesh

            cards = torch.cuda.device_count() if device.type == "cuda" else args.dp
            if cards < args.dp:
                print(f"[sgg.serve] --dp {args.dp} needs {args.dp} CUDA devices; {cards} "
                      "visible", file=sys.stderr)
                return 2
            mesh = make_mesh(MeshSpec(data=args.dp), devices=[
                torch.device("cuda", i) if device.type == "cuda" else device
                for i in range(args.dp)])
            where = f"{args.dp} x {device.type}"
        try:
            engine = InferenceEngine.from_workdir(
                args.workdir, device=device, batch_size=args.batch_size,
                num_samples=args.num_samples, temperature=args.temperature,
                seed=args.seed, quant=args.quant, ema=args.ema, rank=args.rank,
                top_k=args.top_k or 0, top_p=args.top_p, avg_last=args.avg_last, mesh=mesh,
            )
        except ValueError as e:  # a workdir that refuses these options
            print(f"[sgg.serve] {e}", file=sys.stderr)
            return 2
    print(f"[sgg.serve] restored step {engine.step}; warming up batch "
          f"{engine.batch_size} x {engine.feature_shape} on {where}…", flush=True)
    dt = engine.warmup()
    batcher = DynamicBatcher(engine, max_wait_ms=args.max_wait_ms)
    try:
        server = make_http_server(batcher, host=args.host, port=args.port)

        def _term(signum, frame):
            print(f"[sgg.serve] signal {signum}: draining and shutting down",
                  flush=True)
            threading.Thread(target=server.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _term)
        signal.signal(signal.SIGINT, _term)
        host, port = server.server_address[:2]
        print(f"[sgg.serve] ready on http://{host}:{port} (warmup {dt:.1f}s)", flush=True)
        try:
            server.serve_forever()
        finally:
            # In-flight requests finish (their handler threads are joined)
            # while the batcher still runs; then the batcher stops.
            server.server_close()
    finally:
        batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
