#!/usr/bin/env python3
"""The runs that exist only across cards, on four cards of one host, each
through the port's own entry points, one process per card over NCCL:

  python3 scripts/four_cards.py

(a) TP + FSDP: ``torchrun --nproc_per_node 4 -m sgg_torch.cli.train
    --config vit_b16 --set train.train_encoder=true --set mesh.model=2 --set
    mesh.fsdp=true``, data 2 x model 2, B 32 a rank, 3 steps, in
    ``chip_smoke.rank_run``'s ranks: 72/60/60 flash launches a step on each
    rank, every rank gathering the same global state (the checkpoint), and
    then the same for one step in float32 with n_critic 1 on the library
    routes, held
    against one process at the global batch on card 0
    (``chip_smoke.world_one_hold``, its bound in its docstring);
(b) data parallelism, ``--config v4_32`` at world 4 over NCCL (VGG-19 at
    224 px, bf16, B 128 a rank, n_critic 5) on a VG-shaped corpus of 1,024
    ids cycling the committed fixture, 3 steps: 96 ``conv_direct`` launches
    a step on each rank, the ranks' states equal bit for bit;
(c) ``python -m sgg_torch.cli.serve --workdir <(b)'s> --dp 4 --port 0``:
    its ready line, four binary requests of 32 images (each answered with
    32 type-legal graphs), exit 0 after SIGTERM;
(d) sequence parallelism over ``mesh.seq=4`` (``--set model.sp_mode=ring``
    and ``ulysses``, ``mesh.partition=gspmd``) on vit_b16 with
    ``train_encoder``, B 32, 2 steps each: the ring's 4 hops on S/4 = 49
    patch rows a rank (288/240/240 flash, dq and dk/dv launches a step on
    each rank), Ulysses on 3 heads a rank (72/60/60); every rank gathering
    the same global state (the checkpoint); each again for one step in
    float32 with n_critic 1, held against one process at the global batch
    on card 0 (``chip_smoke.world_one_hold``).
(e) pipeline parallelism on a frozen vit_b16 (``--set
    model.pp_microbatches=N --set mesh.partition=gspmd``), B 32, 2 steps
    each: over ``mesh.model=4`` (3 blocks a stage, 8 microbatches; 144 flash
    launches a step on each rank), and DP×SP×PP over ``mesh.seq=2`` x
    ``mesh.model=2`` with ``model.sp_mode=ring`` (6 blocks a stage, 4
    microbatches, 98 patch rows a rank; 288 a step on each rank, the ring's
    2 hops); every rank gathering the same global state (the checkpoint);
    each again for one float32 step at n_critic 1 against one process;
(f) expert parallelism over ``mesh.expert=4`` on vit_b16 with
    ``train_encoder`` and 8 experts, top-2 (2 experts a rank), B 32, 2
    steps: 72/60/60 a step on each rank, the same holds (the one process's
    MoE term the mean of the 4 shards' terms: ``chip_smoke.world_one_hold``).
Prints each run's s/step, images/s, the collectives' ms a step, state bytes
and peak memory per rank (for (d) the bytes saved for the backward in one
encoder forward against data parallelism's; for (e) and (f) the shifts' and
the all-to-alls' ms a step and the share of routing choices dropped), the
request latencies, and the cards' names and power limits; exits non-zero if
a hold fails, and with 2 if fewer than four cards are visible. ``--parts``
runs some of (a)-(f) (``--parts ef``: the last two). ``--dry-run`` runs the
same on the CPU (four gloo ranks, ``serve --dp 4`` over four CPU devices) at
small widths, the launch counts not held.
"""

import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STEPS, V4_IMAGES, REQUESTS, REQUEST_IMAGES, SP_STEPS, PP_EP_STEPS = 3, 1024, 4, 32, 2, 2
# --dry-run: small widths on the CPU.
DRY = {"model.hidden": 32, "model.embed_dim": 16, "model.attn_dim": 16, "model.noise_dim": 8,
       "model.critic_hidden": 32, "model.compute_dtype": "float32", "train.batch_size": 4,
       "train.n_critic": 2, "data.image_size": 64}
DRY_VIT = {**DRY, "data.regions": 16, "data.feat_dim": 64, "model.vit_dim": 64,
           "model.vit_layers": 2, "model.vit_heads": 4, "model.num_heads": 4,
           "model.num_layers": 2}
DRY_V4 = {**DRY, "data.regions": 16, "data.feat_dim": 512}
DRY_PP_EP = {**DRY_VIT, "model.vit_layers": 4, "train.batch_size": 8}  # 4 stages, 8 micro


def sp_cards(tmp, dry, sets, smi, out, bad):
    """(d): ring and Ulysses over ``mesh.seq=4`` on vit_b16 with
    ``train_encoder`` over NCCL, then each one's float32 step at n_critic 1
    against one process at the global batch."""
    import torch

    hops = {"ring": 4, "ulysses": 1}
    for mode, n_hops in hops.items():
        def argv(wd, steps, extra=()):
            return (["--config", "vit_b16", "--workdir", wd, "--steps", str(steps),
                     "--set", "train.train_encoder=true", "--set", f"model.sp_mode={mode}",
                     "--set", "mesh.seq=4", "--set", "mesh.partition=gspmd",
                     "--set", f"data.num_synthetic_images={cs.VIT_IMAGES}",
                     "--set", "train.log_every=1", *extra] + sets(DRY_VIT))

        wd, o_ = os.path.join(tmp, f"wd_{mode}"), os.path.join(tmp, f"out_{mode}")
        t0 = time.perf_counter()
        recs, _ = cs.dp_launch(o_, argv(wd, SP_STEPS), 4,
                               env_extra={"SGG_SMOKE_FIRST": "1", "SGG_SMOKE_ACT": "1"})
        lines = [r_ for r_ in cs.read_metric_lines(wd) if "d_loss" in r_]
        want = {"flash_attention": 72 * n_hops, "flash_attention_bwd_dq": 60 * n_hops,
                "flash_attention_bwd_dkv": 60 * n_hops}
        if not dry and any([{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                           != [want] * SP_STEPS for x_ in recs):
            bad.append(f"(d) {mode} launches {[x_['per_step'] for x_ in recs]}")
        sd = torch.load(os.path.join(wd, "checkpoints", str(SP_STEPS), "state.pt"),
                        map_location="cpu", weights_only=True)
        if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs) or \
                cs.digest(cs.tree_tensors(sd)) != recs[0]["global_digests"]:
            bad.append(f"(d) {mode}: the gathered states differ, or differ from the checkpoint")
        if any(x_["backend"] != ("gloo" if dry else "nccl") for x_ in recs):
            bad.append(f"(d) {mode} backends {[x_['backend'] for x_ in recs]}")
        wd_f, out_f = os.path.join(tmp, f"wd_{mode}_f"), os.path.join(tmp, f"out_{mode}_f")
        cs.dp_launch(out_f, argv(wd_f, 1, ("--set", "model.compute_dtype=float32",
                                           "--set", "model.use_pallas=false",
                                           "--set", "train.n_critic=1",
                                           "--set", "train.checkpoint_every=1")), 4,
                     env_extra={"SGG_SMOKE_FIRST": "1"})
        dev = torch.device("cpu" if dry else "cuda")
        ok, hold = cs.world_one_hold(dev, wd_f, out_f, 1, 4,
                                     ("g_params", "d_params", "enc_params"))
        if not ok:
            bad.append(f"(d) {mode} against one process: {hold['bad']}")
        out[f"sp_{mode}"] = {"s": time.perf_counter() - t0,
                             "s_per_step": 1 / lines[-1]["steps_per_sec"],
                             "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
                             "peak_gb": [x_["peak_gb"] for x_ in recs],
                             "saved_bytes": [x_["saved_bytes"] for x_ in recs],
                             "launches": recs[0]["per_step"][-1], "hold": hold}
        print(f"[four_cards] (d) {mode} over mesh.seq=4, vit_b16 train_encoder, "
              f"{'gloo' if dry else 'NCCL'}: {json.dumps(out[f'sp_{mode}'])} [{smi}]", flush=True)


def pp_ep_cards(tmp, dry, sets, smi, out, bad, parts="ef"):
    """(e) and (f): the pipeline over ``mesh.model=4`` (3 blocks a stage, 8
    microbatches) and DP×SP×PP over ``mesh.seq=2`` x ``mesh.model=2`` (the
    ring inside the stages, 4 microbatches), both on a frozen vit_b16, and
    expert parallelism over ``mesh.expert=4`` (8 experts, 2 a rank) on
    vit_b16 with ``train_encoder``, over NCCL; each then for one float32
    step at n_critic 1 against one process at the global batch. ``parts``:
    'e', 'f' or both."""
    import torch

    nc = int(DRY_PP_EP["train.n_critic"]) if dry else 5
    layers = int(DRY_PP_EP["model.vit_layers"]) if dry else 12
    runs = {
        "pp": ("(e) PP over mesh.model=4, 8 microbatches",
               {"mesh.model": 4, "model.pp_microbatches": 8}, ("g_params", "d_params"),
               {"flash_attention": (nc + 1) * (layers // 4) * 8}),
        "dp_sp_pp": ("(e) DP×SP×PP, ring over mesh.seq=2, PP over mesh.model=2, 4 microbatches",
                     {"mesh.seq": 2, "mesh.model": 2, "model.sp_mode": "ring",
                      "model.pp_microbatches": 4}, ("g_params", "d_params"),
                     {"flash_attention": (nc + 1) * (layers // 2) * 4 * 2}),
        "ep": ("(f) EP over mesh.expert=4, 8 experts (2 a rank), train_encoder",
               {"mesh.expert": 4, "model.moe_experts": 8, "model.moe_top_k": 2,
                "train.train_encoder": "true"}, ("g_params", "d_params", "enc_params"),
               {"flash_attention": (nc + 1) * layers, "flash_attention_bwd_dq": nc * layers,
                "flash_attention_bwd_dkv": nc * layers}),
    }
    for key, (label, run_sets, trained, want) in runs.items():
        if ("f" if key == "ep" else "e") not in parts:
            continue

        def argv(wd, steps, extra=()):
            a_ = ["--config", "vit_b16", "--workdir", wd, "--steps", str(steps),
                  "--set", "mesh.partition=gspmd",
                  "--set", f"data.num_synthetic_images={cs.VIT_IMAGES}",
                  "--set", "train.log_every=1", *extra]
            for k_, v_ in run_sets.items():
                a_ += ["--set", f"{k_}={v_}"]
            return a_ + sets(DRY_PP_EP)

        wd, o_ = os.path.join(tmp, f"wd_{key}"), os.path.join(tmp, f"out_{key}")
        t0 = time.perf_counter()
        recs, text = cs.dp_launch(o_, argv(wd, PP_EP_STEPS), 4,
                                  env_extra={"SGG_SMOKE_FIRST": "1", "SGG_SMOKE_MOE": "1"})
        lines = [r_ for r_ in cs.read_metric_lines(wd) if "d_loss" in r_]
        if not dry and any([{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                           != [want] * PP_EP_STEPS for x_ in recs):
            bad.append(f"{label} launches {[x_['per_step'] for x_ in recs]}")
        sd = torch.load(os.path.join(wd, "checkpoints", str(PP_EP_STEPS), "state.pt"),
                        map_location="cpu", weights_only=True)
        if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs) or \
                cs.digest(cs.tree_tensors(sd)) != recs[0]["global_digests"]:
            bad.append(f"{label}: the gathered states differ, or differ from the checkpoint")
        if any(x_["backend"] != ("gloo" if dry else "nccl") for x_ in recs):
            bad.append(f"{label} backends {[x_['backend'] for x_ in recs]}")
        whole = re.findall(r"state bytes on this rank: ([\d,]+) \(data parallel: ([\d,]+)\)",
                           text)
        wd_f, out_f = os.path.join(tmp, f"wd_{key}_f"), os.path.join(tmp, f"out_{key}_f")
        cs.dp_launch(out_f, argv(wd_f, 1, ("--set", "model.compute_dtype=float32",
                                           "--set", "model.use_pallas=false",
                                           "--set", "train.n_critic=1",
                                           "--set", "train.checkpoint_every=1")), 4,
                     env_extra={"SGG_SMOKE_FIRST": "1"})
        dev = torch.device("cpu" if dry else "cuda")
        ok, hold = cs.world_one_hold(dev, wd_f, out_f, 1, 4, trained,
                                     moe_shards=4 if key == "ep" else 1)
        if not ok:
            bad.append(f"{label} against one process: {hold['bad']}")

        def by(names):  # each rank's mean ms a step after the first
            return [round(sum(sum(c_.get(n_, 0.0) for n_ in names) for c_ in x_["coll_by"][1:])
                          / max(len(x_["coll_by"]) - 1, 1), 3) for x_ in recs]

        out[key] = {"s": time.perf_counter() - t0, "s_per_step": 1 / lines[-1]["steps_per_sec"],
                    "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
                    "shift_ms": by(("shift_tensors", "broadcast_tensor")),
                    "a2a_ms": by(("all_to_all_tensor",)),
                    "peak_gb": [x_["peak_gb"] for x_ in recs],
                    "state_bytes": [x_["state_bytes"] for x_ in recs],
                    "dp_bytes": int(whole[0][1].replace(",", "")),
                    "dropped": [x_.get("moe_dropped") for x_ in recs],
                    "launches": recs[0]["per_step"][-1], "hold": hold}
        print(f"[four_cards] {label}, vit_b16, {'gloo' if dry else 'NCCL'}: "
              f"{json.dumps(out[key])} [{smi}]", flush=True)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dry-run", action="store_true",
                    help="on the CPU at small widths (four gloo ranks)")
    ap.add_argument("--parts", default="abcdef",
                    help="the parts to run, of abcdef (default all; (c) goes with (b))")
    args = ap.parse_args(argv)
    dry, parts = args.dry_run, set(args.parts)
    if not parts <= set("abcdef") or ("c" in parts and "b" not in parts):
        ap.error("--parts takes letters of abcdef, and (c) needs (b)")
    if not dry and (not torch.cuda.is_available() or torch.cuda.device_count() < 4):
        print("four_cards: needs four CUDA devices", file=sys.stderr)
        return 2

    def sets(extra):
        a_ = []
        for k_, v_ in (extra if dry else {}).items():
            a_ += ["--set", f"{k_}={v_}"]
        return a_ + (["--device", "cpu"] if dry else [])

    size = DRY["data.image_size"] if dry else 224
    smi = ("cpu dry run" if dry else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().replace("\n", "; "))
    print(smi, flush=True)
    out = {}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        if "a" in parts:
            # (a) TP + FSDP over NCCL.
            def vit_argv(wd, steps, extra=()):
                return (["--config", "vit_b16", "--workdir", wd, "--steps", str(steps),
                         "--set", "train.train_encoder=true", "--set", "mesh.model=2",
                         "--set", "mesh.fsdp=true",
                         "--set", f"data.num_synthetic_images={cs.VIT_IMAGES}",
                         "--set", "train.log_every=1", "--set", "train.checkpoint_every=1",
                         *extra] + sets(DRY_VIT))

            wd_a, out_a = os.path.join(tmp, "wd_a"), os.path.join(tmp, "out_a")
            argv_a = vit_argv(wd_a, STEPS)
            t0 = time.perf_counter()
            recs, text = cs.dp_launch(out_a, argv_a, 4, env_extra={"SGG_SMOKE_FIRST": "1"})
            lines = [r_ for r_ in cs.read_metric_lines(wd_a) if "d_loss" in r_]
            want = {"flash_attention": 72, "flash_attention_bwd_dq": 60,
                    "flash_attention_bwd_dkv": 60}
            if not dry and any([{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                               != [want] * STEPS for x_ in recs):
                bad.append(f"(a) launches {[x_['per_step'] for x_ in recs]}")
            if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs):
                bad.append("(a) the ranks gathered different global states")
            sd = torch.load(os.path.join(wd_a, "checkpoints", str(STEPS), "state.pt"),
                            map_location="cpu", weights_only=True)
            if cs.digest(cs.tree_tensors(sd)) != recs[0]["global_digests"]:
                bad.append("(a) the checkpoint is not the gathered global state")
            if any(x_["backend"] != ("gloo" if dry else "nccl") for x_ in recs):
                bad.append(f"(a) backends {[x_['backend'] for x_ in recs]}")
            # Its first step again in float32 (library routes), against one
            # process at the global batch on card 0.
            wd_f, out_f = os.path.join(tmp, "wd_f"), os.path.join(tmp, "out_f")
            cs.dp_launch(out_f, vit_argv(wd_f, 1, ("--set", "model.compute_dtype=float32",
                                                   "--set", "model.use_pallas=false",
                                                   "--set", "train.n_critic=1")), 4,
                         env_extra={"SGG_SMOKE_FIRST": "1"})
            dev = torch.device("cpu" if dry else "cuda")
            ok_c, hold = cs.world_one_hold(dev, wd_f, out_f, 2, 2,
                                           ("g_params", "d_params", "enc_params"))
            if not ok_c:
                bad.append(f"(a) against one process: {hold['bad']}")
            out["tp_fsdp"] = {"s": time.perf_counter() - t0,
                              "s_per_step": 1 / lines[-1]["steps_per_sec"],
                              "images_per_s": lines[-1]["images_per_sec"],
                              "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
                              "state_bytes": [x_["state_bytes"] for x_ in recs],
                              "peak_gb": [x_["peak_gb"] for x_ in recs],
                              "hold": hold}
            print(f"[four_cards] (a) TP+FSDP vit_b16 train_encoder, data 2 x model 2 over NCCL: "
                  f"{json.dumps(out['tp_fsdp'])} [{smi}]", flush=True)

        if "b" in parts:
            # (b) v4_32 at world 4 over NCCL.
            vg_dir = os.path.join(tmp, "vg")
            cs.vg_corpus(vg_dir, V4_IMAGES)
            wd_b, out_b = os.path.join(tmp, "wd_b"), os.path.join(tmp, "out_b")
            argv_b = ["--config", "v4_32", "--workdir", wd_b, "--steps", str(STEPS),
                      "--set", f"data.data_dir={vg_dir}", "--set", "train.log_every=1"]
            argv_b += sets(DRY_V4)
            t0 = time.perf_counter()
            recs, text = cs.dp_launch(out_b, argv_b, 4)
            lines = [r_ for r_ in cs.read_metric_lines(wd_b) if "d_loss" in r_]
            ok_b, bad_b = cs.dp_holds(recs, None, None if dry else {"conv_direct": 96})
            if not ok_b:
                bad.append(f"(b) {bad_b}")
            if any(x_["backend"] != ("gloo" if dry else "nccl") for x_ in recs):
                bad.append(f"(b) backends {[x_['backend'] for x_ in recs]}")
            out["v4_32"] = {"s": time.perf_counter() - t0,
                            "s_per_step": 1 / lines[-1]["steps_per_sec"],
                            "images_per_s": lines[-1]["images_per_sec"],
                            "allreduce_ms_step": [x_["allreduce_ms_step"] for x_ in recs],
                            "peak_gb": [x_["peak_gb"] for x_ in recs]}
            print(f"[four_cards] (b) v4_32 over 4 ranks, NCCL: {json.dumps(out['v4_32'])} [{smi}]",
                  flush=True)

        if "c" in parts:
            # (c) serve --dp 4 on (b)'s workdir.
            from sgg_torch.serve import encode_binary_request
            from sgg_torch.train.checkpoint import load_workdir

            _, vocab = load_workdir(wd_b)
            log_path = os.path.join(tmp, "serve.log")
            argv_c = ["timeout", "-k", "5", str(cs.CLI_BOUND_S), sys.executable, "-m",
                      "sgg_torch.cli.serve", "--workdir", wd_b, "--dp", "4", "--port", "0",
                      "--batch-size", str(REQUEST_IMAGES)] + (["--device", "cpu"] if dry else [])
            t0 = time.perf_counter()
            with open(log_path, "w") as f:
                proc = subprocess.Popen(argv_c, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                        start_new_session=True)
            try:
                deadline, url = time.monotonic() + cs.CLI_READY_S, None
                while url is None and time.monotonic() < deadline and proc.poll() is None:
                    time.sleep(0.2)
                    with open(log_path) as f:
                        ready = [ln for ln in f if "ready on http://" in ln]
                    if ready:
                        url = ready[0].split("ready on ")[1].split()[0]
                ready_s = time.perf_counter() - t0
                if url is None:
                    with open(log_path) as f:
                        raise AssertionError(f"serve --dp 4 printed no ready line:\n{f.read()}")
                rs = np.random.RandomState(0)
                latencies = []
                for _ in range(REQUESTS):
                    im = rs.randint(0, 256, (REQUEST_IMAGES, size, size, 3), dtype=np.uint8)
                    t_r = time.perf_counter()
                    status, resp = cs.http(url + "/v1/generate", encode_binary_request(im),
                                           "application/octet-stream")
                    latencies.append(time.perf_counter() - t_r)
                    if status != 200 or len(resp["scene_graphs"]) != REQUEST_IMAGES:
                        raise AssertionError(f"serve --dp 4: status {status} {resp}")
                    cs.legal_graphs(resp["scene_graphs"], vocab, 50, "serve --dp 4")
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=cs.CLI_EXIT_S)
                with open(log_path) as f:
                    printed = f.read()
                if rc != 0:
                    bad.append(f"(c) serve exited {rc}:\n{printed[-2000:]}")
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)
            out["serve"] = {"ready_s": ready_s, "latency_s": latencies,
                            "images_per_s": REQUEST_IMAGES * len(latencies) / sum(latencies),
                            "printed": [ln for ln in printed.splitlines()
                                        if "[sgg.serve]" in ln][:3]}
            print(f"[four_cards] (c) serve --dp 4: {json.dumps(out['serve'])} [{smi}]", flush=True)

        if "d" in parts:
            # (d) ring and Ulysses over mesh.seq=4.
            sp_cards(tmp, dry, sets, smi, out, bad)
        # (e) and (f): pipeline and expert parallelism.
        if parts & {"e", "f"}:
            pp_ep_cards(tmp, dry, sets, smi, out, bad, parts)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "four_cards.json"), "w") as f:
        json.dump({"smi": smi, **out, "bad": bad}, f, indent=1)
    print(f"[four_cards] holds: {'ok' if not bad else 'FAILED: ' + '; '.join(bad)}", flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
