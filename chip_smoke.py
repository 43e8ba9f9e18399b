#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``sgg_torch``) on one NVIDIA H100.

  python3 chip_smoke.py
  python3 chip_smoke.py --phases 29        (or 21,22,24,25,26,27,28,29: those phases alone)

With no argument every phase runs: phases 1-16 (the holds and the timed
kernels) alone on the card, then phases 17-20 and 23 in this process beside
two others (``side_start``: this script with ``--phases 27,22,26,24`` and
with ``--phases 21,25,28,29``), each started in a session of its own, ended with
this one (``side_stop``) and read at the end (``side_finish``: its output
echoed, its summary lines and launches taken into the last lines). Each of
those phases leaves the card idle most of the time, so the three share it;
the times they print are taken beside each other, their times alone come
from ``--phases``. ``--phases`` runs the device check, the build and then each
phase named (one of those that build their own inputs), and ends with the
device line naming them, or with ``--results`` writes their summary lines
and launches to a JSON file instead. Phases 1-17 open no socket, and their only threads are
the train CLI's stall watchdog and phase 17's upload thread, each stopped and
joined when its run ends; phase 18 opens an
HTTP server on 127.0.0.1 with its handler threads, a batcher's worker thread,
client threads and one subprocess, and closes each in a ``finally``: the
server is shut down and closed (which joins its handler threads), the batcher
closed (which joins its worker), the client threads joined with a timeout, the
subprocess's process group killed if it has not exited; the phase fails if a
thread of it is alive at its end. Phase 19 opens no socket and starts no
process; its training runs stop their data threads as phase 17's does. Phase
22 opens no socket and starts no process; its pretraining and extraction
runs stop their watchdog threads when each returns. Phase 23 opens two HTTP
servers on 127.0.0.1 (each closed with its batcher by ``served``) and starts
one subprocess under a timeout, which it waits for:
  1. device: CUDA present, compute capability 9.0; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: nvcc compiles ``sgg_torch/kernels/csrc/*.cu`` for sm_90a, one
     process per source, all at once; wall time and the compilers' CPU time
     (about what one process after another would take), and ptxas's
     registers and spills for each kernel;
  3. fused_decode vs plain: ``fused_decode`` against ``decode_plain`` at the
     trained run's widths (V from its vocab.json, R=196, F=512, H=512, E=256,
     A=256, Z=128), seeded weights, the real step mask, B = 64 and B = 37, and
     at the resnet50 widths (R=49, F=2048, V=8192, B = 32), float32 and
     bfloat16: soft, every (row, step) within 1e-4 (f32) or 1e-2 (bf16) of
     that row's largest value, and at vg1k widths at most 0.5 % of the bf16
     y differing from plain at all; hard, tokens identical for >= 99.9 %
     (f32) or >= 99 % (bf16) of 8 draws; the bf16 cases run the batched
     instance, float32 the generic one; and the generic instance's 16-row
     tile at vg1k widths, B = 64, under the same 0.5 % share gate; then the
     batched instance exactly, at vg1k widths (B = 64) and resnet50 widths
     (B = 64): an exact tie (wv's and bv's column n2 copied from n1 < n2,
     in items that different blocks take, the Gumbel noise copied, no mask)
     where kernel and plain must pick n1 in every row and step, two
     launches bit for bit, and B = 37 bit for bit rows 0-36 of B = 64;
  4. fused_matmul vs plain at every ResNet-50 1x1-conv shape of the pixels-in
     path (B = 32 at 224 px), at VGG-19's first im2col shape and at five
     ragged shapes (M not a multiple of the tile, K = 16 and 80, N = 8 and
     72; the last with a inside seeded guard rows, so its last M tile
     straddles a's end), bfloat16 with and without ReLU and float32, each
     with the instance, tile and block count that ``matmul.plan`` gives and
     the share of outputs that differ from plain at all; conv_direct vs
     plain at the four ResNet-50 3x3 stride-1 shapes, two VGG-19 shapes and
     four shapes that put an image boundary and the SAME halo inside one
     tile with ragged M and Cout ([3,7,7,512]->512, [2,9,13,64]->72,
     [1,5,5,32]->16 at 3x3 and [2,14,14,64]->64 at 5x5), float32 and
     bfloat16, each with the instance, tile and block count that
     ``conv_direct.plan`` gives and the share of outputs that differ from
     plain at all;
  5. encoders vs plain: ResNet-50 (seeded weights, random BN statistics) and
     VGG-19 (under 'direct' and under 'pallas') on 8 seeded 224 px images,
     the kernel routes against the library route ('xla'): float32 within
     1e-4; bfloat16 no further from the float32 result than the bf16
     library route is (rel L2 within 1.5x, max within 3x), and against the
     bf16 library route: ResNet-50 block by block (each block fed the
     library route's input; at most 1 % of elements differ, rel L2 within
     1e-3), VGG-19 end to end (within 2e-2 x max, rel L2 within 1.5e-2);
  6. main path, precomputed features: ``python -m sgg_torch.cli.generate
     --decode fused`` (in process) on a port workdir with the trained run's
     config.json and vocab.json, seeded generator weights and 512 seeded feature images,
     K = 50 draws, batch 64; fused_decode must launch exactly
     ceil(512/64) * 50 times; the output JSON is read back and checked; one
     batch of the CUDA sampler is held against the same sampler on the CPU
     (plain version) given the same noise;
  7. main path, pixels in: the same CLI (``--decode fused``) on a
     ``resnet50``-config workdir
     (seeded 8192-entry vocab, seeded generator and encoder weights) over 256
     synthetic 224 px images, batch 32, K = 50: conv_direct, fused_matmul and
     fused_decode must launch exactly 8 * 13, 8 * 36 and 8 * 50 times;
     images/s and triples/s; the output JSON is read back and checked;
  8. timing: ms per launch (CUDA events, warm, in turns plain, kernel,
     kernel, plain) of each kernel at every shape of phases 3-4 that the main
     paths use, beside its plain version, the library call that computes the
     same product (torch.matmul, or F.conv2d on channels-last bf16; both
     without the epilogue) and the bound: max(bytes over 3.35 TB/s, FLOPs over
     the type's peak; fused_decode's in hard mode, whose feedback reads the
     chosen rows of emb, with the soft-mode bound printed beside it);
     fused_decode also on the device's clock (its cooperative launch
     captured in a CUDA graph), its generic instance on the same inputs,
     its per-phase split (the timed check-only entry: block 0's
     %globaltimer at every grid barrier) and its wrapper's host us per call
     at a tiny width against a limit of 60;
     fused_matmul and conv_direct also on the device's
     clock (each call captured in a CUDA graph, so the wrapper's host cost
     drops out), with torch.matmul or F.conv2d and the generic instance (the
     tile core the two share, each kernel's earlier design) on the same bf16
     inputs, printed apart from the record, launch-weighted, and each
     wrapper's host cost per call; and the ResNet-50 encoder on one batch of
     phase 7 (B = 32) on the kernel route against the library route, and in
     ten pairs against itself with its 3x3 convs, then its 1x1 convs, on the
     generic instance, eager and in one CUDA graph;
  9. flash_attention vs plain at [32, 12, 196, 64] (ViT-B/16 at 224 px),
     [32, 12, 576, 64] (384 px) and a ragged S = 100, float32 and bfloat16,
     with and without lse: float32 within 1e-4 x max; bf16 within one bf16
     ulp of plain plus that, and at most 1 % of the outputs differing at all
     (the share is printed); lse within 1e-5 relative; and for bf16 the
     kernel's float32 result before its cast (acc / l, from the check-only
     entry) against the plain version in float32 from the same inputs: a
     relative L2 distance within ``flash_attention.F32_RESULT_TOL``, while
     p's split cut to hi + mid (plain, emulated) must land above it; both
     margins printed;
 10. ViT-B/16 encoder (seeded weights) on 8 seeded 224 px images, the kernel
     route (use_pallas) against the plain route (attention by
     ``flash_attention_plain``): float32 within 1e-4 x max; bfloat16 block
     by block, each block fed the plain route's input (at most 7 % of a
     block's elements differ, rel L2 within 2e-3);
 11. main path, ``vit_b16``: the CLI (``--decode xla``) on a
     ``vit_b16``-config workdir (seeded 1024-entry vocab, seeded generator
     and encoder weights) over 256 synthetic 224 px images, batch 32,
     K = 50: flash_attention must launch exactly 8 * 12 times and the other
     kernels not at all; images/s and triples/s; the output JSON is read
     back and checked; one batch of the CUDA sampler against the CPU
     sampler (plain versions) given the same features and noise;
 12. timing: flash_attention per launch at both ViT shapes beside its plain
     version, ``F.scaled_dot_product_attention`` on the same bf16 tensors
     (timed only; the port never calls it) and the bound; the ViT-B/16
     encoder on one batch of 32 on the kernel route against the plain route;
 13. flash backward vs plain (the dq and dk/dv kernels) at the shapes of
     phase 9, float32 and bfloat16: dq, dk and dv in float32 within
     1e-4 x max; bf16 within one bf16 ulp of plain plus that, and at most 1 %
     of the outputs differing at all (the share is printed);
     ``torch.autograd.grad`` through ``flash_attention`` gives the kernels'
     own result; a seeded fault, the plain backward with p and ds rounded
     to bf16 before the three products that take them, must fail the gate;
     and for bf16 the kernels' float32 dq, dk, dv before the cast within
     ``flash_attention.F32_RESULT_TOL`` (relative L2) of plain in float32,
     with p and ds split cut to hi + mid (plain, emulated) above it;
 14. ViT-B/16 gradients (seeded weights, 8 seeded 224 px images, a fixed
     linear loss), the kernel route against the plain route: every
     parameter's gradient in float32 within 1e-4 x its max; in bfloat16 no
     further from the float32 plain gradients than the bf16 plain route is
     (worst parameter's rel L2 and the rel L2 over all parameters, each
     within 1.5x); exactly 12 launches of each of the three flash kernels;
 15. main path, training: ``python -m sgg_torch.cli.train --config vit_b16
     --set train.train_encoder=true --profile`` (in process) at the config's
     widths, batch 32, n_critic 5, over 256 seeded synthetic 224 px images, 16
     steps: exactly 72 flash_attention, 60 dq and 60 dk/dv launches per step
     and no other kernel; finite losses; every encoder tensor moved;
     metrics.jsonl and the checkpoint read back; s/step, images/s and peak
     device memory; then ``sgg_torch.cli.generate`` on that workdir (K = 4)
     with its output read back; one step at V = 1024 through the same entry
     points (state, step, device iterator) with a seeded 1024-entry vocab and
     the same launch counts; and ``--config vg1k`` for 3 steps with no kernel
     launch; the profiled window's regions (``read_regions``: each region's
     calls, host ms and device ms, ``critic_update`` and ``encoder`` 5 a
     step, ``generator_update`` 1) with every flash dq and dk/dv launch of the
     window inside ``critic_update``, attributed by its launch;
 16. timing: the dq and the dk/dv kernels at [32, 12, 196, 64] bf16 beside
     their plain versions, the backward of ``scaled_dot_product_attention``
     (``torch.autograd.grad`` of its output; timed only) and the bound, with
     the float32 CUDA-core floor of the products that take p or ds as a
     reference line (the products now run on the tensor cores);
 17. main path, ``pipeline_v4`` (``pipeline_v4_phase``): a seeded corpus with
     the trained run's vocab (V = 210), 8,192 train and 512 test images of
     196 x 512 float16 features (VG's 108,077 cut), predicates on a long
     tail; ``python -m sgg_torch.cli.train --config pipeline_v4 --profile``
     (in process) at its full widths (B = 256, grad_accum 2, n_critic 5,
     bf16) for 16 steps with the device budget cut by the corpus's factor
     (303 MB: 6 rotating int8 subsets), ``rotation_min_steps`` 2, a probe
     every 8 steps and a checkpoint every 2: finite losses, no kernel
     launch, at least one full rotation cycle, two probes, the kept
     checkpoints; s/step, images/s, peak device memory, the subsets' upload
     seconds and swaps, the probes' recall and seconds, the profile's top
     device ops, idle share and regions (``sample_fakes_batched`` and
     ``generator_update`` once a step, ``critic_update`` 5 times), what
     ``annotate`` costs the host a region with no profiler open; the
     gather's holds on the card
     (``gather_holds``: the batch equal to the CPU's and to the reference's
     formula in numpy, bit for bit, with ties on the CDF's steps; every
     dequantized value within half its region's scale plus one float16 ulp;
     draws moved toward the rarer predicates); ``sgg_torch.cli.evaluate
     --ema --avg-last 5 --rank logp --k 20,50,100 --zero-shot
     --per-predicate`` (no kernel launch) and ``--decode fused --rank freq``
     (exactly 8 x 100 fused_decode launches), each one's recall grid, wall
     seconds and triples/s; one batch of the sampler with log-probabilities
     on the card against the CPU's, same noise.
 18. serving (``serve_phase``), on phase 17's workdir before it is removed:
     (a) ``sgg_torch.serve.InferenceEngine.from_workdir(W, ema=True,
     avg_last=5, rank='logp', batch_size=32, num_samples=50)``, warmed up,
     behind a ``DynamicBatcher`` and ``make_http_server`` on a free port: 8
     client threads send 4 binary float16 and then 4 JSON requests each (1-6
     images, a few JSON ones at temperature 0.5), every urllib call with a
     60 s timeout; each request gets its graphs, every triple type-legal;
     ``/stats`` counts the requests and images sent and fewer batches than
     images, and ``/metrics`` agrees with it; a wrong shape and a ``paths``
     request get 400; requests/s, images/s and triples/s for each wire
     format, batch latency p50/p95/p99 and average fill; and one padded batch
     (20 rows of 32, K = 8) of a card engine against a CPU engine on the same
     weights and noise (>= 99 % of draws identical, log_prob finite);
     (b) a resnet50 workdir (phase 7's widths, seeded weights) on binary
     uint8 requests of 1-32 images from 3 client threads: exactly 13
     conv_direct and 36 fused_matmul launches per encoder chunk (warmup's
     included), no fused_decode; images/s through HTTP; the served features
     of a 32-image request equal ``make_batch_features``' bit for bit;
     (c) a vit_b16 workdir, one request of 32 images: exactly 12
     flash_attention launches and no other kernel;
     (d) ``python -m sgg_torch.cli.serve --workdir W --ema --avg-last 5
     --port 0`` in a subprocess with its own process group: its ready line
     within 180 s, ``/healthz`` and one binary request answered, exit code 0
     within 30 s of SIGTERM.
 19. the main path's last options: (a) and (b) on phase 17's workdir and
     corpus, after phase 18 and before they are removed
     (``v4_predcls_reinforce_phase``): (a) ``sgg_torch.cli.evaluate --ema
     --avg-last 5 --predcls --predcls-samples 16`` at B = 64 (P-R@k, wall
     seconds, rows/s, every held-out GT triple scored, no kernel launch) and
     one chunk of the float32 PredCls scorer on the card against the CPU's
     (same weights and z: scores within 1e-4 x max|score| over the legal
     predicates, the same GT rank on every row); (b) ``train --set
     train.estimator=reinforce --set train.rl_entropy=0.01`` with phase 17's
     config (B = 256, grad_accum 2, n_critic 5, bf16) for 4 steps (finite
     losses, the ``rl_*`` keys in metrics.jsonl, no kernel launch, s/step
     beside phase 17's Gumbel s/step) and one generator update's surrogate
     gradient in float32, card against CPU (128 rows of the corpus, same
     weights and noise: the same tokens, each tensor within 1e-4 x its
     max|CPU| plus 1e-6 x the largest); (c) ``train --config vit_b16 --set
     train.train_encoder=true --set train.estimator=reinforce`` for 3 steps:
     exactly 72 flash_attention, 60 dq and 60 dk/dv launches per step, as
     the step's structure gives them (the comment at the phase); (d)
     ``synthetic_vg_json(2048, vocab_objects=300, vocab_predicates=80,
     max_rels=20)`` through ``sgg_torch.cli.preprocess --encoder random
     --max-objects 150 --max-predicates 50 --regions 196 --feat-dim 512
     --feat-dtype float16`` (about 0.4 GB of shards) and 2 steps of ``train
     --config pipeline_v4`` on them (``preprocess_phase``: the vocab sizes,
     the split, finite losses). Each part's directories go in a
     ``finally``.
 20. ``train.steps_per_dispatch`` (``fused_dispatch_phase``, from phase 17's
     hook after phase 19 (a) and (b), on its corpus of 8,192 images with a
     device budget of 2 GB, so the whole int8 store (0.82 GB) stays on the
     card), a checkpoint at the end and no probe (``--set
     train.checkpoint_every=96 --set train.eval_every=0``; the config's 2,000
     and 5,000 would round N = 32 to 8): (a) ``train --config pipeline_v4
     --profile --set train.log_every=16 --set train.steps_per_dispatch=1``
     for 32 steps, the eager step; (b) ``--steps 96 --set train.log_every=32
     --set train.steps_per_dispatch=32``: each dispatch 32 replays of one
     captured CUDA graph, the profile window the dispatch of steps 32-63.
     For each: s/step and images/s from metrics.jsonl over its last logged
     interval (16 or 32 steps, past the profile window; a logged step reads
     the metrics back once), the window's idle share, top device ops and host
     syncs a step, peak device memory, and for (b) the capture's seconds and
     the memory it reserved; finite losses at every logged step, no kernel
     launch. (c) ``fused_hold`` at pipeline_v4's widths on the corpus's first
     1,024 images (int8, balance 0.7): 4 steps eagerly against 2 dispatches
     of 2 from the same seeded state, draws and noise; (d) ``fused_hold`` on
     vit_b16 with ``train_encoder`` over its 256 synthetic images: 8 steps
     against 2 dispatches of 4, and exactly 72/60/60 flash, dq and dk/dv
     launches per eager step, 2 x 72/60/60 in the first dispatch (its
     warm-up step and the captured step) and none in the second (replays
     call no wrapper). The holds' bound is bit for bit: every parameter and
     buffer, the EMA, each optimizer's count, mu and nu, the step, and the
     last step's metrics. No op of either step accumulates with atomics
     (no index, gather or scatter backward; GEMMs and reductions keep their
     order on one stream), and a replay runs the kernels that the eager
     step launches, in its order, on the same buffers. No step runs before
     the holds' two runs: a process's first train step sums as later ones do
     (C3, the step's ``warm_autograd``).
 21. ``vg_full`` from JPEGs (``vg_full_phase``): (a) the JPEG loader
     (``loader_phase``; ``loader_probe`` first prints what the machine has:
     libjpeg's headers, nvJPEG, g++, host cores): its build's wall time and
     decoder, the fixture's JPEGs at 224 px against the reference decoder's
     bytes committed beside them (libjpeg: identical, or mean |d| <= 1.0 and
     max <= 8; nvJPEG: mean |d| < 6.0), every fixture JPEG at 224 and 64 px
     bit for bit against the plain numpy resize of the loader's own decode,
     and ``decode_batch``'s images/s in one thread per host core; (b) a
     corpus of 2,048 VG-shaped ids cycling the fixture's JPEGs and entries,
     without PIL; (c) ``sgg_torch.cli.preprocess --encoder vgg19
     --encoder-ckpt`` (a seeded VGG-19 saved as ``encoder_params.npz`` and
     ``pretrain_meta.json``) in bfloat16, batch 64: images/s, decode-wait
     share, shard GB, exactly 16 conv_direct launches a batch, and 64 written
     features against the library conv route in bf16 on the same decoded
     images (phase 5's VGG-19 gate); (d) ``train --config vg_full`` at full
     width (VGG-19 at 224 px, bf16, batch 256, n_critic 5) for 16 steps with
     ``--profile`` and the pixels-in probe at steps 8 and 16: materialized
     (the decoded corpus, about 0.28 GB, on the device) and on the
     host-prefetch route (a budget under it, 1,536 JPEGs decoded a step), each
     with s/step, images/s, the host's decode time a step, the probes'
     recall and seconds, peak device memory, exactly 16 x 6 = 96 conv_direct
     launches a step and the idle share; then 16 steps with
     ``train.steps_per_dispatch=8`` on the materialized store (2 x 96
     launches, the warm-up and captured steps; replays launch none); (e)
     ``generate --split test`` and ``evaluate`` with ``--decode fused`` on
     the path-backed held-out split (triples/s; conv_direct and fused_decode
     launched), and the workdir served in process, where a ``paths`` request
     and an ``images`` request of the same decoded JPEGs on the same noise
     give equal graphs.
 22. the grounded recipe from nothing (``grounded_recipe_phase``,
     ``scripts/grounded_pipeline.sh``'s stages): (a) ``sgg_torch.cli.synth_corpus
     --grounded`` writes 1,024 500 x 375 q75 JPEGs (nvJPEG's encoder on the
     card's machine), each decoded back by the loader within a mean |d| of
     8 of the array rendered (images/s, MB, the encoder's route); (b)
     ``sgg_torch.cli.pretrain --encoder vgg19`` with the spatial task, 224 px,
     batch 64, bf16, 200 steps (s/step, images/s, peak memory, the idle share
     of steps 100-104; the mean loss of the last 50 steps must be below the
     first 50's) and with ``--steps 0`` (the seeded encoder): held-out
     presence_recall, precision_at_k and cell_acc of both, 16 conv_direct
     launches a held-out batch and none in the steps (the library conv);
     (c) ``pretrain_hold`` (a float32 step card vs CPU: metrics, gradients,
     parameters, and its loss against the loss written out in float64),
     ``conv_tf32_hold`` (the bf16 step's library conv with cuDNN's TF32 at
     VGG-19's shapes and batch 64, its result and gradients against float64)
     and ``moe_hold`` (the MoE layer at ViT-B/16's width card vs CPU and
     against a float64 per-expert plain version, at capacity factors 1.25 and
     0.5);
     (d) ``pretrain --encoder vit_b16 --moe-experts 8 --moe-top-k 2`` at 768 x
     12 x 12, batch 64, 16 steps: s/step, peak memory, the aux term, the
     share of the training steps' choices dropped, exactly 12 flash, dq and
     dk/dv launches a step; (e) ``preprocess --encoder-ckpt`` through (b)'s
     encoder (16 conv_direct launches a batch, images/s), 16 steps of
     ``train --config vg1k`` on its shards and ``evaluate --decode fused``.
 23. the deployment tier (``deployment_phase``): (a) ``int8_holds``: at every
     distinct int8 conv of ResNet-50 and VGG-19 (224 px, B = 32, recorded by
     ``int8_shapes`` on the meta device) and the ViT-B/16 projections
     ([6272, 768] against [768, 2304], [768, 768], [768, 3072]; [6272, 3072]
     against [3072, 768]), bf16 operands, ``torch._int_mm`` against the plain
     float64 sums bit for bit, each shape's int8 time on the device's clock
     (CUDA graphs) beside the bf16 route's (conv_direct, fused_matmul, the
     library conv, or torch.matmul); (b) each encoder int8 against float32 on
     seeded weights, 8 images at 224 px: per-region cosine median > 0.99
     (VGG-19 > 0.98); (c) ``generate --quant int8`` and ``--quant none`` on a
     resnet50 workdir (``--decode fused``; int8: fused_decode only, no conv
     kernel) and a vit_b16 one (``--decode xla``; 12 flash launches a batch
     either way), images/s, and one ``serve --quant int8`` request over HTTP
     whose features equal ``make_image_encoder(quant='int8')``'s on the same
     padded batch; (d) ``cli.export --check`` on a vg1k workdir (features in,
     K 50, B 32) and on (c)'s resnet50 one (``--with-encoder --quant int8``),
     ``serve --artifact`` (an ``ArtifactEngine`` over HTTP) answering one
     images request with no hand-written kernel launched, and the vg1k
     artifact called in a subprocess that imports neither sgg_torch nor jax,
     its tokens equal to the live sampler's on the same noise.
 24. the data-parallel tier (``dp_phase``): each rank a process of
     ``chip_smoke.py --rank-run`` (``rank_run``), which runs
     ``sgg_torch.cli.train.main`` with the launches counted per step and the
     state, the first step's noise and the all-reduce's buckets taken; (a)
     ``torchrun --nproc_per_node 2`` of ``--config v4_32`` at full width
     (VGG-19 at 224 px, bf16, batch 128 per rank, n_critic 5) on phase 21's
     VG-shaped corpus (2,048 ids cycling the fixture), 6 steps, step 3
     profiled on each rank: the two ranks share the card over gloo; (b) the
     same at world 1 (NCCL, ``torchrun --nproc_per_node 1``) and in a plain
     process; (c) vit_b16 with ``train_encoder`` over two ranks, batch 32
     each, 3 steps, each rank started here with torchrun's environment (no
     launcher's start-up). Holds
     (``dp_holds``): the ranks' states (every parameter, optimizer moment
     and count) equal bit for bit, their noise distinct and rank 0's the
     plain run's, 96 conv_direct launches a step on each rank in (a); the
     world-1 state equal to the plain run's bit for bit; 72/60/60 flash, dq
     and dk/dv launches a step on each rank in (c). Prints s/step, global
     images/s, the all-reduce's ms a step (``pmean`` timed alone at each of
     a step's bucket sizes), each rank's idle share and the card's (the
     union of both ranks' device spans, ``card_idle``). Phase 24 starts a
     torchrun launcher (and its ranks) or a plain process per run, each
     waited for under a timeout in a session of its own.
 25. A9's rest (``convert_grain_phase``): (a) the TensorFlow-written fixture
     (``tests/fixtures_torch/tf1_ckpt``) read by ``sgg_torch.convert`` on a
     machine without TensorFlow, bit for bit against its ``.npz``; (b) at
     vg1k's widths with a vocab of 1,024, seeded reference-named arrays as an
     ``.npz`` and as a V2 bundle (read back bit for bit, the CRC32C timed),
     ``sgg_torch.cli.convert --config vg1k`` from each (equal workdirs), then
     ``generate --decode fused`` on it with exact launches and the fused
     sampler held against the CPU's plain decode; (c) pipeline_v4 on the
     grain loader with 2 spawned workers, 15 steps profiled, resumed without
     workers from its step-10 checkpoint in a workdir of its own, by the
     train CLI in a fresh process: bit for bit; (d) ``vg_full``
     on the grain loader, the workers decoding the JPEGs, 96 ``conv_direct``
     a step. Its training runs stop their worker processes when each
     returns.
 26. A8b, TP and FSDP (``tp_fsdp_phase``), in ``rank_run``'s ranks, two
     sharing the card over gloo: (a) ``--config resnet50 --set
     mesh.model=2`` (V 8,192, bf16, B 32) 3 steps, 78 ``conv_direct`` and
     216 ``fused_matmul`` launches a step on each rank, then ``generate
     --decode fused`` on its global checkpoint; (b) ``--config vit_b16 --set
     train.train_encoder=true --set mesh.fsdp=true`` 3 steps, 72/60/60 flash
     launches a step on each rank; both: every rank's gathered state equal to
     the checkpoint, each rank's state bytes below data parallelism's, the
     backend line naming gloo's host staging; (c) each again for one float32
     step at n_critic 1 against one process at the global batch
     (``world_one_hold``).
 27. A8c, ring and Ulysses sequence parallelism over the ViT's patch axis
     (``sp_phase``), two ranks sharing the card over gloo: (a) the attention
     alone at [32, 12, 196, 64] (``sp_attention_run``'s ranks, a 'seq' axis
     of both), float32 and bfloat16, forward and backward on the CUDA flash
     kernels with exact launches (ring 2/2/2 a call, Ulysses 1/1/1), held
     against the plain full attention (float32) and the plain versions of
     the same arithmetic (bfloat16, ``sp_ring_plain``); (b) ``--config
     vit_b16 --set train.train_encoder=true --set model.sp_mode=ring --set
     mesh.seq=2 --set mesh.partition=gspmd`` 3 steps, 144/120/120 flash
     launches a step on each rank; (c) ``--set model.sp_mode=ulysses --set
     mesh.model=2`` (TP over the vocabulary on the same group) 3 steps,
     72/60/60; (d) each again for one float32 step at n_critic 1 against one
     process (``world_one_hold``). Prints s/step, the collectives' ms a
     step, peak memory, and the bytes saved for the backward per rank
     against data parallelism's (``sp_saved_bytes``).
 28. A8d and A8e, pipeline and expert parallelism (``pp_ep_phase``), two
     ranks sharing the card over gloo: (a) ``--config vit_b16 --set
     mesh.model=2 --set model.pp_microbatches=4 --set mesh.partition=gspmd``
     (the frozen ViT's 12 blocks in 2 stages, TP over the vocabulary on the
     same group) 2 steps, 144 flash launches a step on each rank; (b)
     ``--set train.train_encoder=true --set model.moe_experts=8 --set
     model.moe_top_k=2 --set mesh.expert=2 --set mesh.partition=gspmd`` 2
     steps, 72/60/60 a step on each rank, each rank's state bytes below
     data parallelism's; both: every rank gathers the same global state,
     equal to the checkpoint, which restores in one process; ``generate``
     on (b)'s checkpoint; (c) each again for one float32 step at n_critic 1
     (EP's at 4 of the 12 blocks) against one process (``world_one_hold``); before
     them the flash forward at the pipeline's shapes against its plain
     version (``pp_flash_holds``: a microbatch of 8 and of 4, and the ring's
     98-row shards under DP×SP×PP against ``sp_ring_plain``). Prints
     s/step, the shifts' and the all-to-alls' ms a step, peak memory, state
     bytes, the share of routing choices dropped and each part's seconds.
 29. CNN encoders trained end to end on the configs that set
     ``model.use_pallas`` (``cnn_train_phase``): the step trains VGG-19 or
     ResNet-50 on the library conv, the probe and generate run the conv
     kernels. (d) ``train --config vg_full`` with a seeded VGG-19 on a
     VG-shaped corpus of 512 ids (materialized), frozen, 1 step (96
     conv_direct launches), its workdir then resumed with
     ``train.train_encoder=true --set train.grad_accum=4`` (the restore's
     fallback line; the encoder's optimizer at zero when its first step
     begins); (a) that run's 4 steps at full width (VGG-19 at 224 px, bf16,
     B 256, n_critic 5): s/step, peak memory, enc_gnorm, no kernel launch in
     a step, 16 conv_direct launches for the probe's held-out batch of 64,
     every encoder tensor moved, the last step profiled and split by
     region; (b) ``train --config resnet50 --set
     train.train_encoder=true`` (V 8,192, B 32) 2 steps, then ``generate
     --decode fused`` on its checkpoint, exactly 13 conv_direct, 36
     fused_matmul and 8 fused_decode launches a batch of 32; (c)
     ``cnn_hold``: one float32 step at n_critic 1, card against CPU
     (``world_one_hold``'s bound on metrics and parameters) and its first
     critic update's gradients against their float64 oracle (``c4_gate``,
     the bound in its docstring); (e) ``conv2d_direct``
     and ``fused_matmul`` refuse operands that need a gradient, launching
     nothing; (f) ``torchrun`` of ``train --config v4_32 --set
     train.train_encoder=true`` over two ranks sharing the card (B 128 a
     rank, grad_accum 2), 2 steps, held by ``dp_holds``.
Phase 15 trains vit_b16 for 16 steps with ``--profile`` (the window is steps
10-14) and prints its table.

The kernels' JSON record gives, for each kernel, its launches on the newest
main path that runs it (phase 17 for fused_decode, timed at its vg1k widths,
B = 64, which pipeline_v4 shares; phase 7 for fused_matmul and conv_direct;
phase 15 for the three flash kernels), plus phase 22's launches of each
(each of its paths counted from 0), phase 23's (its two ``generate
--quant int8`` runs, counted from 0: fused_decode and flash_attention; the
exported artifact launches none), phase 24's (every rank of its four
runs, each counted from 0 in its process), phase 25's (its CLI runs, each
counted from 0), phase 26's (every rank of its runs and its generate,
each counted from 0), phase 27's (every rank of its training runs, each
counted from 0; (a)'s holds do not count), phase 28's (every rank of its
training runs and its generate, each counted from 0) and phase 29's (its CLI
runs, each counted from 0), and
launch-weighted means over that path's shapes of ms, plain ms, library ms and
bound ms. Phase 18's serving launch counts and phase 19's are printed on lines of
their own before it. The last two lines are that
record and the device JSON. A failed check raises, so the exit code is not 0;
a watchdog turns a hang into a stack trace and a non-zero exit.
"""

import ast
import contextlib
import faulthandler
import functools
import io
import json
import math
import os
import re
import resource
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_SECONDS = 1150
SIDE_MARGIN_S = 30  # the side process's watchdog fires this long before this one's
ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_RUN = os.path.join(ROOT, "results", "run_v3_bal0.7_ckpt")
SEED = 0
N_IMAGES, BATCH, K = 512, 64, 50
PIX_IMAGES, PIX_BATCH, PIX_VOCAB = 256, 32, 8192
VIT_IMAGES, VIT_BATCH, VIT_VOCAB = 256, 32, 1024
TRAIN_STEPS = 3
VIT_TRAIN_STEPS = 16  # vit_b16 with --profile: the window is steps 10-14
# pipeline_v4: VG's 108,077 images cut to 8,192 train and 512 test images;
# the device budget cut by the same factor keeps VG's ratio of store to
# budget (10.8 GB of int8 over 4 GB: about 6 subsets).
V4_TRAIN, V4_TEST, VG_IMAGES = 8192, 512, 108_077
V4_BUDGET = int(4_000_000_000 * V4_TRAIN / VG_IMAGES)
V4_STEPS, V4_EVAL_EVERY, V4_CKPT_EVERY, V4_MIN_STEPS = 16, 8, 2, 2
# Phase 18, serving.
SERVE_BATCH, SERVE_K = 32, 50
SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 8  # requests per client thread: half binary, half JSON
SERVE_HOLD_K, SERVE_HOLD_N = 8, 20  # the card-vs-CPU hold: draws, rows (12 padded)
PIX_REQUESTS = [1, 32, 9, 24, 32, 5]  # images per resnet50 request
HTTP_TIMEOUT = 60
CLI_READY_S, CLI_EXIT_S = 180, 30
CLI_BOUND_S = CLI_READY_S + 2 * HTTP_TIMEOUT + CLI_EXIT_S
# Phase 19: PredCls draws per row, REINFORCE steps (pipeline_v4 and vit_b16)
# and the images of the preprocessed VG-shaped corpus.
PREDCLS_K, RL_STEPS, VIT_RL_STEPS, PP_IMAGES = 16, 4, 3, 2048
# Phase 20, train.steps_per_dispatch: a budget that holds phase 17's whole int8
# store (0.82 GB), N, the eager and fused runs' steps (log_every N / 2 and N),
# the holds' steps, steps per dispatch and images.
V20_BUDGET, V20_N, V20_EAGER_STEPS, V20_FUSED_STEPS = 2_000_000_000, 32, 32, 96
V20_HOLD_STEPS, V20_HOLD_N, V20_HOLD_IMAGES, V20_VIT_STEPS, V20_VIT_N = 4, 2, 1024, 8, 4
DECODE_HOST_US_LIMIT = 60  # fused_decode's wrapper, host us per call at a tiny width
# Phase 21, vg_full: the committed VG-shaped JPEG fixture and the images of the
# loader's rate.
FIXTURE = os.path.join(ROOT, "tests", "fixtures_torch", "vg_jpeg")
LOADER_RATE_IMAGES = 1536  # one vg_full step's images: 256 x (5 + 1)
# VG's 108,077 images cut to 2,048 ids; train steps (the profile window is steps
# 10-14), the fused run's steps and N, and the extraction hold's features.
VG_IMAGES_21, VG_STEPS_21, VG_FUSED_STEPS_21, VG_N_21, VG_HOLD_21 = 2048, 16, 16, 8, 64
# Phase 22, the grounded recipe from nothing: VG's 108,077 images cut to 1,024;
# VGG-19 pretrain steps at the recipe's batch (2,048 images and 400 steps until
# phase 25 came: the smoke's time), the window of steps that the
# loss gate compares (first and last) and the profiled steps; the ViT-B/16 MoE
# steps, experts and top-k; the vg1k steps on the extracted shards; the
# JPEG round trip's bound (mean |d| per image; libjpeg measured 5.99-6.56 on
# the grounded corpus, tests/test_torch_synth_corpus.py); the holds' batch.
GR_IMAGES, GR_STEPS, GR_BATCH, GR_WINDOW, GR_PROFILE = 1024, 200, 64, 50, (100, 5)
GR_MOE_STEPS, GR_EXPERTS, GR_TOP_K, GR_TRAIN_STEPS = 16, 8, 2, 16
GR_JPEG_MEAN_D, GR_HOLD_BATCH = 8.0, 4
# Phase 23, the deployment tier: calls captured in a CUDA graph and its
# replays for each int8 and bf16 time.
P23_GRAPH_CALLS, P23_GRAPH_REPS = 10, 3
# Phase 24, the data-parallel tier: v4_32's steps (the profile window is
# step 3; s/step is read after it) and vit_b16's with train_encoder (6 and 3
# before phase 27 came: the smoke's time).
DP_STEPS, DP_VIT_STEPS = 5, 2
# Phase 26, TP and FSDP: the VG-shaped corpus's ids and the vocab (resnet50's
# V), the steps of each run (3 before phase 27 came), and generate's images
# and draws on the TP run.
P26_IMAGES, P26_VOCAB, P26_STEPS, P26_GEN_IMAGES, P26_K = 512, 8192, 2, 64, 8
# Phase 27, sequence parallelism: the attention holds' [B, H, S, D] (ViT-B/16
# at 224 px, B 32) and the steps of each training run.
SP_SHAPE, P27_STEPS = (32, 12, 196, 64), 3
# Phase 28, pipeline and expert parallelism: the steps of each training run,
# the PP run's microbatches, the MoE's experts and top-k, and generate's
# images and draws on the EP checkpoint.
P28_STEPS, P28_MICRO, P28_EXPERTS, P28_TOP_K, P28_GEN_IMAGES, P28_K = 2, 4, 8, 2, 64, 8
# Its float32 EP hold's depth (the full widths, 4 of the 12 blocks: the
# 8-expert MoE's float32 state crosses gloo's host staging at each broadcast,
# gather and save; PP's hold keeps all 12, its frozen encoder's state is
# small), and the [B, H, S, D] at which the pipeline runs the flash
# forward: a microbatch of 8 (B 32 in 4) and of 4 (B 32 in 8 over four
# stages), and the ring's 2 shards of 98 patch rows under DP×SP×PP.
P28_HOLD_LAYERS = 4
P28_FLASH_SHAPES, P28_RING_SHAPE, P28_RING_N = [(8, 12, 196, 64), (4, 12, 196, 64)], \
    (8, 12, 196, 64), 2
# Phase 25, convert and the grain loader: the committed TensorFlow-written
# checkpoint; the converted vocab's size and the images generated from it;
# pipeline_v4's corpus, its unbroken steps (the profile window is steps
# 10-14) and the cut; vg_full's corpus and steps; the grain workers.
TF1_FIXTURE = os.path.join(ROOT, "tests", "fixtures_torch", "tf1_ckpt")
P25_VOCAB, P25_GEN_IMAGES = 1024, 256
P25_V4_IMAGES, P25_V4_STEPS, P25_V4_CUT = 2048, 15, 10
P25_VG_IMAGES, P25_VG_STEPS, P25_WORKERS = 2048, 2, 2
P25_RESUME_TIMEOUT_S = 300  # (c)'s resume in a fresh process
# Phase 29, CNN encoders trained end to end: the VG-shaped corpus's ids; the
# frozen vg_full run's steps and the train_encoder steps that resume it, at
# train.grad_accum 4 (B 256 in microbatches of 64; part (a) prints the
# step's peak memory); the probe's held-out images; resnet50's
# steps, batch and vocab; generate's images and draws on its checkpoint; the
# float32 hold's batch.
P29_IMAGES, P29_FROZEN_STEPS, P29_STEPS, P29_ACCUM, P29_PROBE = 512, 1, 4, 4, 64
P29_R50_STEPS, P29_R50_BATCH, P29_R50_VOCAB, P29_GEN_IMAGES, P29_K = 2, 32, 8192, 64, 8
P29_HOLD_BATCH = 4
C4_FACTOR, C4_FLOOR = 8.0, 1e-6  # cnn_hold's gradient gate (c4_gate)
# ... and v4_32's steps over two ranks and its grad_accum (B 128 a rank).
P29_V4_STEPS, P29_V4_ACCUM = 2, 2
# Phases that build their own inputs after the device and the build, so that
# ``--phases`` can run them alone.
SELECTABLE_PHASES = (21, 22, 24, 25, 26, 27, 28, 29)
# Those that the full run hands to its two side processes, in this order:
# phase 27 (four ranks, 43 GB) first, while this process holds least of the
# card, and phase 22 (its MoE ViT 28 GB) after it in the same process; phase
# 28 (its EP ranks about 20 GB) in the other, once phase 27 is done, and
# phase 29 (12.3 GB) after it.
SIDE_PHASES = ((27, 22, 26, 24), (21, 25, 28, 29))
# [B, H, S, D] of the ViT-B/16 self-attention at 224 px (the main path) and
# 384 px, and a ragged S.
FLASH_SHAPES = [(32, 12, 196, 64), (32, 12, 576, 64), (32, 12, 100, 64)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores

# ResNet-50's 1x1 convs on the pixels-in path at B = 32, 224 px, as
# (M, K, N, relu, launches per batch): conv1 (ReLU), conv3 and the
# projections (no ReLU), stage by stage.
RESNET_1X1 = [
    (100352, 64, 64, True, 1), (100352, 256, 64, True, 2),
    (100352, 64, 256, False, 4),
    (100352, 256, 128, True, 1), (25088, 512, 128, True, 3),
    (25088, 128, 512, False, 4), (25088, 256, 512, False, 1),
    (25088, 512, 256, True, 1), (6272, 1024, 256, True, 5),
    (6272, 256, 1024, False, 6), (6272, 512, 1024, False, 1),
    (6272, 1024, 512, True, 1), (1568, 2048, 512, True, 2),
    (1568, 512, 2048, False, 3), (1568, 1024, 2048, False, 1),
]
VGG_IM2COL = (401408, 27, 64, True, 0)  # conv1_1 at B = 8, 224 px
# Ragged shapes for fused_matmul's tiled instance, checked only, as (M, K,
# N, relu, guard rows): M not a multiple of the tile, K = 16 and 80, N = 8
# and 72; the last sits inside 128 seeded rows on each side, so its last M
# tile straddles the end of a into them.
MM_EDGES = [(1000, 16, 72, True, 0), (300, 80, 8, False, 0), (777, 80, 72, True, 0),
            (129, 48, 264, False, 0), (1568, 2048, 512, True, 128)]
# ResNet-50's 3x3 stride-1 convs: (x shape, Cout, launches per batch), then
# two VGG-19 shapes that the path does not run.
RESNET_3X3 = [
    ((32, 56, 56, 64), 64, 3), ((32, 28, 28, 128), 128, 3),
    ((32, 14, 14, 256), 256, 5), ((32, 7, 7, 512), 512, 2),
]
VGG_3X3 = [((8, 224, 224, 3), 64, 0), ((8, 56, 56, 256), 256, 0)]
# Shapes that put an image boundary and the SAME halo inside one tile, ragged
# M and Cout: (x shape, Cout, kernel), checked only.
CONV_EDGES = [((3, 7, 7, 512), 512, 3), ((2, 9, 13, 64), 72, 3), ((1, 5, 5, 32), 16, 3),
              ((2, 14, 14, 64), 64, 5)]


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


class Tee:
    """A stream that writes to each of its streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def sampled_rate(printed):
    """Triples/s of evaluate's sampling loop, from its printed line."""
    line = [ln for ln in printed.splitlines() if "triples/sec" in ln][-1]
    return float(line.split(" triples/sec")[0].rsplit("(", 1)[1])


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def bound(nbytes, flops, flops_per_s):
    """Least time (s) for the work: bytes over the HBM rate against the
    arithmetic over the type's peak → (seconds, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(text):
    """(kernel, registers line, spill line) for each entry function in the
    build log's ptxas -v output, the names demangled by c++filt."""
    rows, name, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            rows.append([name, line.split(":", 1)[-1].strip(), spills])
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60, check=True).stdout
        for r, n in zip(rows, out.splitlines()):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def decode_work(B, R, F, A, H, E, Z, V, dtype_bytes, hard=True):
    """(bytes, FLOPs) of one fused_decode launch: each input read once and
    the output written once; the arithmetic of the 3-step decode. In hard
    mode y is a one-hot, so the feedback rnd(y @ emb) is the chosen row of
    emb: 3 rows per batch row are read and no y @ emb is computed."""
    K_ = F + E + Z + H
    weights = F * A + H * A + A + F * H * 2 + K_ * 4 * H + (H + F) * E + E * V
    emb = 3 * B * E if hard else V * E
    biases = A + 2 * H + 4 * H + E + V
    nbytes = (B * R * F + B * Z + weights + emb + B * 3 * V) * dtype_bytes \
        + (B * 3 * V + 3 * V + biases) * 4
    feedback = 0 if hard else V * E
    flops = (2 * B * R * F * A + B * R * F + 2 * 2 * B * F * H
             + 3 * 2 * B * (H * A + R * A + R * F + K_ * 4 * H + (H + F) * E + E * V + feedback))
    return nbytes, flops


def matmul_work(M, K_, N, isz):
    return (M * K_ + K_ * N + M * N) * isz + 2 * N * 4, 2 * M * N * K_


def conv_work(shape, cout, k, isz):
    B, H, W, C = shape
    return ((B * H * W * C + k * k * C * cout + B * H * W * cout) * isz + 2 * cout * 4,
            2 * B * H * W * k * k * C * cout)


def flash_work(shape, isz):
    """(bytes, FLOPs) of one attention forward: q, k, v read once, o written
    once; q.kT and P.V."""
    B, H, S, D = shape
    return 4 * B * H * S * D * isz, 4 * B * H * S * S * D


def v4_corpus(vocab, n, seed, device, R=196, F=512, chunk=512):
    """A seeded pipeline_v4-like corpus of n images: float16 features [n, R,
    F] (normal, each region scaled by exp(N(0, 0.5)), so the int8 scales
    differ), drawn on ``device``; and 1-12 triples per image, objects
    uniform, predicates on a long tail (the k-th most frequent drawn with
    weight 1/k^1.2)."""
    import numpy as np
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    feats = np.empty((n, R, F), np.float16)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        x = torch.randn(m, R, F, generator=gen, device=device)
        x *= torch.exp(0.5 * torch.randn(m, R, 1, generator=gen, device=device))
        feats[lo:lo + m] = x.half().cpu().numpy()
    rng = np.random.default_rng(seed)
    objs, preds = np.flatnonzero(vocab.is_object), np.flatnonzero(vocab.is_predicate)
    w = 1.0 / np.arange(1, len(preds) + 1) ** 1.2
    triples = []
    for k in rng.integers(1, 13, n):
        triples.append(np.stack([rng.choice(objs, k), rng.choice(preds, k, p=w / w.sum()),
                                 rng.choice(objs, k)], axis=1).astype(np.int32))
    return feats, triples


def gather_holds(pipeline, feats, triples, alpha, subset_bytes, B, n_critic, device, seed):
    """The balanced int8 gather of ``pipeline`` (a ``sgg_torch.data.pipeline``
    module) on ``device``, on the first rotating subset of the corpus (its
    rows quantized alone, as quantization is per row; the weights from the
    whole corpus):
      - card_vs_cpu: the batch equals the same gather on the CPU, bit for bit;
      - formula: it equals the reference's formula written out in numpy, bit
        for bit: (q * scale) in float32 cast once to the store's dtype, and
        the triple (u > cumw[img]).sum(-1), at draws that include ties
        (u equal to a step of an image's CDF, which takes that step);
      - dequant: every value within half its region's scale plus one ulp of
        the store's dtype of the source feature;
      - tail: the share of draws from the rarer half of the predicates, above
        the uniform choice's at the same draws.
    Returns the numbers and a verdict for each."""
    import numpy as np
    import torch

    R = feats.shape[1]
    subset = pipeline.rotation_subsets(len(feats), feats[0].size + R * 4, subset_bytes, seed)[0]
    full = pipeline.TripleDataset(np.empty((len(triples), 0), np.float16), triples)
    weights = full.set_predicate_balance(alpha).triple_weights
    sub_feats, sub_tri = feats[subset], [triples[i] for i in subset]
    sub_w = [weights[i] for i in subset]
    shape = (n_critic + 1, B)
    gen = torch.Generator().manual_seed(seed)
    img = torch.randint(0, len(subset), shape, generator=gen)
    u = torch.rand(shape, generator=gen)
    n_tri = np.array([len(t) for t in sub_tri])
    cumw = pipeline._dense_cum_weights(sub_tri, sub_w, int(n_tri.max()))
    for j in range(min(B, 128)):  # ties: u at a step of the image's CDF
        i = int(img[0, j])
        if n_tri[i] > 1:
            u[0, j] = float(cumw[i, int(torch.randint(0, n_tri[i] - 1, (1,), generator=gen))])

    def first_batch(w, dev):
        ds = pipeline.TripleDataset(sub_feats, sub_tri, triple_weights=w)
        it = pipeline.make_device_train_iterator(
            ds, B, n_critic, device=dev, int8_store=True,
            draws=lambda step: (img.to(dev), u.to(dev)))
        return {k: v.cpu() for k, v in next(it).items()}

    dev_b, cpu_b, uni_b = first_batch(sub_w, device), first_batch(sub_w, "cpu"), \
        first_batch(None, "cpu")
    card_vs_cpu = all(torch.equal(dev_b[k], cpu_b[k]) for k in cpu_b)
    q, scale = pipeline.quantize_feature_store(sub_feats)
    dense = np.zeros((len(subset), cumw.shape[1], 3), np.int32)
    for i, t in enumerate(sub_tri):
        dense[i, : len(t)] = t
    img_n, u_n = img.numpy(), u.numpy()
    x16 = (q[img_n].astype(np.float32) * scale[img_n][..., None]).astype(sub_feats.dtype)
    trip = dense[img_n, (u_n[..., None] > cumw[img_n]).sum(-1)]
    got16 = dev_b["features"].numpy()
    differ = float(np.mean(got16.view(np.uint16) != x16.view(np.uint16)))
    ties = int(sum(1 for j in range(min(B, 128)) if u_n[0, j] in cumw[img_n[0, j]]))
    formula = (got16.dtype == sub_feats.dtype and differ == 0.0
               and np.array_equal(dev_b["triples"].numpy(), trip))
    src16 = sub_feats[img_n]
    tol = 0.5 * scale[img_n][..., None] + np.abs(np.spacing(np.abs(src16))).astype(np.float32)
    err = np.abs(got16.astype(np.float32) - src16.astype(np.float32))
    dequant_margin = float((err / tol).max())
    freq = np.bincount(np.concatenate([t[:, 1] for t in triples]))
    present = np.flatnonzero(freq)
    rare = present[np.argsort(freq[present], kind="stable")][: len(present) // 2]

    def tail(b):
        return float(np.isin(b["triples"][..., 1].numpy(), rare).mean())

    t_uni, t_bal = tail(uni_b), tail(dev_b)
    return {"card_vs_cpu": card_vs_cpu, "formula": formula, "share_differing": differ,
            "ties": ties, "dequant": dequant_margin <= 1.0, "dequant_margin": dequant_margin,
            "tail": t_bal > t_uni, "tail_uniform": t_uni, "tail_balanced": t_bal,
            "subset_images": len(subset), "store_dtype": str(dev_b["features"].dtype)}


def read_profile(wd, what):
    """The --profile table the train CLI wrote, logged; (idle share or
    None, its text)."""
    with open(os.path.join(wd, "profile", "top_ops.txt")) as f:
        table = f.read()
    if not os.path.getsize(os.path.join(wd, "profile", "trace.json")):
        raise AssertionError(f"{what}: the profile trace is empty")
    for line in table.splitlines()[:14]:
        log(f"profile {what}: {line}")
    idle = None
    for line in table.splitlines():
        if "idle share" in line and "not measured" not in line:
            idle = float(line.rsplit(" ", 1)[1])
    return idle, table


@functools.cache
def device_line():
    """The card's name and power limit as nvidia-smi gives them ("no card" on
    a dry run without one)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no card"


def read_regions(wd, what, n_critic, encoder_calls=0, precomputed=True, smi="",
                 logdir="profile"):
    """The train step's regions in the --profile trace the train CLI wrote
    (``sgg_torch.utils.profiling.region_split``), logged: each region's
    calls, host ms and device ms (inclusive: ``encoder`` also counts in
    ``critic_update``). Holds each expected region to its calls over the
    window's steps: ``sample_fakes_batched`` once a step on precomputed
    features, ``critic_update`` ``n_critic`` times, ``encoder``
    ``encoder_calls`` times a step, ``generator_update`` once; on the card
    every region has device time. Returns the split."""
    import torch

    from sgg_torch.utils.profiling import region_split

    base = os.path.join(wd, logdir)
    with open(os.path.join(base, "top_ops.txt")) as f:
        steps = int(re.match(r"steps \d+-\d+ \((\d+) steps\)", f.readline()).group(1))
    split = region_split(os.path.join(base, "trace.json"))
    regions = split["regions"] or {}
    for name, r_ in regions.items():
        dev_ms = "not measured" if r_["device_ms"] is None else f"{r_['device_ms']:.3f} ms"
        log(f"regions {what}: {name}: {r_['calls']} calls over {steps} steps, host "
            f"{r_['host_ms']:.3f} ms, device {dev_ms} [{smi}]")
    want = {"critic_update": n_critic * steps, "generator_update": steps}
    if precomputed:
        want["sample_fakes_batched"] = steps
    if encoder_calls:
        want["encoder"] = encoder_calls * steps
    got = {k_: r_["calls"] for k_, r_ in regions.items()}
    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    if got != want or split["graph_launches"] or (on_card and not all(
            r_["device_ms"] > 0 for r_ in regions.values())):
        raise AssertionError(f"{what}: regions {got} (expected {want}), graph launches "
                             f"{split['graph_launches']}")
    if split["unattributed"]:
        log(f"regions {what}: {split['unattributed']} device events without their launch")
    return {**split, "steps": steps}


def pipeline_v4_phase(dev, vocab, run_cli, sizes=None, extra_sets=None, on_workdir=None):
    """Phase 17: the pipeline_v4 corpus (``vocab``'s tokens), the train CLI
    with ``--profile``, the gather's holds, evaluate with the recipe and on
    fused_decode, and one batch of the sampler with log-probabilities against
    the CPU's. ``run_cli(main, argv, what)`` → (seconds, launch counts);
    ``sizes`` and ``extra_sets`` (config overrides) shrink it for a dry run;
    ``on_workdir(wd)``, when given, runs last, before the trained workdir is
    removed. Returns the launch counts of the fused evaluate run."""
    import numpy as np
    import torch

    from sgg_torch.cli import evaluate as evaluate_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.config import get_config
    from sgg_torch.data import write_feature_shard
    from sgg_torch.data import pipeline as v4_pipeline
    from sgg_torch.data.shards import shard_name
    from sgg_torch.eval.sampler import make_sampler
    from sgg_torch.train.checkpoint import CheckpointManager, load_generator, load_workdir
    from sgg_torch.utils.gumbel import sample_gumbel

    z_ = {"train": V4_TRAIN, "test": V4_TEST, "budget": V4_BUDGET, "steps": V4_STEPS,
          "batch": BATCH, "draws": 100, "sampler_batch": 16, **(sizes or {})}
    V4_TRAIN_, V4_TEST_, BUDGET_, STEPS_ = z_["train"], z_["test"], z_["budget"], z_["steps"]
    EV_BATCH, EV_K = z_["batch"], z_["draws"]

    def read_metrics_v4(wd):
        """metrics.jsonl of the run: a finite line per step, and the probe's
        lines."""
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        steps = [r_["step"] for r_ in lines if "d_loss" in r_]
        if steps != list(range(1, STEPS_ + 1)):
            raise AssertionError(f"pipeline_v4 metrics.jsonl steps {steps}")
        for r_ in lines:
            if not all(math.isfinite(v_) for v_ in r_.values()):
                raise AssertionError(f"pipeline_v4 metrics.jsonl line {r_} is not finite")
        return lines

    v4_base = get_config("pipeline_v4").override(
        [f"{k_}={v_}" for k_, v_ in (extra_sets or {}).items()])
    R4, F4, Z4, V4 = (v4_base.data.regions, v4_base.data.feat_dim, v4_base.model.noise_dim,
                      len(vocab))
    gen4 = torch.Generator(device=dev).manual_seed(SEED + 22)
    with tempfile.TemporaryDirectory() as root:
        data_dir, wd = os.path.join(root, "shards"), os.path.join(root, "wd")
        os.makedirs(os.path.join(data_dir, "test"))
        vocab.save(os.path.join(data_dir, "vocab.json"))
        t_c = time.perf_counter()
        feats_tr, tri_tr = v4_corpus(vocab, V4_TRAIN_, SEED + 20, dev, R4, F4)
        per_shard = V4_TRAIN_ // 4
        for s_ in range(4):
            sl = slice(s_ * per_shard, (s_ + 1) * per_shard)
            write_feature_shard(os.path.join(data_dir, shard_name(s_, 4)),
                                np.arange(sl.start, sl.stop), feats_tr[sl], tri_tr[sl])
        feats_te, tri_te = v4_corpus(vocab, V4_TEST_, SEED + 21, dev, R4, F4)
        write_feature_shard(os.path.join(data_dir, "test", shard_name(0, 1)),
                            np.arange(V4_TEST_), feats_te, tri_te)
        n_tri = sum(len(t_) for t_ in tri_tr)
        log(f"pipeline_v4 corpus: {V4_TRAIN_} train and {V4_TEST_} test images (VG: "
            f"{VG_IMAGES}) x {R4} x {F4} float16, {n_tri} train triples, V = {V4}, "
            f"predicates on a 1/k^1.2 tail; {feats_tr.nbytes / 1e9:.3f} GB float16, "
            f"{feats_tr.size / 1e9:.3f} GB as int8 (VG: 10.8 GB); device budget "
            f"data.device_resident_max_bytes = {BUDGET_} (4e9 x {V4_TRAIN_}/{VG_IMAGES}), "
            f"rotation_min_steps = {V4_MIN_STEPS} (config: 10,000); written in "
            f"{time.perf_counter() - t_c:.3f} s")
        sets = {**(extra_sets or {}), "data.data_dir": data_dir, "data.device_resident_max_bytes": BUDGET_,
                "data.rotation_min_steps": V4_MIN_STEPS, "train.eval_every": V4_EVAL_EVERY,
                "train.checkpoint_every": V4_CKPT_EVERY, "train.log_every": 1}
        argv = ["--config", "pipeline_v4", "--workdir", wd, "--steps", str(STEPS_),
                "--profile"]
        for k_, v_ in sets.items():
            argv += ["--set", f"{k_}={v_}"]
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            v4_s, v4_counts = run_cli(train_cli.main, argv, "sgg_torch.cli.train")
        v4_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
        out_ = printed.getvalue()
        lines = read_metrics_v4(wd)
        v4_cfg, _ = load_workdir(wd)
        uploads = [ln for ln in out_.splitlines() if "[sgg.data] subset" in ln and "upload" in ln]
        host_s = sum(float(ln.split("host gather ")[1].split("s")[0]) for ln in uploads)
        copy_s = sum(float(ln.split("device copy ")[1].split("s")[0]) for ln in uploads)
        cycles = sum("subset rotation: cycle" in ln for ln in out_.splitlines())
        summary = [ln for ln in out_.splitlines() if "[sgg.train] rotation: " in ln][-1]
        swaps = int(summary.split("rotation: ")[1].split(" swaps")[0])
        n_subsets = int(summary.split(" over ")[1].split(" subsets")[0])
        alive = int(summary.split("at most ")[1].split(" alive")[0])
        probes = [r_ for r_ in lines if "eval_recall@50" in r_]
        losses = [r_ for r_ in lines if "d_loss" in r_]
        step_lines = [r_ for r_ in losses if "steps_per_sec" in r_]
        s_per_step = [1 / r_["steps_per_sec"] for r_ in step_lines]
        v4_idle, _ = read_profile(wd, "pipeline_v4")
        read_regions(wd, "pipeline_v4", v4_cfg.train.n_critic, smi=device_line())
        log(f"train pipeline_v4: {STEPS_} steps in {v4_s:.3f} s in process (set-up "
            f"included), launches {v4_counts} (none expected); widths R {v4_cfg.data.regions}, "
            f"F {v4_cfg.data.feat_dim}, H {v4_cfg.model.hidden}, E {v4_cfg.model.embed_dim}, "
            f"A {v4_cfg.model.attn_dim}, Z {v4_cfg.model.noise_dim}, V "
            f"{v4_cfg.model.vocab_size}, batch {v4_cfg.train.batch_size}, grad_accum "
            f"{v4_cfg.train.grad_accum}, n_critic {v4_cfg.train.n_critic}, "
            f"{v4_cfg.model.compute_dtype}; s/step per logged step "
            f"{', '.join(f'{x_:.4f}' for x_ in s_per_step)}; last "
            f"{s_per_step[-1]:.4f} s/step, {step_lines[-1]['images_per_sec']:.1f} images/s; "
            f"peak device memory {v4_peak:.3f} GB")
        # What the step's regions cost the host with no profiler open.
        from sgg_torch.utils.profiling import annotate

        n_reg = 10_000
        t_a = time.perf_counter()
        for _ in range(n_reg):
            with annotate("critic_update"):
                pass
        reg_us = (time.perf_counter() - t_a) / n_reg * 1e6
        per_step = v4_cfg.train.n_critic + 2
        log(f"annotate with no profiler open: {reg_us:.2f} us a region, {per_step} regions a "
            f"pipeline_v4 step: {reg_us * per_step / 1e3:.4f} ms of its last "
            f"{s_per_step[-1] * 1e3:.1f} ms [{device_line()}]")
        log(f"rotation: {n_subsets} subsets, {len(uploads)} uploads ({swaps} swaps, {cycles} "
            f"full cycles, at most {alive} subsets alive), host gather {host_s:.3f} s and "
            f"device copy {copy_s:.3f} s in all")
        for r_ in probes:
            log(f"probe at step {r_['step']}: recall@50 = {r_['eval_recall@50']:.4f} in "
                f"{r_['eval_seconds']:.3f} s")
        if any(v_ for v_ in v4_counts.values()):
            raise AssertionError("pipeline_v4 training launched a kernel")
        if (len(losses) != STEPS_ or len(probes) != 2 or cycles < 1 or swaps < n_subsets
                or alive > 2):
            raise AssertionError(f"pipeline_v4: {len(losses)} logged steps, {len(probes)} "
                                 f"probes, {cycles} rotation cycles, {swaps} swaps, {alive} "
                                 "subsets alive at most")
        if not all(0.0 <= r_["eval_recall@50"] <= 1.0 for r_ in probes):
            raise AssertionError("a probe's recall is out of range")
        steps_kept = CheckpointManager(wd, None).all_steps()
        if steps_kept != list(range(STEPS_ - 10, STEPS_ + 1, V4_CKPT_EVERY)):
            raise AssertionError(f"checkpoints kept: {steps_kept}")

        # The gather's holds on the card, on the first subset of the run.
        t_h = time.perf_counter()
        from sgg_torch.data import pipeline as v4_pipeline

        holds = gather_holds(v4_pipeline, feats_tr, tri_tr, 0.7, BUDGET_ // 2,
                             v4_cfg.train.batch_size, v4_cfg.train.n_critic, dev, SEED)
        log(f"gather holds ({time.perf_counter() - t_h:.3f} s, subset of "
            f"{holds['subset_images']} images, batch [{v4_cfg.train.n_critic + 1}, "
            f"{v4_cfg.train.batch_size}], store dtype {holds['store_dtype']}): card vs CPU "
            f"bit for bit {holds['card_vs_cpu']}; vs the reference's formula in numpy bit for "
            f"bit {holds['formula']} (share differing {holds['share_differing']:.3e}, "
            f"{holds['ties']} draws at a step of their CDF); dequantized within half a "
            f"scale step plus one float16 ulp of the source {holds['dequant']} (worst "
            f"{holds['dequant_margin']:.4f} of the bound); draws from the rarer half of the "
            f"predicates {holds['tail_balanced']:.4f} balanced vs {holds['tail_uniform']:.4f} "
            f"uniform")
        if not all(holds[k_] for k_ in ("card_vs_cpu", "formula", "dequant", "tail")):
            raise AssertionError("the int8 balanced gather fails a hold")
        del feats_tr, tri_tr, feats_te, tri_te

        # Evaluate with the recipe (the generator-forward sampler), then on
        # fused_decode.
        grid_path = os.path.join(root, "grid.json")
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            ev_s, ev_counts = run_cli(evaluate_cli.main, [
                "--workdir", wd, "--ema", "--avg-last", "5", "--rank", "logp", "--k",
                "20,50,100", "--zero-shot", "--per-predicate", "--json-out", grid_path,
                "--num-samples", str(EV_K), "--batch-size", str(EV_BATCH), "--seed", str(SEED)],
                "sgg_torch.cli.evaluate")
        ev_tps = sampled_rate(printed.getvalue())
        with open(grid_path) as f:
            (combo,) = json.load(f)["combos"]
        log(f"evaluate --ema --avg-last 5 --rank logp (decode xla): {ev_s:.3f} s in process, "
            f"{ev_tps:.0f} triples/s in the sampling loop, launches {ev_counts} (none "
            f"expected); recall {combo['recall']}, zsR {combo['zero_shot_recall']} over "
            f"{combo['zero_shot_images']} images, mR@100 {combo['mean_recall@100']:.4f}")
        vals = [*combo["recall"].values(), *combo["zero_shot_recall"].values(),
                combo["mean_recall@100"]]
        if any(ev_counts.values()) or not all(0.0 <= x_ <= 1.0 for x_ in vals):
            raise AssertionError("evaluate (decode xla) launched a kernel or is out of range")
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            ef_s, v4_fused_counts = run_cli(evaluate_cli.main, [
                "--workdir", wd, "--decode", "fused", "--rank", "freq", "--k", "20,50,100",
                "--num-samples", str(EV_K), "--batch-size", str(EV_BATCH), "--seed", str(SEED)],
                "sgg_torch.cli.evaluate")
        ef_tps = sampled_rate(printed.getvalue())
        fused_recall = printed.getvalue().split(f"samples/image={EV_K} ")[1].splitlines()[0]
        want_fused = math.ceil(V4_TEST_ / EV_BATCH) * EV_K
        log(f"evaluate --decode fused --rank freq: {ef_s:.3f} s in process, {ef_tps:.0f} "
            f"triples/s in the sampling loop, launches {v4_fused_counts} (fused_decode "
            f"expected {want_fused}, {math.ceil(V4_TEST_ / EV_BATCH)} batches x K = {EV_K}); "
            f"{fused_recall}")
        if v4_fused_counts != {k_: (want_fused if k_ == "fused_decode" else 0)
                               for k_ in v4_fused_counts}:
            raise AssertionError("evaluate --decode fused did not launch fused_decode as "
                                 "expected")

        # One batch of the generator-forward sampler with log-probabilities on
        # the card against the same sampler on the CPU, given the same noise.
        sd_ema = load_generator(wd)["g_ema"]
        Ks, Bs = 8, z_['sampler_batch']
        lp_sampler = make_sampler(v4_cfg, step_mask=vocab.step_mask(), num_samples=Ks,
                                  with_logp=True)
        feats_b = torch.randn(Bs, R4, F4, generator=gen4, device=dev).half()
        z = torch.randn(Ks, Bs, Z4, generator=gen4, device=dev).to(torch.bfloat16)
        g = sample_gumbel((Ks, Bs, 3, V4), gen4, device=dev)
        gpu_tok, gpu_lp = lp_sampler({k_: v_.to(dev) for k_, v_ in sd_ema.items()}, feats_b,
                                     noise=(z, g))
        cpu_tok, cpu_lp = lp_sampler(sd_ema, feats_b.cpu(), noise=(z.cpu(), g.cpu()))
        same = gpu_tok.cpu() == cpu_tok
        agree = same.all(-1).float().mean().item()
        lp_diff = (gpu_lp.cpu() - cpu_lp).abs()[same.all(-1)].max().item()
        log(f"sampler with log-probs, CUDA vs CPU, same noise, bf16: {agree:.4f} of draws "
            f"identical; log_prob max abs difference where identical {lp_diff:.3e}")
        if agree < 0.99 or not bool(torch.isfinite(gpu_lp).all()):
            raise AssertionError("the CUDA sampler with log-probs disagrees with the CPU's")
        if on_workdir is not None:
            on_workdir(wd)
    return v4_fused_counts


def http(url, data=None, ctype="application/json"):
    """(status, body) of one call with a 60 s timeout; JSON bodies parsed."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            status, body, kind = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, body, kind = e.code, e.read(), e.headers["Content-Type"]
    return status, json.loads(body) if kind == "application/json" else body.decode()


@contextlib.contextmanager
def served(engine):
    """A DynamicBatcher and an HTTP server on 127.0.0.1 (a free port) in a
    daemon thread → (base url, batcher); all three stopped on exit."""
    import threading

    from sgg_torch.serve import DynamicBatcher, make_http_server

    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    server = thread = None
    try:
        server = make_http_server(batcher, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True,
                                  name="smoke-http")
        thread.start()
        yield f"http://127.0.0.1:{server.server_address[1]}", batcher
    finally:
        if thread is not None:
            server.shutdown()
        if server is not None:
            server.server_close()
        batcher.close()
        if thread is not None:
            thread.join(timeout=HTTP_TIMEOUT)


def in_threads(fn, args_list):
    """fn(*args) for each args in its own thread, all at once → (results,
    wall seconds); raises the first error, and if a thread outlives its
    join."""
    import threading

    results, errors = [None] * len(args_list), []

    def run(i):
        try:
            results[i] = fn(*args_list[i])
        except BaseException as e:  # noqa: BLE001 — raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), name=f"smoke-client-{i}")
               for i in range(len(args_list))]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            if th.ident is not None:
                th.join(timeout=4 * HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread outlived its join")
    if errors:
        raise errors[0]
    return results, wall


def legal_graphs(graphs, vocab_, k_draws, what):
    """Every triple's subject and object are objects and its predicate a
    predicate of the vocab, and each graph's counts sum to k_draws; → the
    number of unique triples."""
    import numpy as np

    obj_names = {vocab_.tokens[i] for i in np.flatnonzero(vocab_.is_object)}
    pred_names = {vocab_.tokens[i] for i in np.flatnonzero(vocab_.is_predicate)}
    for gr in graphs:
        if sum(t["count"] for t in gr["triples"]) != k_draws:
            raise AssertionError(f"{what}: a graph's counts do not sum to {k_draws}")
        for t in gr["triples"]:
            if not (t["subject"] in obj_names and t["object"] in obj_names
                    and t["predicate"] in pred_names):
                raise AssertionError(f"{what}: illegal triple {t}")
    return sum(len(gr["triples"]) for gr in graphs)


def with_noise(engine, noise):
    """``engine`` with its sampler fed ``noise`` = (z [K,B,Z], gumbel
    [K,B,3,V]) on every dispatch, for a hold against another device."""
    inner = engine._sampler
    engine._sampler = lambda g_params, feats, generator=None, temp=None: inner(
        g_params, feats, noise=noise, temp=temp)
    return engine


def serve_phase(dev, v4_wd, v4_vocab, pix, vit, zero_counts, read_counts, sizes=None):
    """Phase 18: the serving tier. (a) ``pipeline_v4``'s workdir ``v4_wd``
    served with --ema --avg-last 5 --rank logp over HTTP: binary and JSON
    traffic from client threads, the responses, /stats and /metrics, the 400s,
    and one padded batch of a card engine against a CPU engine on the same
    noise; (b) a resnet50 workdir (``pix`` = (cfg, vocab, generator
    state_dict, encoder state_dict)) on binary uint8 requests, with exact
    launch counts and the served features against ``make_batch_features``;
    (c) a vit_b16 workdir (``vit``, the same four) on one request of 32
    images; (d) ``python -m sgg_torch.cli.serve`` in a subprocess. ``sizes``
    shrinks it for a dry run on the CPU, where no kernel launches and the
    counts are not held. Returns the serving launch counts."""
    import math
    import signal
    import threading
    import types

    import numpy as np
    import torch

    from sgg_torch.cli.generate import make_batch_features
    from sgg_torch.serve import InferenceEngine, encode_binary_request
    from sgg_torch.train.checkpoint import load_workdir, save_generator
    from sgg_torch.utils.gumbel import sample_gumbel

    z_ = {"batch": SERVE_BATCH, "draws": SERVE_K, "clients": SERVE_CLIENTS,
          "per_client": SERVE_PER_CLIENT, "hold_draws": SERVE_HOLD_K, "hold_rows": SERVE_HOLD_N,
          "pix_requests": PIX_REQUESTS, **(sizes or {})}
    B, K = z_["batch"], z_["draws"]
    on_card = torch.device(dev).type == "cuda"
    threads_before = set(threading.enumerate())
    rs = np.random.RandomState(SEED + 30)
    out = {}

    # (a) The v4 recipe's serve step, in process.
    t_a = time.perf_counter()
    eng = InferenceEngine.from_workdir(v4_wd, ema=True, avg_last=5, rank="logp", batch_size=B,
                                       num_samples=K, device=dev)
    warm = eng.warmup()
    R4, F4 = eng.feature_shape
    log(f"serve pipeline_v4: restored step {eng.step} (EMA, mean of the last 5 checkpoints), "
        f"rank logp, batch {B}, K = {K}, {eng.cfg.model.compute_dtype}; warmup {warm:.3f} s")
    half = z_["per_client"] // 2
    counts_ = rs.randint(1, 7, (z_["clients"], 2 * half))
    bodies = {"binary": [], "json": []}
    for c in range(z_["clients"]):
        for kind, col in (("binary", 0), ("json", half)):
            reqs = []
            for j in range(half):
                n = int(counts_[c, col + j])
                f16 = rs.standard_normal((n, R4, F4)).astype(np.float16)
                if kind == "binary":
                    reqs.append((n, encode_binary_request(f16), "application/octet-stream"))
                else:
                    payload = {"features": f16.astype(np.float32).tolist()}
                    if j == 0 and c % 2 == 0:
                        payload["temperature"] = 0.5
                    reqs.append((n, json.dumps(payload).encode(), "application/json"))
            bodies[kind].append(reqs)
    n_temp = z_["clients"] // 2 + z_["clients"] % 2

    with served(eng) as (url, _):
        def client(reqs):
            got = []
            for n, body, ctype in reqs:
                status, resp = http(url + "/v1/generate", body, ctype)
                if status != 200 or len(resp["scene_graphs"]) != n:
                    raise AssertionError(f"serve pipeline_v4: status {status}, "
                                         f"{len(resp.get('scene_graphs', []))} graphs for {n}")
                got.append(resp["scene_graphs"])
            return got

        rates = {}
        for kind in ("binary", "json"):
            res, wall = in_threads(client, [(r,) for r in bodies[kind]])
            n_req = sum(len(r) for r in bodies[kind])
            n_img = sum(n for r in bodies[kind] for n, _, _ in r)
            uniq = sum(legal_graphs(g, v4_vocab, K, "serve pipeline_v4") for r in res for g in r)
            rates[kind] = (n_req, n_img, wall)
            log(f"serve pipeline_v4 {kind} ({'float16' if kind == 'binary' else 'JSON float32'}"
                f"{', ' + str(n_temp) + ' requests at temperature 0.5' if kind == 'json' else ''}"
                f"): {z_['clients']} client threads, {n_req} requests, {n_img} images in "
                f"{wall:.3f} s: {n_req / wall:.2f} requests/s, {n_img / wall:.2f} images/s, "
                f"{n_img * K / wall:.1f} triples/s; {uniq} unique triples, all type-legal")
            _, so_far = http(url + "/stats")
            log(f"serve pipeline_v4 /stats after the {kind} wave (cumulative): "
                f"{so_far['batches']} batches, average fill {so_far['avg_batch_fill']:.4f}, "
                f"batch latency {so_far['batch_latency_ms']} ms")
        status, stats = http(url + "/stats")
        _, metrics = http(url + "/metrics")
        n_req = sum(v[0] for v in rates.values())
        n_img = sum(v[1] for v in rates.values())
        lat = stats["batch_latency_ms"]
        log(f"serve pipeline_v4 /stats: {stats['requests']} requests, {stats['items']} items, "
            f"{stats['batches']} batches (average fill {stats['avg_batch_fill']:.4f} of {B}), "
            f"{stats['errors']} errors; batch latency p50 {lat['p50']} ms, p95 {lat['p95']} ms, "
            f"p99 {lat['p99']} ms")
        if (stats["requests"] != n_req or stats["items"] != n_img or stats["errors"]
                or not stats["batches"] < stats["items"]):
            raise AssertionError(f"serve pipeline_v4 /stats {stats}: expected {n_req} requests, "
                                 f"{n_img} items, fewer batches than items, no error")
        prom = {ln.split()[0]: ln.split()[1] for ln in metrics.splitlines()
                if ln and not ln.startswith("#")}
        want_prom = {"sgg_requests_total": str(stats["requests"]),
                     "sgg_items_total": str(stats["items"]),
                     "sgg_batches_total": str(stats["batches"]),
                     "sgg_errors_total": str(stats["errors"]),
                     "sgg_batch_fill_avg": f"{stats['avg_batch_fill']:.4f}",
                     "sgg_batch_size": str(B),
                     'sgg_batch_latency_ms{quantile="0.5"}': str(lat["p50"]),
                     'sgg_batch_latency_ms{quantile="0.95"}': str(lat["p95"]),
                     'sgg_batch_latency_ms{quantile="0.99"}': str(lat["p99"])}
        if prom != want_prom:
            raise AssertionError(f"/metrics {prom} disagrees with /stats {want_prom}")
        bad = http(url + "/v1/generate", json.dumps({"features": [[[1.0, 2.0]]]}).encode())
        paths = http(url + "/v1/generate", json.dumps({"paths": ["a.jpg"]}).encode())
        log(f"serve pipeline_v4 refusals: wrong shape {bad[0]} ({bad[1]['error']}); paths "
            f"{paths[0]} ({paths[1]['error']})")
        if bad[0] != 400 or paths[0] != 400 or "precomputed features" not in paths[1]["error"]:
            raise AssertionError("serve pipeline_v4: a bad request was not refused with 400")
    out["pipeline_v4"] = {k: {"requests": v[0], "images": v[1], "seconds": v[2]}
                          for k, v in rates.items()}
    out["pipeline_v4"]["stats"] = stats
    del eng

    # One padded batch of a card engine against a CPU engine, the same
    # weights and noise (z in the compute dtype and Gumbel noise in float32
    # drawn on the card).
    Kh, n_h = z_["hold_draws"], z_["hold_rows"]
    gen_h = torch.Generator(device=dev).manual_seed(SEED + 31)
    card_eng, cpu_eng = (InferenceEngine.from_workdir(
        v4_wd, ema=True, avg_last=5, rank="logp", batch_size=B, num_samples=Kh, device=where)
        for where in (dev, "cpu"))
    V4 = card_eng.cfg.model.vocab_size
    z = torch.randn(Kh, B, card_eng.cfg.model.noise_dim, generator=gen_h,
                    device=dev).to(card_eng.cfg.model.dtype)
    g = sample_gumbel((Kh, B, 3, V4), gen_h, device=dev)
    feats_h = torch.from_numpy(rs.standard_normal((n_h, R4, F4)).astype(np.float16).astype(
        np.float32))
    (c_tok, c_lp), (p_tok, p_lp) = (
        with_noise(e, (z.to(e.device), g.to(e.device)))._sample_tokens(feats_h)
        for e in (card_eng, cpu_eng))
    same = (c_tok == p_tok).all(-1)
    agree = float(same.mean())
    lp_diff = float(np.abs(c_lp - p_lp)[same].max()) if same.any() else float("nan")
    log(f"serve hold: one padded batch ({n_h} rows of {B}, K = {Kh}) of the {dev} engine "
        f"against the CPU engine, same weights and noise: {agree:.4f} of draws identical "
        f"(>= 0.99); log_prob finite {bool(np.isfinite(c_lp).all())}, max abs difference "
        f"where identical {lp_diff:.3e}")
    if c_tok.shape != (n_h, Kh, 3) or agree < 0.99 or not np.isfinite(c_lp).all():
        raise AssertionError("serve: the card engine disagrees with the CPU engine")
    del card_eng, cpu_eng
    out["hold_agree"] = agree
    log(f"serve (a) pipeline_v4: {time.perf_counter() - t_a:.3f} s")

    def pix_workdir(root, cfg_, vocab_, g_sd, enc_sd):
        with open(os.path.join(root, "config.json"), "w") as f:
            f.write(cfg_.to_json())
        vocab_.save(os.path.join(root, "vocab.json"))
        save_generator(root, g_sd, step=0, enc_params=enc_sd)

    def expect(name, counts):
        want = {k_: counts.get(k_, 0) for k_ in read_counts()}
        got = read_counts()
        log(f"serve {name} launches {got} (expected {want})")
        if on_card and got != want:
            raise AssertionError(f"serve {name}: the kernels did not launch as expected")
        return got

    # (b) Pixels in, resnet50.
    t_b = time.perf_counter()
    pix_cfg, pix_vocab, pix_g, pix_enc = pix
    S = pix_cfg.data.image_size
    with tempfile.TemporaryDirectory() as root:
        pix_workdir(root, pix_cfg, pix_vocab, pix_g, pix_enc)
        zero_counts()
        eng = InferenceEngine.from_workdir(root, rank="logp", batch_size=B, num_samples=K,
                                           device=dev)
        warm = eng.warmup()
        imgs = [rs.randint(0, 256, (n, S, S, 3)).astype(np.uint8) for n in z_["pix_requests"]]
        with served(eng) as (url, _):
            def pix_client(batch):
                got = []
                for im in batch:
                    status, resp = http(url + "/v1/generate", encode_binary_request(im),
                                        "application/octet-stream")
                    if status != 200 or len(resp["scene_graphs"]) != len(im):
                        raise AssertionError(f"serve resnet50: status {status}")
                    got.append(resp["scene_graphs"])
                return got

            res, wall = in_threads(pix_client, [(imgs[i::3],) for i in range(3)])
        if on_card:
            torch.cuda.synchronize()
        chunks = 1 + sum(math.ceil(len(im) / B) for im in imgs)
        pix_counts = expect("resnet50", {"conv_direct": 13 * chunks, "fused_matmul": 36 * chunks})
        uniq = sum(legal_graphs(g_, pix_vocab, K, "serve resnet50") for r in res for g_ in r)
        n_img = sum(len(im) for im in imgs)
        log(f"serve resnet50 (binary uint8, {len(imgs)} requests of {[len(i) for i in imgs]} "
            f"images from 3 client threads; warmup {warm:.3f} s): {n_img} images in {wall:.3f} s, "
            f"{n_img / wall:.2f} images/s through HTTP, {n_img * K / wall:.1f} triples/s; "
            f"{chunks} encoder chunks with warmup's; {uniq} unique triples, all type-legal")
        full = next(im for im in imgs if len(im) == B)
        served_feats = eng.encode_images(full)
        wd_cfg, _ = load_workdir(root)
        want = make_batch_features(wd_cfg, types.SimpleNamespace(images=full), pix_enc,
                                   torch.device(dev))(np.arange(B))
        bit_equal = served_feats.dtype == want.dtype and torch.equal(served_feats, want)
        log(f"serve resnet50 features of one {B}-image request {tuple(served_feats.shape)} "
            f"{served_feats.dtype} against make_batch_features: bit for bit {bit_equal}")
        if not bit_equal:
            raise AssertionError("serve resnet50: the served features differ from "
                                 "make_batch_features'")
        del eng
    out["resnet50"] = {"images": n_img, "seconds": wall, "launches": pix_counts,
                       "chunks": chunks}
    log(f"serve (b) resnet50: {time.perf_counter() - t_b:.3f} s")

    # (c) vit_b16, one request of 32 images.
    t_c = time.perf_counter()
    vit_cfg, vit_vocab, vit_g, vit_enc = vit
    S = vit_cfg.data.image_size
    with tempfile.TemporaryDirectory() as root:
        pix_workdir(root, vit_cfg, vit_vocab, vit_g, vit_enc)
        eng = InferenceEngine.from_workdir(root, rank="logp", batch_size=B, num_samples=K,
                                           device=dev)
        eng.warmup()
        im = rs.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
        with served(eng) as (url, _):
            zero_counts()
            t_r = time.perf_counter()
            status, resp = http(url + "/v1/generate", encode_binary_request(im),
                                "application/octet-stream")
            req_s = time.perf_counter() - t_r
            if on_card:
                torch.cuda.synchronize()
            vit_counts = expect("vit_b16", {"flash_attention": 12})
        if status != 200 or len(resp["scene_graphs"]) != B:
            raise AssertionError(f"serve vit_b16: status {status}")
        uniq = legal_graphs(resp["scene_graphs"], vit_vocab, K, "serve vit_b16")
        log(f"serve vit_b16: one request of {B} images in {req_s:.3f} s through HTTP; {uniq} "
            "unique triples, all type-legal")
        del eng
    out["vit_b16"] = {"images": B, "seconds": req_s, "launches": vit_counts}
    log(f"serve (c) vit_b16: {time.perf_counter() - t_c:.3f} s")

    # (d) The entry point, in a subprocess with its own process group.
    t_d = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        log_path = os.path.join(root, "serve.log")
        # Under coreutils' timeout (which passes SIGTERM on), so that the
        # server ends within CLI_BOUND_S even if this process is killed.
        argv = ["timeout", "-k", "5", str(CLI_BOUND_S), sys.executable, "-m",
                "sgg_torch.cli.serve", "--workdir", v4_wd, "--ema", "--avg-last", "5",
                "--port", "0"]
        if not on_card:
            argv += ["--device", "cpu"]
        with open(log_path, "w") as f:
            proc = subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        try:
            deadline, url = time.monotonic() + CLI_READY_S, None
            while url is None and time.monotonic() < deadline and proc.poll() is None:
                time.sleep(0.2)
                with open(log_path) as f:
                    ready = [ln for ln in f if "ready on http://" in ln]
                if ready:
                    url = ready[0].split("ready on ")[1].split()[0]
            ready_s = time.perf_counter() - t_d
            if url is None:
                with open(log_path) as f:
                    raise AssertionError(f"sgg_torch.cli.serve printed no ready line within "
                                         f"{CLI_READY_S} s (rc {proc.poll()}):\n{f.read()}")
            status, health = http(url + "/healthz")
            f16 = rs.standard_normal((2, R4, F4)).astype(np.float16)
            status_p, resp = http(url + "/v1/generate", encode_binary_request(f16),
                                  "application/octet-stream")
            if (status != 200 or not health["ok"] or status_p != 200
                    or len(resp["scene_graphs"]) != 2):
                raise AssertionError(f"sgg_torch.cli.serve: /healthz {status} {health}, "
                                     f"generate {status_p}")
            legal_graphs(resp["scene_graphs"], v4_vocab, 50, "sgg_torch.cli.serve")
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=CLI_EXIT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"sgg_torch.cli.serve did not exit within {CLI_EXIT_S} s "
                                     "of SIGTERM") from None
            exit_s = time.perf_counter() - t_term
            with open(log_path) as f:
                printed = f.read()
            log(f"sgg_torch.cli.serve --workdir W --ema --avg-last 5 --port 0: ready in "
                f"{ready_s:.3f} s at {url}, /healthz {health}; one binary request answered; "
                f"exit code {rc} {exit_s:.3f} s after SIGTERM")
            if rc != 0 or "draining and shutting down" not in printed:
                raise AssertionError(f"sgg_torch.cli.serve exited {rc}:\n{printed}")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
    log(f"serve (d) the entry point: {time.perf_counter() - t_d:.3f} s")

    deadline = time.monotonic() + 10
    while True:
        alive = [t_ for t_ in threading.enumerate()
                 if t_ not in threads_before and t_.is_alive()]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    log(f"serve: threads of the phase alive at its end: {[t_.name for t_ in alive]}")
    if alive:
        raise AssertionError(f"serve: threads outlived the phase: {alive}")
    return out


def read_metric_lines(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def predcls_hold(dev, cfg, sd, vocab, feats, rows, K, seed):
    """One chunk of the float32 PredCls scorer on ``dev`` against the CPU's:
    the same weights ``sd``, features [B, R, F], GT ``rows`` (image, s, p, o)
    and z [K, B, Z]. Returns (max abs difference over the legal predicates,
    max |CPU score| there, the masked scores below -1e8 in both, the GT's rank
    equal on every row)."""
    import numpy as np
    import torch

    from sgg_torch.eval.sampler import make_predcls_scorer

    cfg32 = cfg.override(["model.compute_dtype=float32"])
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(K, len(rows), cfg32.model.noise_dim, generator=gen)
    subj, obj = rows[:, 1], rows[:, 3]
    out = {}
    for where in (dev, "cpu"):
        score = make_predcls_scorer(cfg32, step_mask=vocab.step_mask(), num_samples=K)
        s_ = score({k_: v_.to(where) for k_, v_ in sd.items()}, feats.to(where), subj, obj,
                   z=z.to(where))
        out[str(where)] = s_.cpu().numpy()
    card, cpu = out[str(dev)], out["cpu"]
    legal = vocab.step_mask()[1]
    err = float(np.abs(card[:, legal] - cpu[:, legal]).max())
    scale = float(np.abs(cpu[:, legal]).max())
    masked = bool((card[:, ~legal] < -1e8).all() and (cpu[:, ~legal] < -1e8).all())
    gt = rows[:, 2]

    def rank(s_):
        return (s_ > s_[np.arange(len(gt)), gt][:, None]).sum(1)

    return err, scale, masked, bool(np.array_equal(rank(card), rank(cpu)))


def reinforce_grad_hold(dev, cfg, vocab, feats, seed, entropy):
    """One REINFORCE generator update's surrogate gradient in float32 on
    ``dev`` against the CPU's: the same seeded generator and critic, features
    [B, R, F] and noise (z [B, Z], Gumbel [B, 3, V]). Returns (tokens equal,
    worst per-tensor |card - CPU| over (1e-4 x max|CPU tensor| + 1e-6 x the
    largest |CPU| gradient), the largest gradient)."""
    import copy

    import torch

    from sgg_torch.train.losses import reinforce_generator_loss
    from sgg_torch.train.state import create_train_state
    from sgg_torch.utils.gumbel import sample_gumbel

    cfg32 = cfg.override(["model.compute_dtype=float32"])
    state = create_train_state(cfg32, seed)
    B, V = feats.shape[0], cfg32.model.vocab_size
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(B, cfg32.model.noise_dim, generator=gen)
    g = sample_gumbel((B, 3, V), gen)
    mask = torch.as_tensor(vocab.step_mask())
    got = {}
    for where in (dev, "cpu"):
        gen_m = copy.deepcopy(state.generator).to(where)
        critic = copy.deepcopy(state.critic).to(where)
        f_ = feats.to(where)
        out = gen_m(f_, z.to(where), g.to(where), tau=1.0, hard=True,
                    step_mask=mask.to(where), detach_sample=True)
        loss, _ = reinforce_generator_loss(critic, f_, out["soft"], out["log_prob"],
                                           logits=out["logits"], entropy_coef=entropy)
        params = list(gen_m.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        got[str(where)] = ([torch.zeros_like(p_) if d_ is None else d_.detach().cpu()
                            for p_, d_ in zip(params, grads)], out["tokens"].cpu())
    (gc, tc), (gp, tp) = got[str(dev)], got["cpu"]
    largest = max(float(x_.abs().max()) for x_ in gp)
    worst = max(float((a_.cpu() - b_).abs().max())
                / (1e-4 * float(b_.abs().max()) + 1e-6 * largest) for a_, b_ in zip(gc, gp))
    return bool(torch.equal(tc, tp)), worst, largest


def v4_predcls_reinforce_phase(dev, v4_wd, vocab, run_cli, sizes=None, extra_sets=None):
    """Phase 19 (a) and (b), on phase 17's workdir ``v4_wd`` and corpus before
    they are removed. (a) ``sgg_torch.cli.evaluate --ema --avg-last 5
    --predcls --predcls-samples 16`` (B = 64): P-R@k, wall seconds, rows/s,
    no kernel launch, every GT triple of the held-out split scored; and one
    chunk of the float32 scorer on the card against the CPU's (``predcls_hold``:
    scores within 1e-4 x max|score| over the legal predicates, the same GT
    rank on every row). (b) ``train --set train.estimator=reinforce --set
    train.rl_entropy=0.01`` with phase 17's config (B = 256, grad_accum 2,
    n_critic 5, bf16, the same budget and rotation) for 4 steps: finite
    losses, the ``rl_*`` keys in metrics.jsonl, no kernel launch, s/step
    beside phase 17's; and one generator update's surrogate gradient in
    float32, card against CPU (``reinforce_grad_hold``, one microbatch of
    128 rows of the corpus). ``sizes`` and ``extra_sets`` shrink it for a dry
    run. Returns the numbers."""
    import numpy as np
    import torch

    from sgg_torch.cli import evaluate as evaluate_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.cli.common import load_dataset
    from sgg_torch.data import list_shards, read_feature_shard
    from sgg_torch.train.checkpoint import load_generator, load_workdir

    z_ = {"batch": BATCH, "predcls_k": PREDCLS_K, "draws": 100, "rl_steps": RL_STEPS,
          "hold_rows": 128, **(sizes or {})}
    out = {}
    cfg, _ = load_workdir(v4_wd)
    cfg.model.vocab_size = len(vocab)
    test_ds, _ = load_dataset(cfg, split="test")
    n_gt = sum(len(t_) for t_ in test_ds.triples)

    # (a) PredCls through the CLI, then the card-vs-CPU hold.
    printed = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
        pc_s, pc_counts = run_cli(evaluate_cli.main, [
            "--workdir", v4_wd, "--ema", "--avg-last", "5", "--predcls", "--predcls-samples",
            str(z_["predcls_k"]), "--batch-size", str(z_["batch"]), "--k", "1,5,20,50",
            "--num-samples", str(z_["draws"]), "--rank", "freq", "--seed", str(SEED)],
            "sgg_torch.cli.evaluate --predcls")
    text = printed.getvalue()
    (pc_line,) = [ln for ln in text.splitlines() if "predcls (" in ln]
    (rate_line,) = [ln for ln in text.splitlines() if "rows scored in" in ln]
    n_rows = int(pc_line.split("predcls (")[1].split(" GT")[0])
    pr = {int(k_): float(v_) for k_, v_ in re.findall(r"P-R@(\d+) = ([0-9.]+)", pc_line)}
    loop_s = float(rate_line.split("scored in ")[1].split("s ")[0])
    rows_s = float(rate_line.split("(")[1].split(" rows/sec")[0])
    log(f"evaluate --ema --avg-last 5 --predcls --predcls-samples {z_['predcls_k']} (B = "
        f"{z_['batch']}, V = {len(vocab)}): {pc_s:.3f} s in process (the K = {z_['draws']} "
        f"sampling pass included), launches {pc_counts} (none expected); PredCls {n_rows} GT "
        f"triples of {len(test_ds)} held-out images in {loop_s:.3f} s, {rows_s:.0f} rows/s; "
        f"P-R@k {pr}")
    ordered = [pr[k_] for k_ in sorted(pr)]
    if (any(pc_counts.values()) or n_rows != n_gt or sorted(pr) != [1, 5, 20, 50]
            or not all(0.0 <= a_ <= b_ <= 1.0 for a_, b_ in zip(ordered, ordered[1:]))):
        raise AssertionError(f"evaluate --predcls: {n_rows} rows of {n_gt}, P-R@k {pr}, "
                             f"launches {pc_counts}")
    rows = np.asarray([(i_, *t_) for i_, trips in enumerate(test_ds.triples)
                       for t_ in trips][: z_["batch"]], np.int64)
    feats = torch.from_numpy(test_ds.features[rows[:, 0]])
    sd = load_generator(v4_wd)["g_ema"]
    t_h = time.perf_counter()
    err, scale, masked, same_rank = predcls_hold(dev, cfg, sd, vocab, feats, rows,
                                                 z_["predcls_k"], SEED + 40)
    log(f"PredCls scorer float32, card vs CPU, same weights (EMA) and z, {len(rows)} rows x "
        f"K = {z_['predcls_k']} ({time.perf_counter() - t_h:.3f} s): max abs difference over "
        f"the legal predicates {err:.3e} (limit 1e-4 x {scale:.4f}); masked scores below -1e8 "
        f"in both {masked}; GT rank equal on every row {same_rank}")
    if not (err <= 1e-4 * scale and masked and same_rank):
        raise AssertionError("the PredCls scorer on the card disagrees with the CPU's")
    out["predcls"] = {"seconds": pc_s, "loop_s": loop_s, "rows_per_s": rows_s,
                      "rows": n_rows, "pr": pr, "err": err, "scale": scale}

    # (b) REINFORCE with phase 17's config, then the gradient hold.
    gumbel_lines = [r_ for r_ in read_metric_lines(v4_wd) if "steps_per_sec" in r_
                    and "d_loss" in r_]
    gumbel_s = [1 / r_["steps_per_sec"] for r_ in gumbel_lines]
    steps = z_["rl_steps"]
    with tempfile.TemporaryDirectory() as rl_wd:
        argv = ["--config-file", os.path.join(v4_wd, "config.json"), "--workdir", rl_wd,
                "--steps", str(steps), "--set", "train.estimator=reinforce",
                "--set", "train.rl_entropy=0.01", "--set", "train.eval_every=0",
                "--set", "train.log_every=1"]
        for k_, v_ in (extra_sets or {}).items():
            argv += ["--set", f"{k_}={v_}"]
        rl_s, rl_counts = run_cli(train_cli.main, argv, "sgg_torch.cli.train reinforce")
        lines = read_metric_lines(rl_wd)
        rl_cfg, _ = load_workdir(rl_wd)
    rl_keys = {"rl_surrogate", "rl_adv_std", "rl_log_prob", "rl_entropy", "d_loss", "g_loss"}
    s_per_step = [1 / r_["steps_per_sec"] for r_ in lines if "steps_per_sec" in r_]
    log(f"train pipeline_v4 --set train.estimator=reinforce --set train.rl_entropy=0.01: "
        f"{steps} steps in {rl_s:.3f} s in process (set-up included), launches {rl_counts} "
        f"(none expected); batch {rl_cfg.train.batch_size}, grad_accum "
        f"{rl_cfg.train.grad_accum}, n_critic {rl_cfg.train.n_critic}, "
        f"{rl_cfg.model.compute_dtype}; s/step per logged step "
        f"{', '.join(f'{x_:.4f}' for x_ in s_per_step)} (phase 17's Gumbel step: "
        f"{', '.join(f'{x_:.4f}' for x_ in gumbel_s[-4:])}); last line "
        f"{ {k_: round(lines[-1][k_], 4) for k_ in sorted(rl_keys)} }")
    if ([r_["step"] for r_ in lines] != list(range(1, steps + 1)) or any(rl_counts.values())
            or not all(rl_keys <= set(r_) and all(math.isfinite(v_) for v_ in r_.values())
                       for r_ in lines)):
        raise AssertionError("REINFORCE on pipeline_v4 launched a kernel, lacks an rl_ key "
                             "or is not finite")
    shard = read_feature_shard(list_shards(cfg.data.data_dir)[0])
    feats = torch.from_numpy(shard["features"][: z_["hold_rows"]].astype(np.float32))
    t_h = time.perf_counter()
    same_tok, worst, largest = reinforce_grad_hold(dev, cfg, vocab, feats, SEED + 41, 0.01)
    log(f"REINFORCE generator gradient float32, card vs CPU, same weights, batch "
        f"({len(feats)} rows of the corpus) and noise ({time.perf_counter() - t_h:.3f} s): "
        f"tokens identical {same_tok}; worst tensor at {worst:.4f} of its bound (1e-4 x "
        f"max|CPU tensor| + 1e-6 x {largest:.4e})")
    if not (same_tok and worst <= 1.0 and largest > 0):
        raise AssertionError("the REINFORCE gradient on the card disagrees with the CPU's")
    out["reinforce"] = {"seconds": rl_s, "s_per_step": s_per_step, "gumbel_s": gumbel_s,
                        "worst": worst}
    return out


def state_tensors(state):
    """Every tensor of a train state by name: the modules' parameters and
    buffers, the EMA, each optimizer's count and moments, and the step."""
    import torch

    out = {"step": torch.tensor(state.step)}
    for name, mod in (("g", state.generator), ("d", state.critic), ("enc", state.encoder)):
        if mod is not None:
            out.update({f"{name}.{k_}": v_ for k_, v_ in mod.state_dict().items()})
    out.update({f"ema.{k_}": v_ for k_, v_ in (state.g_ema or {}).items()})
    for name, tx in (("g_tx", state.g_tx), ("d_tx", state.d_tx), ("enc_tx", state.enc_tx)):
        if tx is not None:
            out[f"{name}.count"] = torch.tensor(tx.count)
            out.update({f"{name}.mu{i_}": m_ for i_, m_ in enumerate(tx.mu)})
            out.update({f"{name}.nu{i_}": m_ for i_, m_ in enumerate(tx.nu)})
    return out


def fused_hold(dev, cfg, ds, vocab, steps, n_steps, int8=False, read_counts=None):
    """Phase 20's hold: ``steps`` train steps from one seeded state run
    eagerly (``make_device_train_iterator`` and the step, as the train CLI
    runs them with ``steps_per_dispatch`` = 1), and from the same seeded
    state through ``make_fused_device_stepper`` at ``n_steps`` per dispatch
    (on the card: warm-up, capture, replays), with the same draws (each the
    default generator seeded ``train.seed``) and the same step noise. No step
    runs before them: in a fresh process (``chip_fault_check.py``) the eager
    run's first step is the process's first, which sums as later steps do
    (C3, the step's ``warm_autograd``). Returns
    ``equal`` (every tensor of ``state_tensors`` bit for bit), ``metrics_equal``
    (the last step's metrics bit for bit), the tensors and metrics that differ
    with their largest difference, the capture's seconds and reserved bytes,
    and with ``read_counts`` the kernel launches of the eager run and of each
    dispatch."""
    import torch

    from sgg_torch.data.pipeline import make_device_train_iterator, make_fused_device_stepper
    from sgg_torch.train.state import create_train_state
    from sgg_torch.train.step import make_step_fn

    t = cfg.train
    counts = read_counts or dict
    on_card = torch.device(dev).type == "cuda"

    def since(before):
        return {k_: v_ - before[k_] for k_, v_ in counts().items()}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    step_fn = make_step_fn(cfg, step_mask=vocab.step_mask())
    eager = create_train_state(cfg, t.seed, device=dev)
    it = make_device_train_iterator(ds, t.batch_size, t.n_critic, seed=t.seed, device=dev,
                                    int8_store=int8)
    c0 = counts()
    for _ in range(steps):
        want = step_fn(eager, next(it))
    sync()
    eager_launches = since(c0)
    del it
    fused = create_train_state(cfg, t.seed, device=dev)
    stepper = make_fused_device_stepper(ds, make_step_fn(cfg, step_mask=vocab.step_mask()),
                                        t.batch_size, t.n_critic, n_steps, seed=t.seed,
                                        device=dev, int8_store=int8)
    per_dispatch = []
    for d_ in range(steps // n_steps):
        c_ = counts()
        got = stepper(fused, d_ * n_steps)
        sync()
        per_dispatch.append(since(c_))

    def diff(a, b):
        return {k_: float((a[k_].double() - b[k_].double()).abs().max())
                for k_ in a if not torch.equal(a[k_], b[k_])}

    a_, b_ = state_tensors(eager), state_tensors(fused)
    if a_.keys() != b_.keys() or want.keys() != got.keys():
        raise AssertionError("the eager and the fused state hold different tensors")
    return {"equal": not diff(a_, b_), "differ": diff(a_, b_), "tensors": len(a_),
            "metrics_equal": not diff(want, got), "metrics_differ": diff(want, got),
            "last": {k_: float(v_) for k_, v_ in got.items()}, "graph": stepper.graph is not None,
            "capture_s": stepper.capture_s, "capture_bytes": stepper.capture_bytes,
            "eager_launches": eager_launches, "per_dispatch": per_dispatch}


def fused_dispatch_phase(dev, data_dir, vocab, run_cli, read_counts, sizes=None,
                         extra_sets=None):
    """Phase 20, ``train.steps_per_dispatch``, on phase 17's corpus in
    ``data_dir`` (its vocab ``vocab``) with a device budget that holds its
    whole int8 store: (a) and (b) the train CLI eager and fused with
    ``--profile``; (c) ``fused_hold`` at pipeline_v4's widths; (d)
    ``fused_hold`` on vit_b16 with ``train_encoder``. ``run_cli`` and
    ``read_counts`` as in ``main``; ``sizes`` and ``extra_sets`` shrink it
    for a dry run on the CPU. Returns the numbers."""
    import numpy as np
    import torch

    from sgg_torch.cli import train as train_cli
    from sgg_torch.cli.common import load_dataset
    from sgg_torch.config import get_config
    from sgg_torch.data import TripleDataset, list_shards

    z_ = {"eager_steps": V20_EAGER_STEPS, "fused_steps": V20_FUSED_STEPS, "n": V20_N,
          "hold_images": V20_HOLD_IMAGES, "vit_images": VIT_IMAGES, **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as root:
        # The eager run logs every N / 2 steps, so that its last interval
        # lies past the profile window; each logged step reads the metrics
        # back once. Checkpoint and probe cadences that N divides keep it
        # unrounded (the config's 2,000 and 5,000 would round 32 to 8).
        for label, steps, n, every in (("eager", z_["eager_steps"], 1, z_["n"] // 2),
                                       ("fused", z_["fused_steps"], z_["n"], z_["n"])):
            wd = os.path.join(root, label)
            sets = {**(extra_sets or {}), "data.data_dir": data_dir,
                    "data.device_resident_max_bytes": V20_BUDGET, "train.log_every": every,
                    "train.checkpoint_every": z_["fused_steps"], "train.eval_every": 0,
                    "train.steps_per_dispatch": n}
            argv = ["--config", "pipeline_v4", "--workdir", wd, "--steps", str(steps),
                    "--profile"]
            for k_, v_ in sets.items():
                argv += ["--set", f"{k_}={v_}"]
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            printed = io.StringIO()
            with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
                run_s, counts = run_cli(train_cli.main, argv, f"sgg_torch.cli.train {label}")
            peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
            text = printed.getvalue()
            lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
            if ([r_["step"] for r_ in lines] != list(range(every, steps + 1, every))
                    or not all(math.isfinite(v_) for r_ in lines for v_ in r_.values())):
                raise AssertionError(f"phase 20 ({label}): metrics.jsonl {lines}")
            idle, table = read_profile(wd, f"pipeline_v4 {label}")
            first = table.splitlines()[0]
            # The window opens at the first dispatch boundary at or after step
            # 10 and closes at the first one at or after step 15.
            lo = -(-10 // n) * n
            want_first = f"steps {lo}-{max(lo + n, -(-15 // n) * n) - 1} "
            syncs = float(re.search(r"host syncs \d+ \(([\d.]+) a step\)", table).group(1)) \
                if "host syncs" in table else float("nan")
            fused_line = f"fused dispatch: {n} steps/program" in text
            cap = re.search(r"captured in ([\d.]+) s, ([\d.]+) GB reserved", text)
            r_ = {"s": run_s, "s_per_step": 1 / lines[-1]["steps_per_sec"],
                  "images_per_s": lines[-1]["images_per_sec"], "idle": idle, "syncs": syncs,
                  "peak_gb": peak, "window": first, "launches": counts,
                  "capture_s": float(cap.group(1)) if cap else None,
                  "capture_gb": float(cap.group(2)) if cap else None}
            out[label] = r_
            log(f"phase 20 ({'a' if n == 1 else 'b'}) train pipeline_v4 {label}, "
                f"steps_per_dispatch {n}, log_every {every}: {steps} steps in {run_s:.3f} s in "
                f"process (set-up and checkpoint included); {r_['s_per_step']:.4f} s/step and "
                f"{r_['images_per_s']:.1f} images/s over steps {lines[-2]['step']}-"
                f"{lines[-1]['step']} (metrics.jsonl); profile window '{first}', idle share "
                f"{idle}, host syncs {syncs} a step; peak device memory {peak:.3f} GB; "
                f"capture {r_['capture_s']} s, {r_['capture_gb']} GB reserved; launches "
                f"{counts} (none expected)")
            # A window of graph replays has no host ranges: no region split.
            rows = table.splitlines()
            regions = rows[next(i_ for i_, ln in enumerate(rows) if ln.startswith("regions")):]
            for ln in regions:
                log(f"phase 20 ({'a' if n == 1 else 'b'}) {label} top_ops.txt: {ln}")
            graph_ok = not (n > 1 and on_card) or (
                len(regions) == 1 and "replays a CUDA graph" in regions[0])
            if (any(counts.values()) or not first.startswith(want_first)
                    or fused_line != (n > 1) or (n > 1 and on_card and cap is None)
                    or not graph_ok):
                raise AssertionError(f"phase 20 ({label}): launches {counts}, window "
                                     f"{first!r}, fused line {fused_line}, capture {cap}, "
                                     f"regions {regions}")

    # (c) The hold at pipeline_v4's widths, on the first images of the corpus.
    full = TripleDataset.from_shards(list_shards(data_dir))
    n_h = min(z_["hold_images"], len(full))
    ds = TripleDataset(np.ascontiguousarray(full.features[:n_h]), full.triples[:n_h])
    del full
    ds.set_predicate_balance(0.7)
    cfg = get_config("pipeline_v4").override(
        [f"{k_}={v_}" for k_, v_ in (extra_sets or {}).items()])
    cfg.model.vocab_size = len(vocab)
    h = fused_hold(dev, cfg, ds, vocab, V20_HOLD_STEPS, V20_HOLD_N, int8=True)
    out["hold_v4"] = h
    log(f"phase 20 (c) hold, pipeline_v4 (B {cfg.train.batch_size}, grad_accum "
        f"{cfg.train.grad_accum}, n_critic {cfg.train.n_critic}, {cfg.model.compute_dtype}, "
        f"int8 store of {n_h} images, balance 0.7): {V20_HOLD_STEPS} eager steps against "
        f"{V20_HOLD_STEPS // V20_HOLD_N} dispatches of {V20_HOLD_N}: {h['tensors']} tensors "
        f"bit for bit {h['equal']} (differing: {dict(list(h['differ'].items())[:8])}); last "
        f"metrics bit for bit {h['metrics_equal']} {h['metrics_differ']}; graph {h['graph']}, "
        f"captured in {h['capture_s']} s, {h['capture_bytes']} bytes reserved; last losses "
        f"d {h['last']['d_loss']:.4f}, g {h['last']['g_loss']:.4f}")
    if not (h["equal"] and h["metrics_equal"] and h["graph"] == on_card):
        raise AssertionError("phase 20 (c): the fused steps differ from the eager steps")
    del ds

    # (d) vit_b16 with train_encoder: the three flash kernels inside the graph.
    vcfg = get_config("vit_b16").override(
        ["train.train_encoder=true", f"data.num_synthetic_images={z_['vit_images']}",
         *(f"{k_}={v_}" for k_, v_ in (z_.get("vit_sets") or {}).items())])
    vds, vvocab = load_dataset(vcfg)
    vcfg.model.vocab_size = len(vvocab)
    hv = fused_hold(dev, vcfg, vds, vvocab, V20_VIT_STEPS, V20_VIT_N, read_counts=read_counts)
    out["hold_vit"] = hv
    per_step = {"flash_attention": 72, "flash_attention_bwd_dq": 60,
                "flash_attention_bwd_dkv": 60}
    want_eager = {k_: (V20_VIT_STEPS * per_step.get(k_, 0) if on_card else 0)
                  for k_ in hv["eager_launches"]}
    want_first = {k_: (2 * per_step.get(k_, 0) if on_card else 0)
                  for k_ in hv["eager_launches"]}
    zero = {k_: 0 for k_ in hv["eager_launches"]}
    log(f"phase 20 (d) hold, vit_b16 train_encoder (B {vcfg.train.batch_size}, n_critic "
        f"{vcfg.train.n_critic}, {vcfg.model.compute_dtype}): {V20_VIT_STEPS} eager steps "
        f"against {V20_VIT_STEPS // V20_VIT_N} dispatches of {V20_VIT_N}: {hv['tensors']} "
        f"tensors bit for bit {hv['equal']} (differing: "
        f"{dict(list(hv['differ'].items())[:8])}); last metrics bit for bit "
        f"{hv['metrics_equal']} {hv['metrics_differ']}; captured in {hv['capture_s']} s, "
        f"{hv['capture_bytes']} bytes reserved; launches: eager {hv['eager_launches']}, per "
        f"dispatch {hv['per_dispatch']} (the first dispatch: one warm-up step and the "
        f"captured step, 72/60/60 each; replays add none)")
    if not (hv["equal"] and hv["metrics_equal"] and hv["eager_launches"] == want_eager
            and hv["per_dispatch"] == [want_first] + [zero] * (len(hv["per_dispatch"]) - 1)):
        raise AssertionError("phase 20 (d): the fused vit_b16 steps differ from the eager "
                             "steps or launched unexpectedly")
    return out


def preprocess_phase(dev, run_cli, sizes=None, extra_sets=None):
    """Phase 19 (d): ``synthetic_vg_json(2048, vocab_objects=300,
    vocab_predicates=80, max_rels=20)`` as relationships.json, then
    ``python -m sgg_torch.cli.preprocess --vg-dir D --encoder random
    --max-objects 150 --max-predicates 50 --regions 196 --feat-dim 512
    --feat-dtype float16`` (in process; VG150's vocabulary cut at pipeline_v4's
    feature widths) and 2 steps of ``train --config pipeline_v4`` on the shards.
    Gates: 150 objects and 50 predicates in vocab.json, train and test
    disjoint with the test share the reference's round(0.1 x kept), finite
    losses, no kernel launch. Returns the numbers."""
    from sgg_torch.cli import preprocess as preprocess_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.data import Vocab, list_shards, read_feature_shard, synthetic_vg_json

    z_ = {"images": PP_IMAGES, "regions": 196, "feat_dim": 512, **(sizes or {})}
    with tempfile.TemporaryDirectory() as root:
        vg_dir, out_dir, wd = (os.path.join(root, d_) for d_ in ("vg", "shards", "wd"))
        os.makedirs(vg_dir)
        t_j = time.perf_counter()
        data = synthetic_vg_json(z_["images"], vocab_objects=300, vocab_predicates=80,
                                 max_rels=20)
        with open(os.path.join(vg_dir, "relationships.json"), "w") as f:
            json.dump(data, f)
        n_rels = sum(len(e_["relationships"]) for e_ in data)
        json_s = time.perf_counter() - t_j
        pp_s, pp_counts = run_cli(preprocess_cli.main, [
            "--out-dir", out_dir, "--vg-dir", vg_dir, "--encoder", "random", "--max-objects",
            "150", "--max-predicates", "50", "--regions", str(z_["regions"]), "--feat-dim",
            str(z_["feat_dim"]), "--feat-dtype", "float16"], "sgg_torch.cli.preprocess")
        vocab = Vocab.load(os.path.join(out_dir, "vocab.json"))
        n_obj, n_pred = sum(vocab.is_object), sum(vocab.is_predicate)
        split = {}
        nbytes = 0
        for name, d_ in (("train", out_dir), ("test", os.path.join(out_dir, "test"))):
            paths = list_shards(d_)
            nbytes += sum(os.path.getsize(p_) for p_ in paths)
            split[name] = [int(i_) for p_ in paths for i_ in read_feature_shard(p_)["image_ids"]]
        kept = len(split["train"]) + len(split["test"])
        disjoint = not set(split["train"]) & set(split["test"])
        log(f"preprocess: synthetic_vg_json({z_['images']}, vocab_objects=300, "
            f"vocab_predicates=80, max_rels=20), {n_rels} relationships, written in "
            f"{json_s:.3f} s; sgg_torch.cli.preprocess --encoder random {pp_s:.3f} s, launches "
            f"{pp_counts} (none expected); vocab {len(vocab)} ({n_obj} objects, {n_pred} "
            f"predicates); {kept} images kept, {len(split['train'])} train and "
            f"{len(split['test'])} test, disjoint {disjoint}; shards "
            f"{nbytes / 1e9:.3f} GB ({z_['regions']} x {z_['feat_dim']} float16)")
        if (n_obj != 150 or n_pred != 50 or not disjoint or len(split["test"]) != round(
                0.1 * kept) or any(pp_counts.values())):
            raise AssertionError("preprocess: vocab sizes, split or launches are wrong")
        argv = ["--config", "pipeline_v4", "--workdir", wd, "--steps", "2", "--set",
                f"data.data_dir={out_dir}", "--set", "train.log_every=1"]
        for k_, v_ in (extra_sets or {}).items():
            argv += ["--set", f"{k_}={v_}"]
        tr_s, tr_counts = run_cli(train_cli.main, argv, "sgg_torch.cli.train on preprocess")
        lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
        losses = [{k_: round(r_[k_], 4) for k_ in ("d_loss", "g_loss", "gp")} for r_ in lines]
        log(f"train pipeline_v4 on the preprocessed shards: 2 steps in {tr_s:.3f} s in process "
            f"(set-up and the final probe included), launches {tr_counts} (none expected); "
            f"losses {losses}")
        if ([r_["step"] for r_ in lines] != [1, 2] or any(tr_counts.values())
                or not all(math.isfinite(v_) for r_ in lines for v_ in r_.values())):
            raise AssertionError("training on the preprocessed shards failed")
    return {"preprocess_s": pp_s, "train_s": tr_s, "gb": nbytes / 1e9, "kept": kept}


def loader_probe():
    """What the machine offers the JPEG loader: libjpeg's headers (through
    g++), nvJPEG's header and library under the CUDA toolkit, g++ and the
    host's cores."""
    from sgg_torch.native import loader

    cuda = loader.cuda_home()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    return {"jpeglib.h": loader.has_libjpeg_headers(),
            "nvjpeg.h": (cuda / "include" / "nvjpeg.h").exists(),
            "libnvjpeg": sorted(p_.name for p_ in (cuda / "lib64").glob("libnvjpeg.so*")),
            "g++": gxx.stdout.splitlines()[0] if gxx.returncode == 0 else None,
            "cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0))}


def loader_phase(fixture=FIXTURE):
    """Phase 21 (a), the JPEG loader: build it (wall time, decoder), decode
    the fixture's JPEGs at 224 px and hold them against the reference
    decoder's bytes committed beside them (libjpeg: identical, or, where the
    card's libjpeg differs from the one that wrote them, mean |d| <= 1.0 and
    max |d| <= 8; nvJPEG: mean |d| < 6.0, the reference's own bound against
    PIL); hold every fixture image at 224 and 64 px bit for bit against the
    plain resize (``resize_plain``) of the loader's own decode before the
    resize, and ``decode_batch`` bit for bit against ``decode_file``; time
    ``decode_batch`` with one thread per host core. Returns the numbers."""
    import numpy as np

    from sgg_torch.native import loader

    probe = loader_probe()
    log(f"loader probe: {probe}")
    t_b = time.perf_counter()
    if not loader.native_available():
        loader.route()  # raises NativeUnavailable with the reason
    build_wall = time.perf_counter() - t_b
    route = loader.route()
    log(f"loader build: {loader.build_seconds:.3f} s of g++ ({build_wall:.3f} s with the "
        f"load), decoder {route}")
    ref = np.load(os.path.join(fixture, "decoded_224.npz"))
    img_dir = os.path.join(fixture, "images")
    got = loader.decode_batch([os.path.join(img_dir, str(n_)) for n_ in ref["names"]], 224)
    d_ = np.abs(got.astype(np.int32) - ref["images"].astype(np.int32))
    mean_d, max_d = float(d_.mean()), int(d_.max())
    if route == "libjpeg":
        ok = max_d == 0 or (mean_d <= 1.0 and max_d <= 8)
        gate = "identical, or mean <= 1.0 and max <= 8"
    else:
        ok = mean_d < 6.0
        gate = "mean < 6.0"
    log(f"loader vs the reference decoder's bytes ({len(got)} fixture JPEGs at 224 px): mean "
        f"|d| {mean_d:.4f}, max |d| {max_d} ({gate}): {'ok' if ok else 'FAILED'}")
    paths = sorted(os.path.join(img_dir, f_) for f_ in os.listdir(img_dir))
    exact = True
    for size in (224, 64):
        batch = loader.decode_batch(paths, size, n_threads=4)
        for j_, p_ in enumerate(paths):
            single = loader.decode_file(p_, size)
            plain = loader.resize_plain(loader.decode_raw(p_, size), size)
            exact &= bool((single == plain).all() and (batch[j_] == single).all())
    log(f"loader resize and batch vs plain ({len(paths)} JPEGs at 224 and 64 px; decode_file "
        f"= resize_plain(decode_raw) and decode_batch = decode_file, bit for bit): "
        f"{'ok' if exact else 'FAILED'}")
    many = paths * (LOADER_RATE_IMAGES // len(paths))
    threads = len(os.sched_getaffinity(0))
    loader.decode_batch(many[:threads], 224, n_threads=threads)
    t_r = time.perf_counter()
    loader.decode_batch(many, 224, n_threads=threads)
    rate = len(many) / (time.perf_counter() - t_r)
    log(f"loader decode_batch: {len(many)} JPEGs (500 x 375) at 224 px in {threads} threads: "
        f"{rate:.1f} images/s")
    if not (ok and exact):
        raise AssertionError("phase 21 (a): the JPEG loader disagrees")
    return {"route": route, "build_s": loader.build_seconds, "mean": mean_d, "max": max_d,
            "images_per_s": rate, "threads": threads, "probe": probe}


def vg_corpus(root, n_images, fixture=FIXTURE):
    """Phase 21 (b): a VG-shaped corpus in ``root``: ``images/<id>.jpg`` for
    ids 1..n_images, hard links (or copies) of the fixture's JPEGs in turn,
    and a ``relationships.json`` whose entries cycle the fixture's under the
    new ids. No PIL. Returns the number of relationships."""
    import shutil

    with open(os.path.join(fixture, "relationships.json")) as f:
        entries = json.load(f)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    out = []
    for i in range(n_images):
        e_ = dict(entries[i % len(entries)], image_id=i + 1)
        src = os.path.join(fixture, "images", f"{entries[i % len(entries)]['image_id']}.jpg")
        dst = os.path.join(img_dir, f"{i + 1}.jpg")
        try:
            os.link(src, dst)
        except OSError:
            shutil.copyfile(src, dst)
        out.append(e_)
    with open(os.path.join(root, "relationships.json"), "w") as f:
        json.dump(out, f)
    return sum(len(e_["relationships"]) for e_ in out)


def vg_full_phase(dev, run_cli, read_counts, sizes=None, extra_sets=None):
    """Phase 21, ``vg_full`` from JPEGs: (a) the loader (``loader_phase``);
    (b) a corpus of 2,048 VG-shaped image ids (``vg_corpus``); (c)
    ``sgg_torch.cli.preprocess --encoder vgg19 --encoder-ckpt`` with a seeded
    VGG-19 (``encoder_params.npz`` + ``pretrain_meta.json``) in bfloat16, 64
    written features held against the library conv route in bfloat16 on the
    same decoded images (phase 5's VGG-19 gate: within 2e-2 x max, rel L2
    within 1.5e-2); (d) ``train --config vg_full`` 16 steps with the probe and
    ``--profile``, materialized (the decoded corpus on the device) and on the
    host-prefetch route (a budget under it), and with
    ``train.steps_per_dispatch``; (e) ``generate --split test`` and
    ``evaluate`` with ``--decode fused`` on the path-backed held-out split,
    and the workdir served in process, where a ``paths`` request and an
    ``images`` request of the same decoded images, on the same noise, give
    the same graphs. ``run_cli`` and ``read_counts`` as in ``main``;
    ``sizes`` and ``extra_sets`` shrink it for a dry run on the CPU. Returns
    the numbers."""
    import numpy as np
    import torch

    from sgg_torch.cli import evaluate as evaluate_cli
    from sgg_torch.cli import generate as generate_cli
    from sgg_torch.cli import preprocess as preprocess_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.cli.common import load_dataset
    from sgg_torch.convert_flax import encoder_state_dict_to_flax
    from sgg_torch.data import list_shards, read_feature_shard
    from sgg_torch.data.extract import load_batch
    from sgg_torch.models.encoders import make_encoder, normalize_for
    from sgg_torch.serve import InferenceEngine
    from sgg_torch.train.checkpoint import load_workdir

    z_ = {"images": VG_IMAGES_21, "steps": VG_STEPS_21, "fused_steps": VG_FUSED_STEPS_21,
          "n": VG_N_21, "hold": VG_HOLD_21, "image_size": 224, "batch": 64,
          "serve_images": 8, **(sizes or {})}
    S, on_card = z_["image_size"], torch.device(dev).type == "cuda"
    out = {"loader": loader_phase()}
    with tempfile.TemporaryDirectory() as root:
        vg_dir, shards, ckpt = (os.path.join(root, d_) for d_ in ("vg", "shards", "ckpt"))
        t_c = time.perf_counter()
        n_rels = vg_corpus(vg_dir, z_["images"])
        log(f"phase 21 (b) corpus: {z_['images']} image ids (the fixture's 32 JPEGs, 500 x "
            f"375, in turn), {n_rels} relationships, written in "
            f"{time.perf_counter() - t_c:.3f} s")

        # (c) preprocess --encoder vgg19 with a seeded VGG-19 checkpoint.
        torch.manual_seed(SEED + 30)
        enc_sd = make_encoder("vgg19").state_dict()
        os.makedirs(ckpt)
        np.savez(os.path.join(ckpt, "encoder_params.npz"),
                 **encoder_state_dict_to_flax(enc_sd, "vgg19")["params"])
        with open(os.path.join(ckpt, "pretrain_meta.json"), "w") as f:
            json.dump({"encoder": "vgg19", "image_size": S, "vit_dims": [768, 12, 12],
                       "moe_experts": 0, "moe_top_k": 2}, f)
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            pp_s, pp_counts = run_cli(preprocess_cli.main, [
                "--out-dir", shards, "--vg-dir", vg_dir, "--image-dir",
                os.path.join(vg_dir, "images"), "--encoder", "vgg19", "--encoder-ckpt", ckpt,
                "--batch-size", str(z_["batch"]), "--feat-dtype", "float16",
                "--compute-dtype", "bfloat16"]
                + ([] if on_card else ["--device", "cpu"]), "sgg_torch.cli.preprocess vgg19")
        stats = [ast.literal_eval(ln.split(": ", 1)[1])
                 for ln in printed.getvalue().splitlines()
                 if ln.startswith(("[sgg.preprocess] train: ", "[sgg.preprocess] test: "))]
        paths_tr, paths_te = list_shards(shards), list_shards(os.path.join(shards, "test"))
        n_done = sum(s_["num_images"] for s_ in stats)
        batches = sum(-(-s_["num_images"] // z_["batch"]) for s_ in stats)
        gb = sum(os.path.getsize(p_) for p_ in paths_tr + paths_te) / 1e9
        first = read_feature_shard(paths_tr[0])
        ids = first["image_ids"][:z_["hold"]]
        imgs = load_batch([os.path.join(vg_dir, "images", f"{i_}.jpg") for i_ in ids], S)
        lib = make_encoder("vgg19", dtype=torch.bfloat16)  # use_pallas off: the library conv
        lib.load_state_dict(enc_sd)
        lib.to(dev)
        with torch.no_grad():
            want = lib(normalize_for("vgg19", torch.from_numpy(imgs).to(dev))).float().cpu()
        got = torch.from_numpy(first["features"][:z_["hold"]].astype(np.float32))
        err = float((got - want).abs().max())
        rel = float((got - want).norm() / want.norm())
        scale = float(want.abs().max())
        per_batch = pp_counts["conv_direct"] / max(batches, 1)
        ok_c = (err <= 2e-2 * scale and rel <= 1.5e-2 and bool(torch.isfinite(got).all())
                and len(stats) == 2 and n_done > 0.95 * z_["images"]
                and (per_batch == 16 or not on_card))
        log(f"phase 21 (c) preprocess --encoder vgg19 (bfloat16, batch {z_['batch']}, "
            f"{S} px): {n_done} images in {pp_s:.3f} s in process; " + "; ".join(
                f"{'train' if j_ == 0 else 'test'} {s_['num_images']} images at "
                f"{s_['images_per_sec']} images/s, decode-wait {s_['decode_wait_frac']}"
                for j_, s_ in enumerate(stats))
            + f"; shards {gb:.3f} GB float16; conv_direct launches {pp_counts['conv_direct']}"
            f" over {batches} batches ({per_batch:g} a batch, 16 expected); {len(ids)} written "
            f"features vs the library conv route in bf16 on the same decoded images: max_abs_err "
            f"{err:.3e} (<= 2e-2 x {scale:.3e}), rel L2 {rel:.3e} (<= 1.5e-2): "
            f"{'ok' if ok_c else 'FAILED'}")
        if not ok_c:
            raise AssertionError("phase 21 (c): extraction disagrees or missed the kernel")
        out["extract"] = {"s": pp_s, "stats": stats, "gb": gb, "err": err, "rel": rel,
                          "per_batch": per_batch}

        # (d) train --config vg_full: materialized, host-prefetch, fused.
        def train_run(label, steps, sets_, profile=True):
            wd = os.path.join(root, f"wd_{label}")
            sets = {**(extra_sets or {}), "data.data_dir": vg_dir, "train.log_every": 1,
                    **sets_}
            argv = ["--config", "vg_full", "--workdir", wd, "--steps", str(steps),
                    "--encoder-ckpt", ckpt] + (["--profile"] if profile else [])
            for k_, v_ in sets.items():
                argv += ["--set", f"{k_}={v_}"]
            if not on_card:
                argv += ["--device", "cpu"]
            per_step = []
            make_step = train_cli.make_step_fn

            def counting(cfg_, step_mask=None):
                step_fn = make_step(cfg_, step_mask)

                @functools.wraps(step_fn)  # with its attributes, as the fused stepper reads
                def counted(state, batch, *a, **k):
                    before = read_counts()["conv_direct"]
                    r_ = step_fn(state, batch, *a, **k)
                    per_step.append(read_counts()["conv_direct"] - before)
                    return r_

                return counted

            if on_card:
                torch.cuda.reset_peak_memory_stats()
            printed = io.StringIO()
            train_cli.make_step_fn = counting
            try:
                with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
                    run_s, counts = run_cli(train_cli.main, argv,
                                            f"sgg_torch.cli.train vg_full {label}")
            finally:
                train_cli.make_step_fn = make_step
            peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")
            text = printed.getvalue()
            lines = read_metric_lines(wd)
            logged = [r_ for r_ in lines if "d_loss" in r_]
            probes = [r_ for r_ in lines if "eval_recall@50" in r_]
            idle = read_profile(wd, f"vg_full {label}")[0] if profile else None
            dec = re.search(r"host decode: (\d+) images in ([\d.]+) s \(([\d.]+) s per step",
                            text)
            r_ = {"s": run_s, "s_per_step": 1 / logged[-1]["steps_per_sec"],
                  "images_per_s": logged[-1]["images_per_sec"], "peak_gb": peak,
                  "idle": idle, "counts": counts, "per_step": per_step,
                  "decode_s_per_step": float(dec.group(3)) if dec else None,
                  "probes": [(p_["step"], p_["eval_recall@50"], p_["eval_seconds"])
                             for p_ in probes], "text": text, "wd": wd, "logged": logged}
            log(f"phase 21 (d) train vg_full {label}: {steps} steps in {run_s:.3f} s in "
                f"process (set-up, probes and checkpoint included); last step "
                f"{r_['s_per_step']:.4f} s/step, {r_['images_per_s']:.1f} images/s; host decode "
                f"{r_['decode_s_per_step']} s per step; probes (step, recall@50, s) "
                f"{r_['probes']}; peak device memory {peak:.3f} GB; conv_direct launches "
                f"{counts['conv_direct']} ({per_step[:3]}... a step); idle share {idle}")
            if (not all(math.isfinite(v_) for x_ in lines for v_ in x_.values())
                    or [x_["step"] for x_ in logged] != list(range(
                        sets.get("train.log_every", 1), steps + 1,
                        sets.get("train.log_every", 1)))):
                raise AssertionError(f"phase 21 (d) {label}: metrics.jsonl {lines}")
            return r_

        est = z_["images"] * 0.9 * S * S * 3  # about the decoded train split's bytes
        common = {"train.eval_every": z_["steps"] // 2, "train.checkpoint_every": z_["steps"]}
        mat = train_run("materialized", z_["steps"], common)
        host = train_run("host", z_["steps"], {**common,
                                               "data.device_resident_max_bytes": int(est // 4)})
        cfg21, vocab21 = load_workdir(mat["wd"])
        per_enc = 16 * (cfg21.train.n_critic + 1)
        for label, r_ in (("materialized", mat), ("host", host)):
            want_lines = ("materializing" in r_["text"]) == (label == "materialized") and (
                ("host iterator with prefetch, decoding" in r_["text"]) == (label == "host"))
            if ((on_card and r_["per_step"] != [per_enc] * z_["steps"]) or len(r_["probes"]) != 2
                    or not want_lines or (label == "host" and r_["decode_s_per_step"] is None)
                    or not all(0.0 <= p_[1] <= 1.0 for p_ in r_["probes"])):
                raise AssertionError(f"phase 21 (d) {label}: launches {r_['per_step']} "
                                     f"(expected {per_enc} a step), probes {r_['probes']}, "
                                     f"route lines {want_lines}")
        out["train"] = {k_: {x_: v_ for x_, v_ in r_.items() if x_ not in ("text", "logged")}
                        for k_, r_ in (("materialized", mat), ("host", host))}
        if z_["fused_steps"]:
            n_ = z_["n"]
            fused = train_run("fused", z_["fused_steps"], {
                "train.steps_per_dispatch": n_, "train.log_every": n_,
                "train.eval_every": z_["fused_steps"], "train.checkpoint_every":
                    z_["fused_steps"]}, profile=False)
            cap = re.search(r"captured in ([\d.]+) s, ([\d.]+) GB reserved", fused["text"])
            log(f"phase 21 (d) fused: steps_per_dispatch {n_}, {fused['s_per_step']:.4f} s/step "
                f"against {mat['s_per_step']:.4f} eager (materialized); capture "
                f"{cap.group(0) if cap else None}; conv_direct launches "
                f"{fused['counts']['conv_direct']}, {fused['per_step']} in the steps (the "
                f"first dispatch's warm-up and captured steps: {per_enc} each expected; replays "
                f"call no wrapper), the rest the probe's encoder")
            if f"fused dispatch: {n_} steps/program" not in fused["text"] or (
                    on_card and (cap is None or fused["per_step"] != [per_enc] * 2)):
                raise AssertionError("phase 21 (d) fused: no fused dispatch, capture or the "
                                     "wrong launches")
            out["train"]["fused"] = {x_: v_ for x_, v_ in fused.items()
                                     if x_ not in ("text", "logged")}

        # (e) generate and evaluate on the path-backed held-out split, and serving.
        wd = mat["wd"]
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            gen_s, gen_counts = run_cli(generate_cli.main, [
                "--workdir", wd, "--split", "test", "--decode", "fused", "--out",
                os.path.join(root, "graphs.json")] + ([] if on_card else ["--device", "cpu"]),
                "sgg_torch.cli.generate vg_full")
            ev_s, ev_counts = run_cli(evaluate_cli.main, [
                "--workdir", wd, "--decode", "fused", "--json-out",
                os.path.join(root, "eval.json")] + ([] if on_card else ["--device", "cpu"]),
                "sgg_torch.cli.evaluate vg_full")
        # Each CLI's own rate: triples over its loop (JPEG decode, encoder and
        # sampling), as it prints it.
        gen_tps, ev_tps = (float(x_) for x_ in re.findall(r"([\d.]+) triples/sec",
                                                          printed.getvalue())[:2])
        with open(os.path.join(root, "graphs.json")) as f:
            graphs = json.load(f)
        with open(os.path.join(root, "eval.json")) as f:
            ev = json.load(f)
        n_te, k_ = graphs["num_images"], 50  # generate's default --num-samples
        log(f"phase 21 (e) generate --split test --decode fused: {n_te} held-out images x "
            f"{k_} draws, {gen_tps:.1f} triples/s in its loop, {gen_s:.3f} s in process, "
            f"launches {gen_counts}; evaluate --decode fused: {ev_tps:.1f} triples/s in its "
            f"loop, {ev_s:.3f} s in process, launches {ev_counts}, recall "
            f"{ev['combos'][0]['recall']}")
        legal_graphs(graphs["scene_graphs"], vocab21, k_, "vg_full generate")
        if on_card and (gen_counts["conv_direct"] == 0 or gen_counts["fused_decode"] == 0
                        or ev_counts["conv_direct"] == 0 or ev_counts["fused_decode"] == 0):
            raise AssertionError("phase 21 (e): generate or evaluate missed a kernel")
        test_paths = load_dataset(cfg21, split="test")[0].paths[:z_["serve_images"]]
        engine = InferenceEngine.from_workdir(wd, device=dev, batch_size=z_["serve_images"],
                                              num_samples=8)
        engine.warmup()
        gz = torch.Generator(device=dev).manual_seed(SEED + 31)
        V_ = cfg21.model.vocab_size
        noise = (torch.randn(8, z_["serve_images"], cfg21.model.noise_dim, generator=gz,
                             device=dev).to(cfg21.model.dtype),
                 -torch.log(-torch.log(torch.rand(8, z_["serve_images"], 3, V_, generator=gz,
                                                  device=dev).clamp_min(1e-20))))
        with_noise(engine, noise)
        decoded = load_batch(test_paths, cfg21.data.image_size)
        with served(engine) as (url, _):
            st_p, by_paths = http(url + "/v1/generate", json.dumps(
                {"paths": test_paths}).encode())
            st_i, by_images = http(url + "/v1/generate", json.dumps(
                {"images": decoded.tolist()}).encode())
        same = st_p == st_i == 200 and by_paths["scene_graphs"] == by_images["scene_graphs"]
        log(f"phase 21 (e) serve: a paths request and an images request of the same "
            f"{len(test_paths)} decoded JPEGs on the same noise: status {st_p}/{st_i}, graphs "
            f"equal {same}, latency {by_paths.get('latency_ms')} / "
            f"{by_images.get('latency_ms')} ms")
        if not same:
            raise AssertionError("phase 21 (e): paths and images requests differ")
        out["infer"] = {"generate_tps": gen_tps, "evaluate_tps": ev_tps,
                        "gen_counts": gen_counts, "ev_counts": ev_counts}
    return out


def recipe_store(vg_dir, n, size, encoder="vgg19", vocab=None):
    """(uint8 images [n, S, S, 3], multi-hot labels [n, V], cell labels
    [n, R], vocab) of the first n encodable images of a VG-shaped corpus with
    boxes, as ``sgg_torch.cli.pretrain`` builds its store."""
    from sgg_torch.data import vg
    from sgg_torch.data.extract import load_batch, resolve_image_paths
    from sgg_torch.native import image_size
    from sgg_torch.train import pretrain as ptr

    with open(os.path.join(vg_dir, "relationships.json")) as f:
        rel = json.load(f)
    images = vg.parse_relationships(rel)
    vocab = vocab or vg.build_vocab_from_relationships(images)
    ids, enc = vg.filter_and_encode(images, vocab)
    ids, enc = ids[:n], enc[:n]
    paths = resolve_image_paths(ids, os.path.join(vg_dir, "images"))
    boxes = vg.parse_entity_boxes(rel)
    cells = ptr.cell_labels([boxes[i] for i in ids], vocab, ptr.feature_grid(encoder, size),
                            image_size(paths[0]))
    return load_batch(paths, size), ptr.multi_hot_labels(enc, len(vocab)), cells, vocab


def moe_plain(x, router, wi, wo, top_k, capacity):
    """The MoE layer's function written out per expert in float64 numpy,
    apart from ``sgg_torch.models.moe``: each token's top-k experts by a
    stable sort of its router probabilities (a tie keeps the lower index),
    gates renormalized over those k, slots claimed in token order with every
    token's first choice before any second, a claim past ``capacity``
    dropped; each expert's tanh-GELU MLP over its kept tokens. → (y [G, S, M],
    aux, share of the G·S·k choices dropped)."""
    import numpy as np

    x, router, wi, wo = (np.asarray(a, np.float64) for a in (x, router, wi, wo))
    G, S, M = x.shape
    E = router.shape[1]
    logits = x @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")[..., :top_k]  # [G, S, k]
    gates = np.take_along_axis(probs, order, -1)
    gates = gates / np.maximum(gates.sum(-1, keepdims=True), 1e-9)
    y = np.zeros_like(x)
    dropped = 0
    for g in range(G):
        claims = {e: [] for e in range(E)}
        for j in range(top_k):
            for t in range(S):
                e = int(order[g, t, j])
                if len(claims[e]) < capacity:
                    claims[e].append((t, j))
                else:
                    dropped += 1
        for e, kept in claims.items():
            if not kept:
                continue
            tok = np.array([t for t, _ in kept])
            h = x[g, tok] @ wi[e]
            h = 0.5 * h * (1.0 + np.tanh(math.sqrt(2.0 / math.pi) * (h + 0.044715 * h ** 3)))
            w = np.array([gates[g, t, j] for t, j in kept])[:, None]
            np.add.at(y[g], tok, w * (h @ wo[e]))
    f = np.zeros(E)
    np.add.at(f, order[..., 0].ravel(), 1.0)
    aux = E * float(np.sum(f / (G * S) * probs.mean(axis=(0, 1))))
    return y, aux, dropped / (G * S * top_k)


def moe_hold(dev, seed=SEED, G=8, S=196, M=768, E=GR_EXPERTS, k=GR_TOP_K):
    """The MoE layer at ViT-B/16's width (S = 196 tokens a group, M = 768,
    H = 3,072, 8 experts, top-2), float32, seeded: the card's ``moe_forward``
    against the same function on the CPU (y within 1e-4 x max, aux within
    1e-5 relative), and against ``moe_plain`` in float64 at capacity factors
    1.25 (the layer's) and 0.5 (most experts full), capacities from
    ``moe_capacity`` for the port and ceil(k·S·cf / E) for the plain version:
    every token's output within 1e-4 x max but at most 0.2 % of the tokens
    (a near-tie in the router may pick another expert in float64), aux within
    1e-5. Returns the numbers and ``ok``."""
    import numpy as np
    import torch

    from sgg_torch.models import moe
    from sgg_torch.models.resnet import he_normal

    torch.manual_seed(seed)
    H = 4 * M
    params = {"router": 0.02 * torch.randn(M, E), "wi": he_normal((E, M, H)),
              "wo": he_normal((E, H, M))}
    x = torch.randn(G, S, M)
    out = {"ok": True}
    for cf in (1.25, 0.5):
        cap = moe.moe_capacity(E, k, S, cf)
        y_d, aux_d = moe.moe_forward({n_: v_.to(dev) for n_, v_ in params.items()}, x.to(dev),
                                     k, cap)
        y_d, aux_d = y_d.cpu(), float(aux_d)
        y_h, aux_h = moe.moe_forward(params, x, k, cap)
        scale = float(y_h.abs().max())
        err_h = float((y_d - y_h).abs().max())
        y_p, aux_p, dropped = moe_plain(x.numpy(), params["router"].numpy(),
                                        params["wi"].numpy(), params["wo"].numpy(), k,
                                        max(1, math.ceil(k * S * cf / E)))
        tok_err = np.abs(y_d.numpy() - y_p).max(-1)
        far = float((tok_err > 1e-4 * np.abs(y_p).max()).mean())
        ok = (err_h <= 1e-4 * scale and abs(aux_d - aux_h) <= 1e-5 * abs(aux_h)
              and far <= 2e-3 and abs(aux_d - aux_p) <= 1e-5 * abs(aux_p)
              and bool(torch.isfinite(y_d).all()))
        log(f"phase 22 (c) moe_forward [{G}, {S}, {M}] x {E} experts, top-{k}, capacity factor "
            f"{cf} (C = {cap}), float32: card vs CPU max_abs_err {err_h:.3e} (<= 1e-4 x "
            f"{scale:.3e}), aux {aux_d:.6f} vs {aux_h:.6f}; vs the plain float64 version: "
            f"tokens off {far:.4f} (<= 0.002), aux {aux_p:.6f}, choices dropped "
            f"{dropped:.4f}: {'ok' if ok else 'FAILED'}")
        out[cf] = {"err": err_h, "tokens_off": far, "aux": aux_d, "dropped": dropped}
        out["ok"] &= ok
    return out


def pretrain_hold(dev, store, seed=SEED, batch=GR_HOLD_BATCH):
    """One float32 VGG-19 pretrain step with the spatial task on the card
    against the same step on the CPU, from the same seeded weights at the
    same indices (the first ``batch`` rows of ``store``, as ``recipe_store``
    returns it): every metric, gradient and parameter finite; metrics within
    1e-4 relative; the gradients handed to Adam, per tensor, within a
    relative L2 distance of 2e-3 and a largest difference of 5e-3 x the
    tensor's max on the CPU plus 1e-6 x the largest of all (cuDNN's float32
    algorithms on the card, FFT and im2col GEMMs without TF32, put every conv
    gradient of the seeded VGG-19 at 1.7e-4 to 8.8e-4 rel L2 and at most
    1.8e-3 x max from the CPU's on an H100 80GB HBM3 at 700 W; the CPU
    against itself at another thread count 1e-6; a term dropped or scaled
    moves it by O(1)). The parameters after the step, element by element
    where the CPU's gradient is at least twice that allowance (there the
    gradient gate fixes the sign, and Adam's first update from zero moments
    moves an element by lr·g/(|g| + 1e-8), lr x its sign): within 1e-3 x lr
    plus 2^-21 x |p| of the CPU's; an element whose gradient is rounding
    noise may move either way by lr, and is left out (the count is printed).
    And the step's loss against the loss written out in float64 from the
    CPU model's outputs before its step (BCE + the spatial CE), and its cell
    accuracy: within 1e-4 relative. Returns the numbers and ``ok``."""
    import numpy as np
    import torch

    from sgg_torch.train import pretrain as ptr

    images, labels, cells, vocab = store
    size, V, lr = images.shape[1], len(vocab), 1e-4
    idx = torch.arange(batch)
    runs = {}
    weights = None
    for where in ("cpu", dev):
        model, opt = ptr.make_pretrain_state("vgg19", V, image_size=size, lr=lr, seed=seed,
                                             device=where)
        if weights is not None:  # the CPU model's initial weights
            model.load_state_dict(weights)
        else:
            weights = {k_: v_.clone() for k_, v_ in model.state_dict().items()}
            with torch.no_grad():
                out = model(torch.from_numpy(images[:batch]))
            p_ = out["presence"].double().numpy()
            r_ = out["regions"].double().numpy()
            lab, cel = labels[:batch].astype(np.float64), cells[:batch]
            rmax = r_.max(-1, keepdims=True)
            lse = np.log(np.exp(r_ - rmax).sum(-1)) + rmax[..., 0]
            plain_loss = float(np.mean(np.logaddexp(0.0, p_) - lab * p_)
                               + np.mean(lse - np.take_along_axis(r_, cel[..., None], -1)[..., 0]))
            fg = cel > 0
            plain_cell = float(((r_.argmax(-1) == cel) & fg).sum() / max(fg.sum(), 1))
        grads = []
        update = opt.update
        opt.update = lambda g_, _u=update: (grads.extend(x_.detach().cpu() for x_ in g_), _u(g_))
        step = ptr.make_pretrain_step(model, opt, batch, seed=seed, spatial=True)
        t = (torch.from_numpy(a).to(where) for a in (images, labels, cells))
        m_ = {k_: float(v_) for k_, v_ in step(*t, idx=idx.to(where)).items()}
        runs[where] = (m_, grads, {k_: v_.detach().cpu() for k_, v_ in model.state_dict().items()})
    (m_d, g_d, p_d), (m_h, g_h, p_h) = runs[dev], runs["cpu"]
    finite = (all(math.isfinite(v_) for v_ in (*m_d.values(), *m_h.values()))
              and all(bool(torch.isfinite(t_).all())
                      for t_ in (*g_d, *g_h, *p_d.values(), *p_h.values())))
    ok_m = all(abs(m_d[k_] - m_h[k_]) <= 1e-4 * abs(m_h[k_]) + 1e-6 for k_ in m_h)
    largest = max(float(x_.abs().max()) for x_ in g_h)
    worst = max(float((a_ - b_).abs().max()) / (5e-3 * float(b_.abs().max()) + 1e-6 * largest)
                for a_, b_ in zip(g_d, g_h))
    rel = max(float((a_ - b_).norm() / b_.norm().clamp_min(1e-30)) for a_, b_ in zip(g_d, g_h))
    held = total = 0
    p_worst = 0.0
    for (name, _), g_ in zip(model.named_parameters(), g_h):
        sig = g_.abs() >= 2 * (5e-3 * float(g_.abs().max()) + 1e-6 * largest)
        d_ = (p_d[name] - p_h[name]).abs()[sig]
        held, total = held + int(sig.sum()), total + g_.numel()
        if d_.numel():
            p_worst = max(p_worst, float((d_ / (1e-3 * lr + 2.0 ** -21
                                                * p_h[name].abs()[sig])).max()))
    ok_g = worst <= 1.0 and rel <= 2e-3
    ok_p = held > 0 and p_worst <= 1.0
    ok_l = (abs(m_h["loss"] - plain_loss) <= 1e-4 * abs(plain_loss)
            and abs(m_d["loss"] - plain_loss) <= 1e-4 * abs(plain_loss)
            and abs(m_d["cell_acc"] - plain_cell) <= 1e-6)
    ok = finite and ok_m and ok_g and ok_p and ok_l
    log(f"phase 22 (c) pretrain step vgg19 float32 (B {batch}, {size} px, spatial on, V {V}) "
        f"card vs CPU: all finite {finite}; metrics {m_d} vs {m_h} (1e-4 relative: {ok_m}); "
        f"gradients, worst per-tensor rel L2 {rel:.3e} (<= 2e-3) and |card - CPU| over "
        f"(5e-3 x max + 1e-6 x {largest:.3e}) {worst:.4f} (<= 1); parameters after the step "
        f"at the {held} of {total} elements whose gradient is at least twice that "
        f"allowance: |card - CPU| over (1e-3 lr + 2^-21 |p|) at most {p_worst:.4f} (<= 1); "
        f"the step's loss vs the plain float64 loss {plain_loss:.6f} (BCE + CE from the CPU "
        f"model's outputs) and cell_acc vs {plain_cell:.4f}: {ok_l}: {'ok' if ok else 'FAILED'}")
    return {"card": m_d, "cpu": m_h, "plain_loss": plain_loss, "grad_worst": worst,
            "grad_rel": rel, "params_held": held, "params_worst": p_worst, "ok": ok}


def conv_tf32_hold(dev, seed=SEED, batch=GR_BATCH, size=224):
    """The library conv of the bf16 pretrain step where it lets cuDNN use
    TF32 (``sgg_torch.kernels.conv_direct.tf32_allowed``), at each distinct
    conv shape of VGG-19 at ``size`` px and the recipe's batch: bfloat16
    values for x, w and the incoming gradient (what the step hands the conv
    for VGG-19), the conv's float32 forward and both float32 gradients before
    their cast to bfloat16, with TF32 as the step runs it and with it
    refused, each against the same conv in float64 on the card. Gate: with
    TF32 every result within a relative L2 distance of 2^-9 (half a bfloat16
    rounding, which each gradient gets next) of float64, and all finite.
    Returns the numbers and ``ok``."""
    import torch

    from sgg_torch.kernels import conv_direct
    from sgg_torch.models.vgg import _CFG

    shapes, cin, hw = [], 3, size
    for block, n_convs, ch in _CFG:
        for _ in range(n_convs):
            if (cin, ch, hw) not in shapes:
                shapes.append((cin, ch, hw))
            cin = ch
        hw = hw // 2 if block < 5 else hw
    gen = torch.Generator(device=dev).manual_seed(seed)

    def bf16_valued(*shape, scale=1.0):
        t_ = torch.randn(*shape, generator=gen, device=dev) * scale
        return t_.to(torch.bfloat16).float()

    def run(x, w, gy, tf32):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = conv_direct._Conv2dF32.apply(x, w, 1, tf32)
        gx, gw = torch.autograd.grad(y, (x, w), gy)
        return y.detach(), gx, gw

    def rel(a_, b_):
        return float((a_.double() - b_).norm() / b_.norm().clamp_min(1e-300))

    rows, worst, finite = [], 0.0, True
    for cin, cout, hw in shapes:
        x = conv_direct.pad_nhwc(bf16_valued(batch, hw, hw, cin), 3, 3, 1, "SAME")
        x = x.permute(0, 3, 1, 2)
        w = bf16_valued(cout, cin, 3, 3, scale=(2.0 / (9 * cin)) ** 0.5)
        gy = bf16_valued(batch, cout, hw, hw)
        want = run(x.double(), w.double(), gy.double(), False)
        got = run(x, w, gy, conv_direct.tf32_allowed(torch.bfloat16))
        off = run(x, w, gy, False)
        errs = [rel(a_, b_) for a_, b_ in zip(got, want)]
        errs_off = [rel(a_, b_) for a_, b_ in zip(off, want)]
        finite &= all(bool(torch.isfinite(t_).all()) for t_ in got)
        worst = max(worst, *errs)
        rows.append({"shape": [batch, hw, hw, cin, cout], "tf32": errs, "f32": errs_off})
        del x, w, gy, want, got, off
    ok = finite and worst <= 2.0 ** -9
    log(f"phase 22 (c) library conv of the bf16 pretrain step with cuDNN's TF32 "
        f"({conv_direct.tf32_allowed(torch.bfloat16)}), {len(shapes)} VGG-19 shapes at "
        f"{size} px, batch {batch}, bf16-valued x, w and dy: rel L2 vs float64 of (y, dx, "
        f"dw), TF32 / float32 without it: "
        + "; ".join(f"{r_['shape'][1]}x{r_['shape'][3]}->{r_['shape'][4]} "
                    + ", ".join(f"{a_:.2e}/{b_:.2e}" for a_, b_ in zip(r_["tf32"], r_["f32"]))
                    for r_ in rows)
        + f"; worst with TF32 {worst:.3e} (<= 2^-9), all finite {finite}: "
        f"{'ok' if ok else 'FAILED'}")
    return {"rows": rows, "worst": worst, "ok": ok}


def grounded_recipe_phase(dev, run_cli, read_counts, sizes=None, extra_sets=None):
    """Phase 22, the grounded recipe from nothing (``scripts/grounded_pipeline.sh``
    on the card): (a) ``sgg_torch.cli.synth_corpus --grounded`` writes GR_IMAGES
    500 x 375 q75 JPEGs, every one decoded back by the loader within mean
    |d| <= GR_JPEG_MEAN_D of the array rendered; (b) ``sgg_torch.cli.pretrain
    --encoder vgg19`` (spatial auto, 224 px, batch 64, bf16) for GR_STEPS
    steps, and with ``--steps 0`` (the seeded encoder's held-out report):
    s/step, images/s, peak memory, the idle share over a profiled window, the
    mean loss of the first and the last GR_WINDOW steps (the gate: last <
    first), the held-out reports and 16 conv_direct launches per held-out
    batch; (c) ``pretrain_hold``, ``conv_tf32_hold`` and ``moe_hold``; (d)
    ``pretrain --encoder vit_b16 --moe-experts 8 --moe-top-k 2`` at 768 x 12
    x 12, batch 64: s/step, peak memory, the aux term, the share of the
    training steps' choices dropped, exactly 12 flash, dq and dk/dv
    launches a step; (e) ``preprocess --encoder vgg19 --encoder-ckpt`` on
    (b)'s out-dir (16 conv_direct launches a batch), 16 steps of ``train
    --config vg1k`` on its shards, then ``evaluate --decode fused``. ``run_cli`` and ``read_counts`` as in ``main``; ``sizes`` and
    ``extra_sets`` (the vg1k run's overrides) shrink it for a dry run on the
    CPU. Returns the numbers, with ``launches``: the phase's launches per
    kernel."""
    import numpy as np
    import torch

    from sgg_torch import native
    from sgg_torch.cli import evaluate as evaluate_cli
    from sgg_torch.cli import preprocess as preprocess_cli
    from sgg_torch.cli import pretrain as pretrain_cli
    from sgg_torch.cli import synth_corpus as synth_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.data import Vocab
    from sgg_torch.models import moe
    from sgg_torch.train import pretrain as ptr
    from sgg_torch.utils.profiling import StepProfiler

    z_ = {"images": GR_IMAGES, "image_size": 224, "batch": GR_BATCH, "steps": GR_STEPS,
          "window": GR_WINDOW, "profile": GR_PROFILE, "moe_steps": GR_MOE_STEPS,
          "vit_dims": "768,12,12", "experts": GR_EXPERTS, "top_k": GR_TOP_K,
          "train_steps": GR_TRAIN_STEPS, "dtype": "bfloat16", "moe_hold": {},
          **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    S, B = z_["image_size"], z_["batch"]
    launches = dict.fromkeys(read_counts(), 0)
    out = {}

    def add(counts):
        for k_, v_ in counts.items():
            launches[k_] += v_

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan")

    with tempfile.TemporaryDirectory() as root:
        corpus, enc_dir, seeded_dir, moe_dir, shards, wd = (
            os.path.join(root, d_) for d_ in ("corpus", "enc", "seeded", "moe", "shards", "wd"))

        # (a) The corpus, each JPEG decoded back as it is written.
        diffs, hook = [], [0.0]
        encode = native.encode_file

        def encode_and_check(path, rgb, **k):
            encode(path, rgb, **k)
            t_ = time.perf_counter()
            back = native.decode_raw(path, native.loader.FULL_SIZE)
            diffs.append(float(np.abs(back.astype(np.int16) - rgb).mean()))
            hook[0] += time.perf_counter() - t_

        native.encode_file = encode_and_check
        try:
            a_s, a_counts = run_cli(synth_cli.main, [
                "--out-dir", corpus, "--num-images", str(z_["images"]), "--grounded"],
                "sgg_torch.cli.synth_corpus --grounded")
        finally:
            native.encode_file = encode
        img_dir = os.path.join(corpus, "images")
        mb = sum(os.path.getsize(os.path.join(img_dir, f_)) for f_ in os.listdir(img_dir)) / 1e6
        rate = z_["images"] / max(a_s - hook[0], 1e-9)
        ok_a = len(diffs) == z_["images"] and max(diffs) <= GR_JPEG_MEAN_D
        log(f"phase 22 (a) synth_corpus --grounded: {z_['images']} JPEGs (500 x 375, q75) with "
            f"the {native.route()} encoder in {a_s:.3f} s in process ({hook[0]:.3f} s of it "
            f"decoding them back for the gate), {rate:.1f} images/s written, {mb:.2f} MB; "
            f"decoded back vs the rendered arrays: mean |d| per image {min(diffs):.4f}-"
            f"{max(diffs):.4f} (<= {GR_JPEG_MEAN_D}): {'ok' if ok_a else 'FAILED'}")
        if not ok_a:
            raise AssertionError("phase 22 (a): the corpus's JPEGs do not round-trip")
        out["corpus"] = {"s": a_s, "images_per_s": rate, "mb": mb, "route": native.route(),
                         "mean_d": [min(diffs), max(diffs)]}

        # (b) VGG-19 pretrain: the seeded encoder's report, then GR_STEPS steps.
        base = ["--vg-dir", corpus, "--image-dir", img_dir, "--image-size", str(S),
                "--batch-size", str(B), "--dtype", z_["dtype"], "--seed", str(SEED)] + dev_args

        def sync():
            if on_card:
                torch.cuda.synchronize()

        stepping = [False]  # inside a training step of the instrumented CLI

        def instrumented(rec, steps, timed_from, window=None):
            """The CLI's step, counted per step, its loss kept on the device,
            the device synchronized at the timed span's two ends and around
            the profiled window; the span leaves out the profiler's own
            start and export."""
            make = ptr.make_pretrain_step

            def wrapped(model, opt, *a, **k):
                step = make(model, opt, *a, **k)
                rec["model"] = model
                prof = (StepProfiler(os.path.join(root, "profile"), *window)
                        if window else None)

                def run(*sa, step_idx=0, **sk):
                    t_p = time.perf_counter()
                    if prof is not None:
                        prof.maybe_start(step_idx)
                    rec["aside"] += time.perf_counter() - t_p
                    if step_idx == timed_from:
                        sync()
                        rec["t0"], rec["aside"] = time.perf_counter(), 0.0
                    before = read_counts()
                    stepping[0] = True
                    try:
                        m_ = step(*sa, step_idx=step_idx, **sk)
                    finally:
                        stepping[0] = False
                    rec["loss"].append(m_["loss"])
                    after = read_counts()
                    rec["launches"].append({k_: after[k_] - before[k_] for k_ in after})
                    t_p = time.perf_counter()
                    if prof is not None and prof.maybe_stop(step_idx + 1):
                        rec["profile"] = prof.summary
                    rec["aside"] += time.perf_counter() - t_p
                    if step_idx == steps - 1:
                        sync()
                        rec["s_per_step"] = ((time.perf_counter() - rec["t0"] - rec["aside"])
                                             / (steps - timed_from))
                    return m_

                return run

            return wrapped

        def pretrain_run(label, out_dir, argv, steps, timed_from=0, window=None):
            rec = {"loss": [], "launches": [], "aside": 0.0}
            ptr_make = ptr.make_pretrain_step
            ptr.make_pretrain_step = instrumented(rec, steps, timed_from, window)
            peak_reset()
            printed = io.StringIO()
            try:
                with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
                    run_s, counts = run_cli(pretrain_cli.main, [
                        "--out-dir", out_dir, "--steps", str(steps)] + argv,
                        f"sgg_torch.cli.pretrain {label}")
            finally:
                ptr.make_pretrain_step = ptr_make
            with open(os.path.join(out_dir, "pretrain_meta.json")) as f:
                meta = json.load(f)
            n_tr, n_te = (int(v_) for v_ in re.search(
                r"(\d+) train / (\d+) held-out", printed.getvalue()).groups())
            rec.update(s=run_s, counts=counts, peak_gb=peak_gb(), meta=meta, held_images=n_te,
                       train_images=n_tr, loss=[float(v_) for v_ in rec["loss"]])
            add(counts)
            return rec

        seeded = pretrain_run("vgg19 seeded", seeded_dir, base, 0)
        n_w, steps = z_["window"], z_["steps"]
        vgg = pretrain_run("vgg19", enc_dir, base + ["--log-every", "50", "--encoder", "vgg19"],
                           steps, n_w, z_["profile"])
        s_step = vgg["s_per_step"]
        first, last = (float(np.mean(vgg["loss"][:n_w])), float(np.mean(vgg["loss"][-n_w:])))
        prof = vgg.get("profile") or {}
        held = vgg["meta"]["held_out"]
        n_held = vgg["train_images"]
        per_eval = vgg["counts"]["conv_direct"] / -(-vgg["held_images"] // B)
        ok_b = (last < first and all(math.isfinite(v_) for v_ in vgg["loss"])
                and len(vgg["loss"]) == steps and not any(
                    sum(c_.values()) for c_ in vgg["launches"])
                and (not on_card or per_eval == 16))
        log(f"phase 22 (b) pretrain vgg19 ({n_held} train images, {S} px, batch {B}, "
            f"{z_['dtype']}, spatial {vgg['meta']['spatial']}): {steps} steps in "
            f"{vgg['s']:.3f} s in process (decode and held-out report included), "
            f"{s_step:.4f} s/step after step {n_w} ({B / s_step:.1f} images/s), peak "
            f"{vgg['peak_gb']:.3f} GB, profiled steps {prof.get('steps')}: idle share "
            f"{prof.get('idle_share')}, device busy {prof.get('device_busy_s')} s of "
            f"{prof.get('wall_s')} s, {prof.get('syncs')} host syncs; mean loss of the first "
            f"{n_w} steps {first:.4f}, of the last {n_w} {last:.4f} (last < first); launches "
            f"{vgg['counts']} ({per_eval:g} conv_direct a held-out batch, 16 expected; none in "
            f"the steps: the library conv); held-out, seeded {seeded['meta']['held_out']}, "
            f"trained {held}: {'ok' if ok_b else 'FAILED'}")
        for line in (prof.get("table") or "").splitlines()[:12]:
            log(f"profile pretrain vgg19: {line}")
        if not ok_b:
            raise AssertionError("phase 22 (b): pretraining did not lower the loss, or "
                                 "launched unexpectedly")
        out["pretrain"] = {"s_per_step": s_step, "images_per_s": B / s_step,
                           "peak_gb": vgg["peak_gb"], "idle": prof.get("idle_share"),
                           "first": first, "last": last, "held_out": held,
                           "seeded": seeded["meta"]["held_out"], "counts": vgg["counts"]}

        # (c) Holds: a float32 step card vs CPU and the plain loss; the MoE layer.
        store = recipe_store(corpus, GR_HOLD_BATCH, S,
                             vocab=Vocab.load(os.path.join(enc_dir, "vocab.json")))
        h_p = pretrain_hold(dev, store)
        h_t = conv_tf32_hold(dev, batch=B, size=S)
        h_m = moe_hold(dev, **z_["moe_hold"])
        if not (h_p["ok"] and h_t["ok"] and h_m["ok"]):
            raise AssertionError("phase 22 (c): a pretrain or MoE hold failed")
        out["holds"] = {"pretrain": h_p, "tf32": h_t,
                        "moe": {k_: v_ for k_, v_ in h_m.items() if k_ != "ok"}}

        # (d) ViT-B/16 with MoE blocks; the choices kept by every block of
        # every training step, counted on the device.
        kept, choices = [], [0]
        routing = moe.moe_routing

        def counting_routing(logits, top_k, capacity):
            combine, aux_ = routing(logits, top_k, capacity)
            if stepping[0]:
                kept.append((combine > 0).sum())
                choices[0] += logits.shape[0] * logits.shape[1] * top_k
            return combine, aux_

        moe.moe_routing = counting_routing
        try:
            vit = pretrain_run("vit_b16 moe", moe_dir, base + [
                "--log-every", "4", "--encoder", "vit_b16", "--moe-experts",
                str(z_["experts"]), "--moe-top-k", str(z_["top_k"]), "--vit-dims",
                z_["vit_dims"]], z_["moe_steps"], 1)
        finally:
            moe.moe_routing = routing
        dropped = 1.0 - float(torch.stack(kept).sum()) / max(choices[0], 1)
        layers = int(z_["vit_dims"].split(",")[1])
        with torch.no_grad():
            imgs = torch.from_numpy(store[0][:GR_HOLD_BATCH]).to(dev)
            _, aux = vit["model"].forward_aux(imgs)
        s_moe = vit["s_per_step"]
        want_step = {"flash_attention": layers, "flash_attention_bwd_dq": layers,
                     "flash_attention_bwd_dkv": layers}
        per_step_ok = all(all(c_[k_] == v_ for k_, v_ in want_step.items())
                          for c_ in vit["launches"]) or not on_card
        ok_d = (per_step_ok and len(vit["loss"]) == z_["moe_steps"]
                and all(math.isfinite(v_) for v_ in vit["loss"]) and math.isfinite(float(aux)))
        log(f"phase 22 (d) pretrain vit_b16 {z_['vit_dims']} with {z_['experts']} experts, "
            f"top-{z_['top_k']} (batch {B}, {z_['dtype']}): {z_['moe_steps']} steps in "
            f"{vit['s']:.3f} s in process, {s_moe:.4f} s/step after the first, peak "
            f"{vit['peak_gb']:.3f} GB; losses {[round(v_, 4) for v_ in vit['loss']]}; aux "
            f"{float(aux):.6f} (the trained model on {GR_HOLD_BATCH} corpus images); "
            f"{dropped:.4f} of the {choices[0]} choices of the {z_['moe_steps']} training "
            f"steps' batches dropped by capacity (every block); launches per step "
            f"{vit['launches'][0] if vit['launches'] else None} (expected {want_step} each), "
            f"in all {vit['counts']}; held-out {vit['meta']['held_out']}: "
            f"{'ok' if ok_d else 'FAILED'}")
        if not ok_d:
            raise AssertionError("phase 22 (d): the MoE ViT pretrain failed or missed a kernel")
        out["moe"] = {"s_per_step": s_moe, "peak_gb": vit["peak_gb"], "aux": float(aux),
                      "dropped": dropped, "counts": vit["counts"]}
        del vit

        # (e) The rest of the recipe: extraction through the trained encoder,
        # vg1k on its shards, evaluate on fused_decode.
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            pp_s, pp_counts = run_cli(preprocess_cli.main, [
                "--out-dir", shards, "--vg-dir", corpus, "--image-dir", img_dir,
                "--encoder", "vgg19", "--encoder-ckpt", enc_dir, "--batch-size", str(B),
                "--feat-dtype", "float16", "--compute-dtype", z_["dtype"]] + dev_args,
                "sgg_torch.cli.preprocess --encoder-ckpt")
        add(pp_counts)
        stats = [ast.literal_eval(ln.split(": ", 1)[1])
                 for ln in printed.getvalue().splitlines()
                 if ln.startswith(("[sgg.preprocess] train: ", "[sgg.preprocess] test: "))]
        batches = sum(-(-s_["num_images"] // B) for s_ in stats)
        per_batch = pp_counts["conv_direct"] / max(batches, 1)
        log_every = max(1, z_["train_steps"] // 4)
        sets = {"data.source": "shards", "data.data_dir": shards,
                "model.compute_dtype": "bfloat16", "train.batch_size": 256,
                "train.log_every": log_every, **(extra_sets or {})}
        argv = ["--config", "vg1k", "--workdir", wd, "--steps", str(z_["train_steps"])]
        for k_, v_ in sets.items():
            argv += ["--set", f"{k_}={v_}"]
        tr_s, tr_counts = run_cli(train_cli.main, argv + dev_args, "sgg_torch.cli.train vg1k")
        add(tr_counts)
        lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            ev_s, ev_counts = run_cli(evaluate_cli.main, [
                "--workdir", wd, "--decode", "fused", "--k", "20,50,100", "--json-out",
                os.path.join(root, "eval.json")] + dev_args, "sgg_torch.cli.evaluate vg1k")
        add(ev_counts)
        with open(os.path.join(root, "eval.json")) as f:
            ev = json.load(f)
        ok_e = (len(stats) == 2 and (per_batch == 16 or not on_card)
                and len(lines) == z_["train_steps"] // log_every and not any(tr_counts.values())
                and all(math.isfinite(r_["d_loss"]) for r_ in lines)
                and (ev_counts["fused_decode"] > 0 or not on_card))
        log(f"phase 22 (e) preprocess --encoder-ckpt (the pretrained VGG-19, {z_['dtype']}): "
            + "; ".join(f"{'train' if j_ == 0 else 'test'} {s_['num_images']} images at "
                        f"{s_['images_per_sec']} images/s" for j_, s_ in enumerate(stats))
            + f", {pp_s:.3f} s in process, conv_direct {pp_counts['conv_direct']} over "
            f"{batches} batches ({per_batch:g} a batch, 16 expected); train vg1k on its shards "
            f"{z_['train_steps']} steps in {tr_s:.3f} s in process, last "
            f"{1 / lines[-1]['steps_per_sec']:.4f} s/step, losses d "
            f"{lines[-1]['d_loss']:.4f} g {lines[-1]['g_loss']:.4f}, launches {tr_counts} "
            f"(none expected); evaluate --decode fused {ev_s:.3f} s, launches {ev_counts}, "
            f"recall {ev['combos'][0]['recall']}: {'ok' if ok_e else 'FAILED'}")
        if not ok_e:
            raise AssertionError("phase 22 (e): extraction, training or evaluation failed")
        out["rest"] = {"stats": stats, "per_batch": per_batch, "train_s": tr_s,
                       "s_per_step": 1 / lines[-1]["steps_per_sec"], "eval_s": ev_s,
                       "recall": ev["combos"][0]["recall"]}
    out["launches"] = launches
    return out


def int8_shapes(name, S, B, vit_dims=(768, 12, 12)):
    """The distinct int8 products of encoder ``name`` at S px, batch B: for
    a CNN each conv's (x shape, w shape, stride, padding), recorded by
    running the int8 encoder on the meta device; for the ViT each projection's
    ([rows, K], [K, N])."""
    import torch

    from sgg_torch.kernels import conv as conv_route
    from sgg_torch.models.encoders import make_encoder

    if name == "vit_b16":
        rows, (E, _, _) = B * (S // 16) ** 2, vit_dims
        return [((rows, E), (E, 3 * E)), ((rows, E), (E, E)), ((rows, E), (E, 4 * E)),
                ((rows, 4 * E), (4 * E, E))]
    seen, inner = [], conv_route.conv2d_int8

    def record(x, w, bias=None, scale=None, stride=1, padding="SAME", relu=True):
        key = (tuple(x.shape), tuple(w.shape), stride, padding)
        if key not in seen:
            seen.append(key)
        return inner(x, w, bias=bias, scale=scale, stride=stride, padding=padding, relu=relu)

    conv_route.conv2d_int8 = record
    try:
        with torch.device("meta"), torch.no_grad():
            make_encoder(name, quant="int8", dtype=torch.bfloat16)(
                torch.zeros(B, S, S, 3, dtype=torch.bfloat16))
    finally:
        conv_route.conv2d_int8 = inner
    return seen


def int8_holds(dev, smi, shapes_by_name, time_fn, seed=SEED):
    """Phase 23 (a): at every distinct int8 product of the encoders
    (``int8_shapes``), bfloat16 operands from ``seed``, the card's route
    (``torch._int_mm``, padded, int8 im2col) against the plain route (float64
    sums) bit for bit, and its time (``time_fn``, ms on the device's clock)
    beside the bfloat16 route of the same shape: ``conv2d_fused``'s
    ``'auto'`` (conv_direct for 3x3 stride 1, fused_matmul for 1x1, else the
    library conv) or ``torch.matmul``. Returns the rows; raises if a hold
    fails."""
    import torch

    from sgg_torch.kernels import quant
    from sgg_torch.kernels.conv import conv2d_fused

    g = torch.Generator(device=dev).manual_seed(seed)
    rows, ok = [], True
    for name, shapes in shapes_by_name.items():
        for shape in shapes:
            if name == "vit_b16":
                (M, K_), (_, N) = shape
                x = torch.randn(M, K_, generator=g, device=dev).to(torch.bfloat16)
                w = (torch.randn(K_, N, generator=g, device=dev) / K_ ** 0.5).to(torch.bfloat16)
                fast = quant.int8_linear(x, w, impl="int_mm")
                equal = torch.equal(fast, quant.int8_linear(x, w, impl="plain"))
                int8_ms = time_fn(lambda: quant.int8_linear(x, w, impl="int_mm"))
                bf16_ms, route = time_fn(lambda: torch.matmul(x, w)), "torch.matmul"
                label = f"[{M}, {K_}] @ [{K_}, {N}]"
            else:
                xs, ws, stride, padding = shape
                x = torch.randn(xs, generator=g, device=dev).to(torch.bfloat16)
                fan = ws[0] * ws[1] * ws[2]
                w = (torch.randn(ws, generator=g, device=dev) * (2 / fan) ** 0.5).to(
                    torch.bfloat16)
                bias = 0.1 * torch.randn(ws[3], generator=g, device=dev)
                scale = 0.5 + torch.rand(ws[3], generator=g, device=dev)
                kw = dict(bias=bias, scale=scale, stride=stride, padding=padding)
                fast = quant.conv2d_int8(x, w, impl="int_mm", **kw)
                equal = torch.equal(fast, quant.conv2d_int8(x, w, impl="plain", **kw))
                int8_ms = time_fn(lambda: quant.conv2d_int8(x, w, **kw))
                bf16_ms = time_fn(lambda: conv2d_fused(x, w, impl="auto", **kw))
                route = ("fused_matmul" if ws[0] == ws[1] == 1 else
                         "conv_direct" if stride == 1 and padding == "SAME" else "library conv")
                label = f"x {list(xs)} w {list(ws)} stride {stride} {padding}"
            ok &= bool(equal) and bool(torch.isfinite(fast.float()).all())
            rows.append({"encoder": name, "shape": label, "equal": bool(equal),
                         "int8_ms": int8_ms, "bf16_ms": bf16_ms, "bf16_route": route})
            log(f"phase 23 (a) int8 {name} {label}: _int_mm vs plain (float64) bit for bit "
                f"{bool(equal)}; int8 {int8_ms:.4f} ms, bf16 {route} {bf16_ms:.4f} ms "
                f"({bf16_ms / int8_ms:.2f}x), device clock [{smi}]")
    if not ok:
        raise AssertionError("phase 23 (a): the int8 route disagrees with its plain version")
    return rows


def deployment_phase(dev, smi, pix, vit, vgg_state, v1k, run_cli, read_counts, time_fn,
                     sizes=None):
    """Phase 23, the deployment tier: (a) ``int8_holds`` at every distinct
    int8 conv of ResNet-50 and VGG-19 and the ViT-B/16 projections, at S px,
    batch B; (b) each encoder int8 against float (library route, float32) on
    seeded weights and S px images: per-region cosine median > 0.99 (VGG-19 >
    0.98), the reference's contract (tests/unit/test_quant.py); (c)
    ``generate --quant int8`` and ``--quant none`` on a resnet50 workdir
    (``pix`` = (cfg, vocab, generator state_dict, encoder state_dict);
    ``--decode fused``) and a vit_b16 one (``vit``; ``--decode xla``):
    images/s and exact launch counts (int8: fused_decode, flash_attention, no
    conv kernel), then one images request to ``InferenceEngine(quant='int8')``
    over HTTP, its features equal to ``make_image_encoder``'s; (d)
    ``cli.export --check`` on a vg1k workdir (``v1k`` = (cfg, vocab),
    features in) and on (c)'s resnet50 workdir (``--with-encoder --quant int8``),
    an ``ArtifactEngine`` on the latter answering one images request over
    HTTP with no hand-written kernel launched, and the vg1k artifact loaded and
    called in a subprocess that imports neither sgg_torch nor jax, its tokens
    equal to the live sampler's on the same noise. ``time_fn`` gives ms on the device's clock;
    ``sizes`` shrinks the phase for a dry run on the CPU, where no kernel
    launches and the counts are not held. Returns the numbers, with
    ``launches``: the int8 generate runs' launches per kernel."""
    import math
    import subprocess

    import numpy as np
    import torch

    from sgg_torch.cli import export as export_cli
    from sgg_torch.cli import generate
    from sgg_torch.eval.sampler import draw_noise, make_sampler
    from sgg_torch.models.encoders import make_encoder, make_image_encoder, normalize_for
    from sgg_torch.serve import ArtifactEngine, InferenceEngine, encode_binary_request
    from sgg_torch.train.checkpoint import save_generator
    from sgg_torch.train.state import make_generator

    pix_cfg, pix_vocab, pix_g, pix_enc = pix
    vit_cfg, vit_vocab, vit_g, vit_enc = vit
    z_ = {"batch": PIX_BATCH, "cos_images": 8, "draws": K, "images": PIX_IMAGES,
          "vit_images": VIT_IMAGES, "vit_batch": VIT_BATCH, "request": 8, **(sizes or {})}
    B, Kd = z_["batch"], z_["draws"]
    S = pix_cfg.data.image_size
    on_card = torch.device(dev).type == "cuda"
    dev_args = [] if on_card else ["--device", "cpu"]
    launches = dict.fromkeys(read_counts(), 0)
    out = {}

    # (a) The int8 products at full width, the card's route against plain.
    t_a = time.perf_counter()
    shapes = {"resnet50": int8_shapes("resnet50", S, B), "vgg19": int8_shapes("vgg19", S, B),
              "vit_b16": int8_shapes("vit_b16", vit_cfg.data.image_size, B,
                                     vit_cfg.model.vit_dims)}
    out["holds"] = int8_holds(dev, smi, shapes, time_fn)
    log(f"phase 23 (a): {len(out['holds'])} int8 shapes held bit for bit in "
        f"{time.perf_counter() - t_a:.3f} s [{smi}]")

    # (b) Each encoder int8 against float.
    t_b = time.perf_counter()
    imgs = torch.from_numpy(np.random.RandomState(SEED + 40).randint(
        0, 256, (z_["cos_images"], S, S, 3), dtype=np.uint8)).to(dev)
    out["cosine"] = {}
    for name, state, cfg_ in (("resnet50", pix_enc, pix_cfg), ("vgg19", vgg_state, pix_cfg),
                              ("vit_b16", vit_enc, vit_cfg)):
        kw = dict(image_size=cfg_.data.image_size, vit_dims=cfg_.model.vit_dims)
        feats = {}
        for q in ("", "int8"):
            enc = make_encoder(name, quant=q, **kw)
            enc.load_state_dict(state)
            with torch.no_grad():
                feats[q] = enc.to(dev)(normalize_for(name, imgs)).float()
            del enc
        a_, b_ = feats["int8"], feats[""]
        cos = (a_ * b_).sum(-1) / (a_.norm(dim=-1) * b_.norm(dim=-1) + 1e-12)
        med, floor = cos.median().item(), 0.98 if name == "vgg19" else 0.99
        out["cosine"][name] = med
        log(f"phase 23 (b) {name} int8 vs float32 (library route, {z_['cos_images']} images at "
            f"{S} px): per-region cosine median {med:.5f} (> {floor}), min {cos.min().item():.5f} "
            f"[{smi}]")
        if not med > floor:
            raise AssertionError(f"phase 23 (b): {name} int8 misses the cosine contract")
    log(f"phase 23 (b): {time.perf_counter() - t_b:.3f} s [{smi}]")

    with tempfile.TemporaryDirectory() as root:
        # (c) generate --quant int8 and none on the resnet50 and vit_b16 workdirs.
        t_c = time.perf_counter()
        out["generate"] = {}
        runs = (("resnet50", pix_cfg, pix_vocab, pix_g, pix_enc, "fused", z_["images"], B),
                ("vit_b16", vit_cfg, vit_vocab, vit_g, vit_enc, "xla", z_["vit_images"],
                 z_["vit_batch"]))
        wds = {}
        for name, cfg_, vocab_, g_, enc_, decode, n_img, bs in runs:
            wd = wds[name] = os.path.join(root, name)
            os.makedirs(wd)
            cfg_.workdir = wd
            cfg_.data.num_synthetic_images = n_img
            with open(os.path.join(wd, "config.json"), "w") as f:
                f.write(cfg_.to_json())
            vocab_.save(os.path.join(wd, "vocab.json"))
            save_generator(wd, g_, step=1, enc_params=enc_)
            n_b = math.ceil(n_img / bs)
            for q in ("int8", "none"):
                gpath = os.path.join(wd, f"graphs_{q}.json")
                run_s, counts = run_cli(generate.main, [
                    "--workdir", wd, "--out", gpath, "--num-samples", str(Kd), "--decode",
                    decode, "--batch-size", str(bs), "--quant", q, "--seed", str(SEED),
                    *dev_args], f"sgg_torch.cli.generate {name} --quant {q}")
                with open(gpath) as f:
                    graphs = json.load(f)["scene_graphs"]
                if len(graphs) != n_img:
                    raise AssertionError(f"phase 23 (c): {name} --quant {q}: {len(graphs)} "
                                         "graphs")
                legal_graphs(graphs, vocab_, Kd, f"generate {name} --quant {q}")
                want = dict.fromkeys(counts, 0)
                if name == "resnet50":
                    want["fused_decode"] = n_b * Kd
                    if q == "none":
                        want["fused_matmul"], want["conv_direct"] = n_b * 36, n_b * 13
                else:
                    want["flash_attention"] = n_b * cfg_.model.vit_layers
                out["generate"][(name, q)] = {"s": run_s, "images_per_s": n_img / run_s,
                                              "launches": counts}
                log(f"phase 23 (c) generate {name} --quant {q} --decode {decode}: {n_img} images "
                    f"in {run_s:.3f} s in process, {n_img / run_s:.1f} images/s including "
                    f"set-up, launches {counts} (expected {want}) [{smi}]")
                if on_card and counts != want:
                    raise AssertionError(f"phase 23 (c): generate {name} --quant {q} launches")
                if q == "int8":
                    for k_, v_ in counts.items():
                        launches[k_] += v_
        for name in ("resnet50", "vit_b16"):
            i8, fl = (out["generate"][(name, q)]["images_per_s"] for q in ("int8", "none"))
            log(f"phase 23 (c) {name}: int8 {i8:.1f} images/s against float {fl:.1f} "
                f"({i8 / fl:.2f}x) [{smi}]")

        # One images request to serve --quant int8 (the engine behind the CLI).
        n_req = z_["request"]
        req = np.random.RandomState(SEED + 41).randint(0, 256, (n_req, S, S, 3), dtype=np.uint8)
        eng = InferenceEngine.from_workdir(wds["resnet50"], device=dev, batch_size=B,
                                           num_samples=Kd, quant="int8", rank="freq")
        eng.warmup()
        with served(eng) as (url, _):
            status, body = http(url + "/v1/generate", encode_binary_request(req),
                                "application/octet-stream")
        if status != 200 or len(body["scene_graphs"]) != n_req:
            raise AssertionError(f"phase 23 (c): serve --quant int8 answered {status}")
        legal_graphs(body["scene_graphs"], pix_vocab, Kd, "serve --quant int8")
        # Activations take one scale per tensor, so an image's int8 features
        # depend on its batch: the engine's padded batch is encoded alike.
        padded = np.concatenate([req, np.zeros((B - n_req, S, S, 3), np.uint8)])
        want_f = make_image_encoder(eng.cfg, pix_enc, torch.device(dev), quant="int8")(
            torch.from_numpy(padded).to(dev))[:n_req]
        same = torch.equal(eng.encode_images(req), want_f)
        log(f"phase 23 (c) serve --quant int8: one request of {n_req} images, 200, "
            f"{body['latency_ms']} ms; features equal make_image_encoder(quant='int8')'s on "
            f"the same padded batch bit for bit {same} [{smi}]")
        if not same:
            raise AssertionError("phase 23 (c): the int8 engine's features differ")
        del eng
        out["c_s"] = time.perf_counter() - t_c

        # (d) Export: features in (vg1k), pixels in (resnet50 int8), both checked.
        t_d = time.perf_counter()
        v1k_cfg, v1k_vocab = v1k
        vwd = os.path.join(root, "vg1k")
        os.makedirs(vwd)
        v1k_cfg.workdir = vwd
        with open(os.path.join(vwd, "config.json"), "w") as f:
            f.write(v1k_cfg.to_json())
        v1k_vocab.save(os.path.join(vwd, "vocab.json"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED + 42)
            v1k_g = make_generator(v1k_cfg).state_dict()
        save_generator(vwd, v1k_g, step=3)
        out["export"] = {}
        arts = {}
        for what, wd, extra in (
                ("vg1k features in", vwd, []),
                ("resnet50 int8 pixels in", wds["resnet50"],
                 ["--with-encoder", "--quant", "int8"])):
            art = arts[what] = os.path.join(root, what.split()[0] + ".pt2")
            run_s, counts = run_cli(export_cli.main, [
                "--workdir", wd, "--out", art, "--num-samples", str(Kd), "--batch-size",
                str(B), "--check", *extra, *dev_args], f"sgg_torch.cli.export {what}")
            out["export"][what] = {"s": run_s, "mb": os.path.getsize(art) / 1e6}
            log(f"phase 23 (d) cli.export --check {what} (K {Kd}, B {B}): exit 0 in {run_s:.3f} "
                f"s (trace, save, load, check), {os.path.getsize(art) / 1e6:.1f} MB, launches "
                f"{counts} [{smi}]")
        eng = ArtifactEngine(art, device=dev, seed=SEED, batch_size=B)
        warm = eng.warmup()
        counts_before = read_counts()
        with served(eng) as (url, _):
            t_r = time.perf_counter()
            status, body = http(url + "/v1/generate", encode_binary_request(req),
                                "application/octet-stream")
            req_s = time.perf_counter() - t_r
        if on_card:
            torch.cuda.synchronize()
        counts_art = {k_: read_counts()[k_] - v_ for k_, v_ in counts_before.items()}
        if status != 200 or len(body["scene_graphs"]) != n_req:
            raise AssertionError(f"phase 23 (d): serve --artifact answered {status}")
        legal_graphs(body["scene_graphs"], pix_vocab, Kd, "serve --artifact")
        log(f"phase 23 (d) serve --artifact (resnet50 int8): warmup {warm:.3f} s, one request "
            f"of {n_req} images, 200 in {req_s * 1e3:.1f} ms; hand-written kernel launches "
            f"{counts_art} (the artifact launches none) [{smi}]")
        if any(counts_art.values()):
            raise AssertionError("phase 23 (d): the artifact launched a hand-written kernel")

        # The features-in artifact alone, in a process without sgg_torch or
        # jax, against the live sampler on the same noise.
        del eng
        art = arts["vg1k features in"]
        x = torch.randn(B, v1k_cfg.data.regions, v1k_cfg.data.feat_dim,
                        generator=torch.Generator().manual_seed(SEED + 43)).to(v1k_cfg.model.dtype)
        noise = draw_noise(torch.Generator(device=dev).manual_seed(SEED + 43), Kd, B,
                           v1k_cfg.model.noise_dim, v1k_cfg.model.vocab_size, v1k_cfg.model.dtype,
                           dev)
        want = make_sampler(v1k_cfg, step_mask=v1k_vocab.step_mask(), num_samples=Kd)(
            {k_: v_.to(dev) for k_, v_ in v1k_g.items()}, x.to(dev), noise=noise).cpu()
        io = os.path.join(root, "io.pt")
        torch.save({"x": x.cpu(), "z": noise[0].cpu(), "gumbel": noise[1].cpu()}, io)
        code = (
            "import json, sys, torch\n"
            f"path, io, dev = {art!r}, {io!r}, {str(dev)!r}\n"
            "extra = {'meta.json': ''}\n"
            "ep = torch.export.load(path, extra_files=extra)\n"
            "meta = json.loads(extra['meta.json'])\n"
            "if dev != 'cpu':\n"
            "    from torch.export.passes import move_to_device_pass\n"
            "    ep = move_to_device_pass(ep, dev)\n"
            "a = torch.load(io)\n"
            "with torch.no_grad():\n"
            "    t = ep.module()(a['x'].to(dev), a['z'].to(dev), a['gumbel'].to(dev))\n"
            "torch.save(t.cpu(), io + '.out')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('sgg_torch', 'sgg', 'jax'))\n"
            "print(json.dumps({'bad': bad, 'K': meta['num_samples']}))\n")
        env = {k_: v_ for k_, v_ in os.environ.items() if k_ != "PYTHONPATH"}
        t_s = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                              capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t_s
        if proc.returncode != 0:
            raise AssertionError(f"phase 23 (d): the bare artifact failed: {proc.stderr[-2000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        same = torch.equal(torch.load(io + ".out"), want)
        log(f"phase 23 (d) the vg1k artifact in a bare process (torch only; modules of "
            f"sgg_torch, sgg or jax imported: {report['bad']}): {sub_s:.3f} s, tokens equal "
            f"the live sampler's on the same noise bit for bit {same} [{smi}]")
        if report["bad"] or not same:
            raise AssertionError("phase 23 (d): the bare artifact disagrees or imported the port")
        out["d_s"] = time.perf_counter() - t_d
    out["launches"] = launches
    return out


def kernel_counts():
    """The launch count of every kernel wrapper in this process."""
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import flash_attention as fa
    from sgg_torch.kernels import flash_attention_bwd as fb
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.kernels import matmul as mm

    return {"fused_decode": fd.launches, "fused_matmul": mm.launches,
            "conv_direct": cd.launches, "flash_attention": fa.launches,
            "flash_attention_bwd_dq": fb.dq_launches, "flash_attention_bwd_dkv": fb.dkv_launches}


def digest(tensors):
    """sha256 of each tensor's bytes (any dtype, on any device)."""
    import hashlib

    import torch

    return [hashlib.sha256(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
                           .numpy().tobytes()).hexdigest() for t in tensors]


def tree_tensors(tree):
    """Every tensor of a nested dict or list (a state_dict), dicts in key
    order."""
    import torch

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t_ for k_ in sorted(tree) for t_ in tree_tensors(tree[k_])]
    if isinstance(tree, (list, tuple)):
        return [t_ for v_ in tree for t_ in tree_tensors(v_)]
    return []


def rank_run(args):
    """Phase 24's rank: ``chip_smoke.py --rank-run OUT ROOT WINDOW -- <train
    argv>``, under torchrun (one process per rank) or alone. Runs
    ``sgg_torch.cli.train.main(argv)`` from the port under ROOT with the
    kernel launches counted per step, the first step's noise (the step's own
    ``inputs``) and the state taken as they are, and the profile window
    (``--profile``) moved to WINDOW = ``first,steps``; then, across ranks,
    times ``pmean`` at each of a step's distinct bucket sizes (one warm call,
    then 3, synchronized) and sums them over the step's buckets; records the
    seconds from its start to its milestones. Writes ``OUT/rank<r>.json``:
    exit code, world, backend, device, launches per step, noise and state
    digests (sha256 of every
    tensor of ``state.tensors()``), the step's buckets and the all-reduce's
    ms a step, the peak device memory and the state's bytes on the rank; for
    a state placed over a mesh (phases 26-28) the digests of the global
    state that every rank gathers (its last checkpoint's, as the CLI
    gathered it) in place of its own. With ``SGG_SMOKE_FIRST`` set (phases 26 and 27)
    it also saves the first step's batch (this rank's rows) and noise to
    ``OUT/first_rank<r>.pt`` and times every collective of the sharding and
    sequence-parallel tiers on the host clock, synchronized around each
    call, per step, in all and by collective; with ``SGG_SMOKE_ACT`` (phase
    27) it records ``sp_saved_bytes`` after the run; with ``SGG_SMOKE_MOE``
    (phase 28) the share of the expert-parallel MoE layers' routing choices
    that their capacity dropped over the run. Returns the CLI's exit code."""
    t_start = time.time()
    out, root, window = args[0], args[1], args[2]
    argv = args[args.index("--") + 1:]
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    import sgg_torch.train.step as step_mod
    from sgg_torch.cli import train as train_cli
    from sgg_torch.utils.profiling import StepProfiler

    if not step_mod.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"chip_smoke: imported {step_mod.__file__}, not the port under {root}")
    import sgg_torch.dist.multihost as mh
    from sgg_torch.dist.sharding import gather_state, state_bytes

    rec = {"per_step": [], "noise": None, "buckets": [], "t": {"imports": time.time() - t_start},
           "coll_ms": [], "coll_by": []}
    held = {}
    make, create, pmean = train_cli.make_step_fn, train_cli.create_train_state, step_mod.pmean
    first_out = os.environ.get("SGG_SMOKE_FIRST")
    coll = {"ms": 0.0, "by": {}}

    def rank_of():
        return dist.get_rank() if dist.is_initialized() else 0

    def timed(fn, name_=None):
        name_ = name_ or fn.__name__

        @functools.wraps(fn)
        def run(*a, **k):
            on = torch.cuda.is_available()
            if on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r_ = fn(*a, **k)
            if on:
                torch.cuda.synchronize()
            ms_ = (time.perf_counter() - t0) * 1e3
            coll["ms"] += ms_
            coll["by"][name_] = coll["by"].get(name_, 0.0) + ms_
            return r_

        return run

    if first_out:
        for name_ in ("gather_tensor", "scatter_mean_tensor", "sum_tensor", "pmean",
                      "shift_tensors", "all_to_all_tensor", "broadcast_tensor"):
            setattr(mh, name_, timed(getattr(mh, name_)))
    moe_count = {"kept": [], "choices": 0}
    if os.environ.get("SGG_SMOKE_MOE"):  # the EP layers' routing choices, kept and made
        import sgg_torch.dist.expert_parallel as ep_mod

        routing = ep_mod.moe_routing

        def counting_routing(logits, top_k, capacity):
            combine, aux_ = routing(logits, top_k, capacity)
            moe_count["kept"].append((combine > 0).sum())
            moe_count["choices"] += logits.shape[0] * logits.shape[1] * top_k
            return combine, aux_

        ep_mod.moe_routing = counting_routing

    def counting(cfg_, step_mask=None, **kw):
        held["cfg"] = cfg_
        fn = make(cfg_, step_mask, **kw)

        @functools.wraps(fn)
        def counted(state, batch, *a, **k):
            if rec["noise"] is None:
                x_ = batch["features" if "features" in batch else "images"]
                nz = fn.inputs(state.step, x_.shape[1], x_.device)
                rec["noise"] = digest([nz[n_] for n_ in sorted(nz)])
                if first_out:
                    torch.save({"batch": {k_: v_.cpu() for k_, v_ in batch.items()},
                                "noise": {k_: v_.cpu() for k_, v_ in nz.items()}},
                               os.path.join(out, f"first_rank{rank_of()}.pt"))
            before, n_buckets = kernel_counts(), len(rec["buckets"])
            rec["t"].setdefault("first_step_start", time.time() - t_start)
            coll["ms"], coll["by"] = 0.0, {}
            r_ = fn(state, batch, *a, **k)
            rec["coll_ms"].append(coll["ms"])
            rec["coll_by"].append(dict(coll["by"]))
            after = kernel_counts()
            rec["t"].setdefault("first_step_end", time.time() - t_start)
            rec["per_step"].append({k_: after[k_] - before[k_] for k_ in after})
            rec["step_buckets"] = rec["buckets"][n_buckets:]
            return r_

        return counted

    def creating(*a, **k):
        held["state"] = create(*a, **k)
        return held["state"]

    gather = train_cli.gather_state

    def gathering(state_):  # the CLI's save gathers the global state: keep the last
        held["gathered"] = gather(state_)
        return held["gathered"]

    def bucketed(tensors, group=None):
        tensors = list(tensors)
        rec["buckets"].append(sum(t_.numel() for t_ in tensors))
        return pmean(tensors, group)

    first, n_win = (int(v_) for v_ in window.split(","))
    train_cli.make_step_fn, train_cli.create_train_state = counting, creating
    train_cli.gather_state = gathering
    step_mod.pmean = timed(bucketed, "pmean") if first_out else bucketed
    train_cli.StepProfiler = lambda logdir, start_step: StepProfiler(
        logdir, start_step - 10 + first, num_steps=n_win)
    rc = train_cli.main(argv)
    rec["t"]["main"] = time.time() - t_start
    on = dist.is_available() and dist.is_initialized()
    state = held["state"]
    dev = state.tensors()[0].device
    ms = 0.0
    if on:  # each distinct bucket size: one warm call, then 3 timed
        sizes = rec.get("step_buckets", [])
        for n_ in sorted(set(sizes)):
            x_ = torch.randn(n_, device=dev)
            pmean([x_])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                pmean([x_])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms += (time.perf_counter() - t0) * 1e3 / 3 * sizes.count(n_)
        rec["t"]["allreduce_timing"] = time.time() - t_start
    rank = dist.get_rank() if on else 0
    if moe_count["kept"]:
        rec["moe_dropped"] = 1.0 - float(torch.stack(moe_count["kept"]).sum()) / \
            moe_count["choices"]
    if os.environ.get("SGG_SMOKE_ACT") and state.placement is not None:
        rec["saved_bytes"] = sp_saved_bytes(held["cfg"], state)
        rec["t"]["saved_bytes"] = time.time() - t_start
    if state.placement is not None and not os.environ.get("SGG_SMOKE_NO_DIGESTS"):
        # The CLI's last save gathered the final state; gathered anew if none.
        sd_ = held.pop("gathered", None)
        sd_ = gather_state(state) if sd_ is None or sd_["step"] != state.step else sd_
        rec["global_digests"] = digest(tree_tensors(sd_))
        del sd_
    held.pop("gathered", None)
    rec["state_bytes"] = state_bytes(state)
    rec["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
                      else None)
    rec.update({"rc": rc, "rank": rank, "world": dist.get_world_size() if on else 1,
                "backend": dist.get_backend() if on else None, "device": str(dev),
                "allreduce_ms_step": ms, "step": state.step,
                "digests": (None if os.environ.get("SGG_SMOKE_NO_DIGESTS")
                            or state.placement is not None else digest(state.tensors()))})
    rec["t"]["digests"] = time.time() - t_start
    rec.pop("buckets")
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if on:
        dist.barrier()
        dist.destroy_process_group()
    return rc


def dp_launch(out, train_argv, nproc=None, root=ROOT, window=(3, 1), timeout=600,
              torchrun=True, env_extra=None, entry=None):
    """Run ``rank_run`` over ``nproc`` ranks and return each rank's record:
    under torchrun, or with ``torchrun=False`` one process per rank started
    here with the environment torchrun gives its ranks (RANK, LOCAL_RANK,
    WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT; no launcher's
    start-up); ``nproc`` None: one plain process. ``entry``: this script's
    arguments for another rank function that writes ``OUT/rank<r>.json``
    (phase 27's ``--sp-attention-run``). Raises if a rank or the launcher
    fails."""
    import socket

    os.makedirs(out, exist_ok=True)
    me = [os.path.abspath(__file__), *(entry or ["--rank-run", out, root,
                                                 f"{window[0]},{window[1]}", "--", *train_argv])]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root, **(env_extra or {}))
    if nproc and torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--standalone",
                  "--nproc_per_node", str(nproc)] + me, env)]
    elif nproc:
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        cmds = [([sys.executable] + me, dict(
            env, RANK=str(r_), LOCAL_RANK=str(r_), WORLD_SIZE=str(nproc),
            LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
            for r_ in range(nproc)]
    else:
        cmds = [([sys.executable] + me, env)]
    rcs, deadline = [], time.time() + timeout
    with open(os.path.join(out, "log.txt"), "w") as log_f:
        procs = [subprocess.Popen(c_, stdout=log_f, stderr=subprocess.STDOUT, env=e_,
                                  start_new_session=True) for c_, e_ in cmds]
        try:
            for p_ in procs:
                rcs.append(p_.wait(timeout=max(1.0, deadline - time.time())))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
        finally:
            for p_ in procs:  # each launcher or rank, with what it started
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p_.pid, signal.SIGKILL)
                p_.wait()
    with open(os.path.join(out, "log.txt")) as f:
        text = f.read()
    if any(rc_ != 0 for rc_ in rcs):
        raise AssertionError(f"{' '.join(cmds[0][0][:6])}... exit {rcs}:\n{text[-4000:]}")
    recs = []
    for r_ in range(nproc or 1):
        with open(os.path.join(out, f"rank{r_}.json")) as f:
            recs.append(json.load(f))
    return recs, text


def dp_holds(ranks, plain, want_step=None):
    """Phase 24's holds on a data-parallel run's rank records against a
    plain run's: every rank's state equal bit for bit, the ranks' noise
    distinct (each rank folds its index in), rank 0's noise the plain
    run's, each rank's launches per step equal to ``want_step`` (when
    given). Returns (ok, what failed)."""
    bad = []
    if any(r_["digests"] != ranks[0]["digests"] for r_ in ranks):
        n_ = sum(a_ != b_ for a_, b_ in zip(ranks[0]["digests"], ranks[-1]["digests"]))
        bad.append(f"the ranks' states differ ({n_} of {len(ranks[0]['digests'])} tensors)")
    if len({tuple(r_["noise"]) for r_ in ranks}) != len(ranks):
        bad.append("two ranks drew the same noise")
    if plain is not None and ranks[0]["noise"] != plain["noise"]:
        bad.append("rank 0's noise is not the single-process step's")
    if want_step is not None and any(
            [{k_: v_ for k_, v_ in c_.items() if v_} for c_ in r_["per_step"]]
            != [want_step] * len(r_["per_step"]) for r_ in ranks):
        bad.append(f"launches {[r_['per_step'][:2] for r_ in ranks]} (expected {want_step} a "
                   "step)")
    return not bad, bad


def card_idle(wd, ranks):
    """(each rank's idle share from its --profile table, the card's idle share
    over the overlap of the ranks' windows: 1 - the union of every rank's
    device spans in it / its length), or Nones when not traced."""
    from sgg_torch.utils.profiling import DEVICE_WORK, busy_time, trace_events

    per, spans, lo, hi = [], [], [], []
    for r_ in range(ranks):
        d_ = os.path.join(wd, "profile" if r_ == 0 else f"profile_rank{r_}")
        idle = None
        try:
            with open(os.path.join(d_, "top_ops.txt")) as f:
                for line in f:
                    if "idle share" in line and "not measured" not in line:
                        idle = float(line.rsplit(" ", 1)[1])
            ev = trace_events(os.path.join(d_, "trace.json"))
        except OSError:
            return [None] * ranks, None
        per.append(idle)
        dev = [(t0, d) for _, cat, t0, d in ev if cat in DEVICE_WORK]
        cpu = [(t0, d) for _, cat, t0, d in ev if cat == "cpu_op"]
        if not dev or not cpu:
            return per + [None] * (ranks - len(per)), None
        lo.append(min(t0 for t0, _ in cpu))
        hi.append(max(t0 + d for t0, d in cpu))
        spans += dev
    a_, b_ = max(lo), min(hi)
    if b_ <= a_:
        return per, None
    clipped = [(max(t0, a_), min(t0 + d, b_) - max(t0, a_)) for t0, d in spans
               if t0 < b_ and t0 + d > a_]
    return per, 1.0 - busy_time(clipped) / (b_ - a_)


def dp_phase(dev, smi, sizes=None, extra_sets=None, vit_sets=None):
    """Phase 24, the data-parallel tier, through ``sgg_torch.cli.train`` in
    ranks of ``rank_run``: (a) ``--config v4_32`` at full width (VGG-19 at
    224 px, bf16, batch 128 per rank, n_critic 5), two ranks over gloo on one
    card, 6 steps on a VG-shaped corpus of 2,048 ids cycling the committed
    fixture (``vg_corpus``), step 3 profiled on each rank; (b) the same at
    world 1 over NCCL, and a plain process without torchrun; (c) vit_b16 with
    ``train_encoder``, two ranks (started with torchrun's environment, no
    launcher), batch 32 per rank, 3 steps. Holds
    (``dp_holds``): (a) both ranks' states (parameters, optimizer moments
    and counts) equal bit for bit, their noise distinct, rank 0's the plain
    run's, 96 conv_direct launches a step on each rank; (b) the world-1 state
    equal to the plain run's bit for bit, over NCCL; (c) 72/60/60 flash, dq
    and dk/dv launches a step on each rank, the ranks' states equal. Prints
    s/step, global images/s, the all-reduce's ms a step, the idle shares and
    the launches. ``sizes``, ``extra_sets`` and ``vit_sets`` shrink it for a
    dry run on the CPU (launch counts printed, not held). Returns the
    numbers."""
    import torch

    z_ = {"images": VG_IMAGES_21, "steps": DP_STEPS, "vit_steps": DP_VIT_STEPS,
          "vit_images": VIT_IMAGES, **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        vg_dir = os.path.join(tmp, "vg")
        vg_corpus(vg_dir, z_["images"])

        def argv(wd, config, steps, sets, profile=False):
            a_ = ["--config", config, "--workdir", wd, "--steps", str(steps)]
            a_ += ["--profile"] if profile else []
            for k_, v_ in sets.items():
                a_ += ["--set", f"{k_}={v_}"]
            return a_ + ([] if on_card else ["--device", "cpu"])

        v_sets = {**(extra_sets or {}), "data.data_dir": vg_dir, "train.log_every": 1}
        runs = {}
        for label, n_ in (("a", 2), ("b", 1), ("plain", None)):
            wd = os.path.join(tmp, f"wd_{label}")
            t_r = time.perf_counter()
            recs, text = dp_launch(os.path.join(tmp, f"out_{label}"),
                                   argv(wd, "v4_32", z_["steps"], v_sets, label == "a"), n_,
                                   torchrun=n_ is not None)
            lines = read_metric_lines(wd)
            logged = [r_ for r_ in lines if "d_loss" in r_]
            per, card = card_idle(wd, n_ or 1)
            runs[label] = {"recs": recs, "s": time.perf_counter() - t_r, "text": text,
                           "s_per_step": 1 / logged[-1]["steps_per_sec"],
                           "images_per_s": logged[-1]["images_per_sec"],
                           "idle": per, "card_idle": card,
                           "losses": [(r_["d_loss"], r_["g_loss"]) for r_ in logged]}
        a, b, pl = runs["a"], runs["b"], runs["plain"]
        per_enc = 16 * (6 if not extra_sets else 1 + int(extra_sets.get("train.n_critic", 5)))
        ok_a, bad_a = dp_holds(a["recs"], pl["recs"][0],
                               {"conv_direct": per_enc} if on_card else None)
        ok_b = (b["recs"][0]["digests"] == pl["recs"][0]["digests"]
                and b["recs"][0]["backend"] == ("nccl" if on_card else "gloo"))
        for label, r_ in runs.items():
            rank_s = ", ".join(f"rank {x_['rank']} on {x_['device']} ({x_['backend']}): "
                               f"launches a step {x_['per_step'][-1]}, all-reduce "
                               f"{x_['allreduce_ms_step']:.3f} ms a step over "
                               f"{len(x_.get('step_buckets', []))} buckets "
                               f"({sum(x_.get('step_buckets', []))} floats), seconds from "
                               f"its start {({k_: round(v_, 2) for k_, v_ in x_['t'].items()})}"
                               for x_ in r_["recs"])
            log(f"phase 24 ({label}) v4_32, {len(r_['recs'])} rank"
                f"{'s' if len(r_['recs']) > 1 else ''}: {z_['steps']} steps in "
                f"{r_['s']:.3f} s (launch, set-up and checkpoint included); last step "
                f"{r_['s_per_step']:.4f} s/step, {r_['images_per_s']:.1f} images/s over every "
                f"rank; idle share per rank {r_['idle']}, card {r_['card_idle']}; {rank_s}; "
                f"losses {r_['losses'][-1]} [{smi}]")
        log(f"phase 24 (a) holds: {'ok' if ok_a else 'FAILED: ' + '; '.join(bad_a)}; (b) world "
            f"1 over {b['recs'][0]['backend']} equal to the plain run bit for bit: {ok_b}; "
            f"(b) {b['s_per_step']:.4f} s/step, plain {pl['s_per_step']:.4f}, (a) "
            f"{a['s_per_step']:.4f}")
        if not (ok_a and ok_b and a["recs"][0]["backend"] == "gloo"):
            raise AssertionError("phase 24 (a)/(b): the data-parallel holds failed")
        out.update({k_: {x_: v_ for x_, v_ in r_.items() if x_ not in ("text", "recs")}
                    for k_, r_ in runs.items()})
        out["allreduce_ms_step"] = [x_["allreduce_ms_step"] for x_ in a["recs"]]
        out["launches"] = {k_: sum(c_[k_] for r_ in (a, b, pl) for x_ in r_["recs"]
                                   for c_ in x_["per_step"])
                           for k_ in a["recs"][0]["per_step"][0]}

        # (c) vit_b16 with train_encoder, two ranks.
        wd = os.path.join(tmp, "wd_c")
        t_c = time.perf_counter()
        sets_c = {"train.train_encoder": "true", "data.num_synthetic_images": z_["vit_images"],
                  "train.log_every": 1, **(vit_sets or {})}
        recs, text = dp_launch(os.path.join(tmp, "out_c"),
                               argv(wd, "vit_b16", z_["vit_steps"], sets_c), 2,
                               torchrun=False)
        want = ({"flash_attention": 72, "flash_attention_bwd_dq": 60,
                 "flash_attention_bwd_dkv": 60} if on_card else None)
        ok_c, bad_c = dp_holds(recs, None, want)
        lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
        log(f"phase 24 (c) vit_b16 train_encoder, 2 ranks: {z_['vit_steps']} steps in "
            f"{time.perf_counter() - t_c:.3f} s; last step {1 / lines[-1]['steps_per_sec']:.4f} "
            f"s/step; launches a step " + ", ".join(
                f"rank {x_['rank']} {x_['per_step']}, seconds from its start "
                f"{({k_: round(v_, 2) for k_, v_ in x_['t'].items()})}" for x_ in recs)
            + f"; holds: {'ok' if ok_c else 'FAILED: ' + '; '.join(bad_c)} [{smi}]")
        if not ok_c:
            raise AssertionError("phase 24 (c): the data-parallel vit_b16 holds failed")
        out["vit"] = {"s_per_step": 1 / lines[-1]["steps_per_sec"],
                      "per_step": [x_["per_step"] for x_ in recs]}
        for k_ in out["launches"]:
            out["launches"][k_] += sum(c_[k_] for x_ in recs for c_ in x_["per_step"])
    return out


def vocab_of_size(vg_dir, n_tokens):
    """``vg_dir/vocab<n>.json``: the corpus's own words (what ``data.source=vg``
    builds at min_count 2) and filler words after them, 7/8 objects, to
    ``n_tokens`` in all; returns its path."""
    from sgg_torch.data import Vocab
    from sgg_torch.data.vg import build_vocab_from_relationships, parse_relationships

    images = parse_relationships(os.path.join(vg_dir, "relationships.json"))
    base = build_vocab_from_relationships(images, min_count=2)
    objs = {t: 10 ** 6 for t, o in zip(base.tokens, base.is_object) if o}
    preds = {t: 10 ** 6 for t, p_ in zip(base.tokens, base.is_predicate) if p_}
    fill = n_tokens - len(base)
    objs.update({f"filler_object{i}": 1 for i in range(fill * 7 // 8)})
    preds.update({f"filler_predicate{i}": 1 for i in range(fill - fill * 7 // 8)})
    vocab = Vocab.build(objs, preds)
    if len(vocab) != n_tokens:
        raise AssertionError(f"phase 26: a vocab of {len(vocab)} tokens, not {n_tokens}")
    path = os.path.join(vg_dir, f"vocab{n_tokens}.json")
    vocab.save(path)
    return path


def adam_step_bound(b1, b2, updates):
    """Σ_t C_t over ``updates`` Adam updates, C_t the most that one update
    moves an element in units of lr: |m̂_t| / √v̂_t ≤ C_t by Cauchy-Schwarz
    over the gradients so far (C_1 = 1)."""
    total = 0.0
    for t_ in range(1, updates + 1):
        acc = sum(((1 - b1) * b1 ** j) ** 2 / ((1 - b2) * b2 ** j) for j in range(t_))
        total += math.sqrt(acc) * math.sqrt(1 - b2 ** t_) / (1 - b1 ** t_)
    return total


def world_one_hold(dev, wd, out, data, model, trained, moe_shards=1):
    """Phase 26 (c): the first step of a TP or FSDP run in float32 with
    n_critic 1 (its ranks' records in ``out``, its workdir ``wd``, one
    step) against one process at the global batch on the same state and
    noise, in float32. The two compute one function; they differ in the
    order and the split of float32 sums (the vocabulary's sums split over
    the model axis, the batch's over the data axis, GEMMs of other shapes).
    n_critic is 1 so that the metrics are the first critic update's, taken
    before an Adam update: at full width each update moves the elements
    whose gradient is rounding noise by ±lr, and the hard Gumbel sample
    turns that into other tokens, so five updates carry one ulp of one
    element of the critic's state to a g_loss 0.6× apart in one process
    (``scripts/tp_probe.py``, PERF.md §6). The bound is the reference's own
    for its gspmd step against the single-device step
    (``tests/dist/test_tp_fsdp.py``) and the CPU tests':
      - each metric within rtol 1e-4 + atol 1e-6;
      - each module's parameters after the step: every element within
        1e-6 + 1e-5 |p|, except at most 1 % of the module's elements, where
        a gradient that is rounding noise in both runs can give Adam's step
        the other sign; those within 2 lr Σ C_t (``adam_step_bound``: the
        most that the module's u Adam updates of the step move an element,
        both runs from one state).
    A shard left out, a gradient not reduced or noise from the wrong rows
    moves every metric and most elements by far more. ``model``: the ranks
    of one data coordinate (its first holds the coordinate's rows).
    ``moe_shards``: the token shards of an expert-parallel run (data ×
    expert), whose MoE load-balance term is the mean of the shards' terms,
    each over its contiguous 1/n of the batch's groups (``sgg/dist/
    expert_parallel.py:62``), not the whole batch's: the one process's MoE
    layers then compute the layer shard by shard as the EP ranks do
    (``shard_forward``), so that ``moe_aux``, the router's gradient and every
    later update take the same term, and each shard's router logits come
    from a product of the EP rank's own shape: at another shape the GEMM
    rounds otherwise, and an ulp can move a top-k choice at a near tie, a
    step in the function (four cards, EP over 4: 1.8 % of the generator's
    elements at Adam's sign bound when the logits came whole). Returns (ok,
    numbers)."""
    import torch

    from sgg_torch.config import Config
    from sgg_torch.train.checkpoint import load_workdir
    from sgg_torch.train.state import create_train_state
    from sgg_torch.train.step import make_step_fn

    cfg, vocab = load_workdir(wd)
    firsts = [torch.load(os.path.join(out, f"first_rank{d_ * model}.pt"), weights_only=True)
              for d_ in range(data)]
    batch = {k_: torch.cat([f_["batch"][k_] for f_ in firsts], dim=1).to(dev)
             for k_ in firsts[0]["batch"]}
    B = batch["triples"].shape[1]
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        m_ranks = next(json.loads(l_) for l_ in f if '"d_loss"' in l_)
    want = torch.load(os.path.join(wd, "checkpoints", "1", "state.pt"), map_location="cpu",
                      weights_only=True, mmap=True)  # read leaf by leaf, as compared
    c_ = Config.from_json(cfg.to_json()).override(
        [f"train.batch_size={B}", "mesh.model=1", "mesh.fsdp=false", "mesh.expert=1",
         "model.pp_microbatches=0"])
    c_.model.vocab_size = cfg.model.vocab_size
    st = create_train_state(c_, c_.train.seed, device=dev)
    from sgg_torch.models import moe as moe_mod

    forward = moe_mod.moe_forward

    def shard_forward(params, x, top_k, capacity):
        """The MoE layer as the EP ranks compute it: each shard's router
        logits from its own groups (one product of the EP rank's shape), its
        routing and its load-balance term, the terms' mean; the dispatch,
        the experts and the combine over every group at once."""
        dt = x.dtype
        parts = [moe_mod.moe_routing(torch.einsum("gsm,me->gse", c_.float(),
                                                  params["router"].float()), top_k, capacity)
                 for c_ in x.chunk(moe_shards, 0)]
        combine = torch.cat([p_[0] for p_ in parts])
        xe = torch.einsum("gsec,gsm->egcm", (combine > 0).to(dt), x)
        ye = moe_mod.moe_expert_ffn(params["wi"].to(dt), params["wo"].to(dt), xe)
        y = torch.einsum("gsec,egcm->gsm", combine.to(dt), ye)
        return y.to(dt), sum(p_[1] for p_ in parts) / moe_shards

    moe_mod.moe_forward = shard_forward if moe_shards > 1 else forward
    try:
        m1 = make_step_fn(c_, vocab.step_mask())(
            st, batch, {k_: v_.to(dev) for k_, v_ in firsts[0]["noise"].items()})
    finally:
        moe_mod.moe_forward = forward
    m1 = {k_: float(v_) for k_, v_ in m1.items()}
    got = {"g_params": st.generator.state_dict(), "d_params": st.critic.state_dict(),
           "enc_params": None if st.encoder is None else st.encoder.state_dict()}
    bad, nums = [], {"metrics": {}, "params": {}}
    for k_, v_ in m1.items():
        if k_ in m_ranks:
            d_ = abs(m_ranks[k_] - v_)
            nums["metrics"][k_] = (m_ranks[k_], v_, d_)
            if not d_ <= 1e-6 + 1e-4 * abs(v_):
                bad.append(f"{k_}: {m_ranks[k_]} against {v_}")
    t_ = cfg.train
    lrs = {"g_params": (t_.g_lr, 1), "d_params": (t_.d_lr, t_.n_critic),
           "enc_params": (t_.enc_lr, t_.n_critic)}
    for tree in trained:
        lr, u = lrs[tree]
        step_bound = 2 * lr * adam_step_bound(float(t_.beta1), float(t_.beta2), u) + 1e-6
        n_far = n_all = 0
        worst = 0.0
        for k_, w_ in want[tree].items():  # on the device of the one process's state
            g_ = got[tree][k_].detach().float()
            w_ = w_.to(g_.device).float()
            d_ = (g_ - w_).abs()
            far = d_ > 1e-6 + 1e-5 * w_.abs()
            n_far += int(far.sum())
            n_all += w_.numel()
            worst = max(worst, float(d_.max()))
        nums["params"][tree] = (n_far / n_all, worst, step_bound)
        if n_far > 0.01 * n_all or worst > step_bound:
            bad.append(f"{tree}: {n_far} of {n_all} elements beyond 1e-6 + 1e-5 |p|, max |d| "
                       f"{worst:.3g} (bound {step_bound:.3g})")
    del st
    torch.cuda.empty_cache()
    return not bad, {**nums, "bad": bad}


def tp_fsdp_phase(dev, smi, sizes=None, extra_sets=None, vit_sets=None):
    """Phase 26, A8b: tensor parallelism over the vocabulary and FSDP/ZeRO
    over 'data', each through ``sgg_torch.cli.train`` under torchrun with
    the normal flags (ranks of ``rank_run``, two sharing the card over
    gloo): (a) TP, ``--config resnet50 --set mesh.model=2`` on a VG-shaped
    corpus of 512 ids cycling the committed fixture with a vocab of 8,192
    (``vocab_of_size``): V 8,192, F 2,048, R 49, 224 px, bf16, the frozen
    ResNet-50 on conv_direct and fused_matmul (13 + 36 launches an encoder
    pass, 6 passes a step, on each rank), 3 steps, then
    ``sgg_torch.cli.generate --decode fused`` on its workdir (fused_decode
    reads the global checkpoint); (b) FSDP, ``--config vit_b16 --set
    train.train_encoder=true --set mesh.fsdp=true``, batch 32 a rank, the
    ViT's weights and moments split over 'data' (72/60/60 flash, dq and
    dk/dv launches a step on each rank), 3 steps; (c) each of (a) and (b)
    again for one step in float32 with n_critic 1 (on the library routes:
    the kernels are (a)'s and (b)'s to hold), the two runs at once, each
    held against one
    process at the global batch on the same state and noise
    (``world_one_hold``, its bound in its docstring). Holds also: every rank
    gathers the same global state, equal to the checkpoint the run wrote,
    the backend line names gloo's host staging, and each rank's state bytes
    are below data parallelism's. Prints s/step, the collectives' ms a step
    (host clock), peak memory and state bytes per rank, and the launches.
    ``sizes``, ``extra_sets`` and ``vit_sets`` shrink it for a dry run on
    the CPU (launch counts printed, not held). Returns the numbers."""
    import torch

    from sgg_torch.cli import generate

    z_ = {"images": P26_IMAGES, "steps": P26_STEPS, "vocab": P26_VOCAB,
          "gen_images": P26_GEN_IMAGES, "k": P26_K, "vit_images": VIT_IMAGES,
          **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    out = {"launches": {k_: 0 for k_ in kernel_counts()}}

    def argv(wd, config, sets, steps=z_["steps"]):
        a_ = ["--config", config, "--workdir", wd, "--steps", str(steps)]
        for k_, v_ in sets.items():
            a_ += ["--set", f"{k_}={v_}"]
        return a_ + ([] if on_card else ["--device", "cpu"])

    def report(label, recs, wd, text):
        lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
        backend = re.findall(r"\[sgg\.dist\] rank 0 of \d+ on \S+: backend .*", text)
        whole = re.findall(r"state bytes on this rank: ([\d,]+) \(data parallel: ([\d,]+)\)",
                           text)
        r_ = {"s_per_step": 1 / lines[-1]["steps_per_sec"], "backend": backend[0],
              "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
              "peak_gb": [x_["peak_gb"] for x_ in recs],
              "state_bytes": [x_["state_bytes"] for x_ in recs],
              "dp_bytes": int(whole[0][1].replace(",", "")),
              "per_step": [x_["per_step"] for x_ in recs]}
        log(f"phase 26 ({label}): {z_['steps']} steps, last {r_['s_per_step']:.4f} s/step; "
            f"collectives ms a step per rank (host clock, after the first) {r_['coll_ms']}; "
            f"peak GB per rank {r_['peak_gb']}; state bytes per rank {r_['state_bytes']} "
            f"(data parallel {r_['dp_bytes']}); launches a step per rank "
            f"{[x_['per_step'][-1] for x_ in recs]}; {r_['backend']} [{smi}]")
        for x_ in recs:
            for c_ in x_["per_step"]:
                for k_, v_ in c_.items():
                    out["launches"][k_] += v_
        return r_

    def common_holds(label, recs, wd, r_, want_step):
        bad = []
        if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs):
            bad.append("the ranks gathered different global states")
        sd = torch.load(os.path.join(wd, "checkpoints", str(z_["steps"]), "state.pt"),
                        map_location="cpu", weights_only=True)
        if digest(tree_tensors(sd)) != recs[0]["global_digests"]:
            bad.append("the checkpoint is not the gathered global state")
        if on_card and "all-gathers stage through the host" not in r_["backend"]:
            bad.append("the backend line does not name gloo's host staging")
        if not all(b_ < r_["dp_bytes"] for b_ in r_["state_bytes"]):
            bad.append("a rank holds no less than data parallelism")
        if want_step is not None and any(
                [{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                != [want_step] * len(x_["per_step"]) for x_ in recs):
            bad.append(f"launches {[x_['per_step'] for x_ in recs]} (expected {want_step})")
        log(f"phase 26 ({label}) holds: {'ok' if not bad else 'FAILED: ' + '; '.join(bad)}")
        return not bad

    with tempfile.TemporaryDirectory() as tmp:
        vg_dir = os.path.join(tmp, "vg")
        vg_corpus(vg_dir, z_["images"])
        vocab_path = vocab_of_size(vg_dir, z_["vocab"])
        first = {"SGG_SMOKE_FIRST": "1"}

        # (a) TP on resnet50 at V = 8,192.
        wd_a, out_a = os.path.join(tmp, "wd_a"), os.path.join(tmp, "out_a")
        sets_a = {"mesh.model": 2, "data.source": "vg", "data.data_dir": vg_dir,
                  "data.vocab_path": vocab_path, "train.log_every": 1, **(extra_sets or {})}
        t_a = time.perf_counter()
        recs_a, text_a = dp_launch(out_a, argv(wd_a, "resnet50", sets_a), 2, env_extra=first)
        r_a = report("a) TP, resnet50, V 8192, 2 ranks", recs_a, wd_a, text_a)
        r_a["s"] = time.perf_counter() - t_a
        passes = 1 + int(sets_a.get("train.n_critic", 5))
        ok_a = common_holds("a", recs_a, wd_a, r_a, {"conv_direct": 13 * passes,
                                                     "fused_matmul": 36 * passes}
                            if on_card else None)
        gen_out = os.path.join(tmp, "graphs_a.json")
        gen_s, gen_counts = run_cli(generate.main, [
            "--workdir", wd_a, "--out", gen_out, "--decode", "fused", "--split", "train",
            "--num-images", str(z_["gen_images"]), "--batch-size", "32",
            "--num-samples", str(z_["k"]), "--seed", str(SEED)]
            + ([] if on_card else ["--device", "cpu"]), "sgg_torch.cli.generate")
        n_b = math.ceil(z_["gen_images"] / 32)
        want_gen = {"fused_decode": n_b * z_["k"], "fused_matmul": n_b * 36,
                    "conv_direct": n_b * 13, "flash_attention": 0,
                    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
        with open(gen_out) as f:
            graphs = json.load(f)["scene_graphs"]
        log(f"phase 26 (a) generate --decode fused on the TP workdir: {gen_s:.3f} s, "
            f"{len(graphs)} graphs, launches {gen_counts} (expected {want_gen})")
        for k_, v_ in gen_counts.items():
            out["launches"][k_] += v_
        if len(graphs) != z_["gen_images"] or (on_card and gen_counts != want_gen):
            ok_a = False
        # (b) FSDP on vit_b16 with train_encoder.
        wd_b, out_b = os.path.join(tmp, "wd_b"), os.path.join(tmp, "out_b")
        sets_b = {"train.train_encoder": "true", "mesh.fsdp": "true",
                  "data.num_synthetic_images": z_["vit_images"], "train.log_every": 1,
                  **(vit_sets or {})}
        t_b = time.perf_counter()
        recs_b, text_b = dp_launch(out_b, argv(wd_b, "vit_b16", sets_b), 2, torchrun=False,
                                   env_extra=first)
        r_b = report("b) FSDP, vit_b16 train_encoder, 2 ranks", recs_b, wd_b, text_b)
        r_b["s"] = time.perf_counter() - t_b
        ok_b = common_holds("b", recs_b, wd_b, r_b, {
            "flash_attention": 72, "flash_attention_bwd_dq": 60,
            "flash_attention_bwd_dkv": 60} if on_card else None)

        # (c) each again for one step in float32, both at once, each against
        # one process.
        f32 = {"model.compute_dtype": "float32", "model.use_pallas": "false",
               "train.checkpoint_every": 1, "train.n_critic": 1}
        runs_c = {"a": ("resnet50", {**sets_a, **f32}, True), "b": ("vit_b16",
                                                                 {**sets_b, **f32}, False)}
        t_c = time.perf_counter()
        done, _ = in_threads(lambda k_: dp_launch(
            os.path.join(tmp, f"out_c{k_}"), argv(os.path.join(tmp, f"wd_c{k_}"), runs_c[k_][0],
                                                  runs_c[k_][1], steps=1),
            2, torchrun=runs_c[k_][2], env_extra=first), [("a",), ("b",)])
        ok_ca, c_a = world_one_hold(dev, os.path.join(tmp, "wd_ca"), os.path.join(tmp, "out_ca"),
                                    1, 2, ("g_params", "d_params"))
        ok_cb, c_b = world_one_hold(dev, os.path.join(tmp, "wd_cb"), os.path.join(tmp, "out_cb"),
                                    2, 1, ("g_params", "d_params", "enc_params"))
        c_s = time.perf_counter() - t_c
        for recs_c, _ in done:
            for x_ in recs_c:
                for c_ in x_["per_step"]:
                    for k_, v_ in c_.items():
                        out["launches"][k_] += v_
        log(f"phase 26 (c) float32, TP against one process: {'ok' if ok_ca else 'FAILED'} {c_a}")
        log(f"phase 26 (c) float32, FSDP against one process: {'ok' if ok_cb else 'FAILED'} "
            f"{c_b}; (c) {c_s:.3f} s")
        out.update({"a": r_a, "b": r_b, "c": {"tp": c_a, "fsdp": c_b},
                    "generate": {"s": gen_s, "launches": gen_counts}})
    if not (ok_a and ok_b and ok_ca and ok_cb):
        raise AssertionError("phase 26: a TP/FSDP hold failed")
    return out


def sp_saved_bytes(cfg, state, seed=SEED):
    """Phase 27: (bytes that autograd saves for the backward in one forward
    of the state's encoder on this rank's batch of 224 px images, with its
    attention sequence parallel as the gspmd step runs it; the same with the
    attention whole, as data parallelism runs it). Each tensor's storage
    counts once. Every rank of the axis calls it alike."""
    import torch

    from sgg_torch.dist.mesh import MODEL_AXIS, SEQ_AXIS
    from sgg_torch.dist.sequence_parallel import make_sp_attention, sp_encoder
    from sgg_torch.models.encoders import normalize_for

    enc, mesh = state.encoder, state.placement.mesh
    dev = next(enc.parameters()).device
    size = cfg.data.image_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = normalize_for(cfg.model.encoder, torch.randint(
        0, 256, (cfg.train.batch_size, size, size, 3), generator=gen, device=dev,
        dtype=torch.uint8))
    attn = make_sp_attention(mesh, cfg.model.sp_mode,
                             SEQ_AXIS if SEQ_AXIS in mesh.axis_names else MODEL_AXIS)

    def saved():
        seen = {}

        def pack(t_):
            st = t_.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
            return t_

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t_: t_):
            y = enc(x)
        del y
        return sum(seen.values())

    with sp_encoder(enc, attn):
        sp = saved()
    return sp, saved()


def bf16_ulp(x):
    """One bfloat16 ulp of each value of x, float32 (0 where x is 0)."""
    import torch

    x = x.float()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def sp_ring_plain(q, k, v, g, n, o_fwd=None, scale=None):
    """Phase 27: the ring over n ranks as ``RingFlashAttention`` computes it,
    emulated on the global tensors with the kernels' plain versions: each
    rank's q rows against the k/v shards in the ring's order, the partials
    rounded to q's dtype and merged in float32, then the reverse ring's dq,
    dk, dv summed in float32 in the hops' order (against ``o_fwd``, the
    kernel path's output, when given: the backward kernels are held on the
    forward they were fed) → ([o, dq, dk, dv], [their bounds]), global. A
    bound is phase 9's and 13's gate (one bf16 ulp of the plain value plus
    1e-4 × its max) on each kernel output that the ring combines, carried
    through the exact float32 combination (o: each partial's weighted by its
    softmax share), plus one ulp of the final cast."""
    import torch

    from sgg_torch.dist.sequence_parallel import _merge
    from sgg_torch.kernels.flash_attention import flash_attention_plain
    from sgg_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain

    s_ = q.shape[-1] ** -0.5 if scale is None else scale
    rows = q.shape[2] // n

    def shard(t_, i):
        return t_[:, :, i * rows:(i + 1) * rows].contiguous()

    def gate(x_):
        return bf16_ulp(x_) + 1e-4 * x_.float().abs().max()

    qs, ks, vs, gs = ([shard(t_, i) for i in range(n)] for t_ in (q, k, v, g))
    os_, lses, o_bounds = [], [], []
    for r_ in range(n):
        parts = [flash_attention_plain(qs[r_], ks[(r_ - j) % n], vs[(r_ - j) % n], s_,
                                       return_lse=True) for j in range(n)]
        o_, lse = parts[0][0].float(), parts[0][1]
        for o_i, lse_i in parts[1:]:
            o_, lse = _merge(o_, lse, o_i, lse_i)
        os_.append(o_.to(q.dtype))
        lses.append(lse)
        o_bounds.append(sum(torch.exp(lse_i - lse)[..., None] * gate(o_i)
                            for o_i, lse_i in parts) + bf16_ulp(os_[-1]))
    o_bwd = os_ if o_fwd is None else [shard(o_fwd, i) for i in range(n)]
    acc = {w_: [torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
                for _ in range(n)] for w_ in ("dq", "dk", "dv", "bq", "bk", "bv")}
    for j in range(n):
        for r_ in range(n):
            src = (r_ - j) % n
            a_, b_, c_ = flash_attention_bwd_plain(qs[r_], ks[src], vs[src], o_bwd[r_],
                                                   lses[r_], gs[r_], s_)
            for w_, i_, x_ in (("dq", r_, a_), ("dk", src, b_), ("dv", src, c_)):
                acc[w_][i_] += x_.float()
                acc["b" + w_[1]][i_] += gate(x_)
    got = [torch.cat(os_, 2)] + [torch.cat(acc[w_], 2).to(q.dtype) for w_ in ("dq", "dk", "dv")]
    bounds = [torch.cat(o_bounds, 2)] + [torch.cat(acc[b_], 2) for b_ in ("bq", "bk", "bv")]
    return got, [b_ + bf16_ulp(x_) if i_ else b_ for i_, (b_, x_) in enumerate(zip(bounds, got))]


def sp_attention_run(args):
    """Phase 27 (a)'s rank: ``chip_smoke.py --sp-attention-run OUT ROOT
    DEVICE SHAPE`` (SHAPE ``B,H,S,D``), one process per rank with torchrun's
    environment (two ranks share the card over gloo). For ring and Ulysses
    over a 'seq' axis of the world (``mesh.seq`` = world,
    ``make_sp_attention`` as the gspmd step builds it), in float32 and
    bfloat16, at SHAPE (``SP_SHAPE``: ViT-B/16's attention, B 32): q, k, v
    and the upstream gradient g seeded alike on every rank; the launches of one forward and its backward (counts set to 0 just
    before, read just after); the output and dq, dk, dv (all-gathered,
    global) against the plain versions on the same inputs: the plain full
    attention and its backward, and ``sp_ring_plain`` for the ring (for
    Ulysses the full attention is its emulation: heads are independent).
    Writes ``OUT/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    out, root, device = args[0], args[1], args[2]
    shape = tuple(int(x_) for x_ in args[3].split(","))
    sys.path.insert(0, root)
    from sgg_torch.config import get_config
    from sgg_torch.dist import initialize_multihost, mesh_from_config
    from sgg_torch.dist.sequence_parallel import make_sp_attention
    from sgg_torch.kernels.flash_attention import flash_attention_plain
    from sgg_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain

    dev = initialize_multihost(device, log=lambda m_: None)
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n, rank = dist.get_world_size(), dist.get_rank()
    mesh = mesh_from_config(get_config("vit_b16").override([f"mesh.seq={n}"]).mesh, dev)
    rec = {"rank": rank, "world": n, "backend": dist.get_backend(), "cases": {}}

    def rel_l2(a_, b_):
        return float((a_.double() - b_.double()).norm() / b_.double().norm())

    for mode in ("ring", "ulysses"):
        sp = make_sp_attention(mesh, mode, "seq")
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dt)
                          for _ in range(4))
            qg, kg, vg = (t_.clone().requires_grad_() for t_ in (q, k, v))
            sync()
            zero_counts()
            o = sp(qg, kg, vg)
            o.backward(g)
            sync()
            counts = {k_: v_ for k_, v_ in kernel_counts().items() if v_}
            got = [o.detach(), qg.grad, kg.grad, vg.grad]
            with torch.no_grad():
                fo, flse = flash_attention_plain(q, k, v, return_lse=True)
                full = [fo, *flash_attention_bwd_plain(q, k, v, fo, flse, g)]
                if mode == "ring":
                    emul, bounds = sp_ring_plain(q, k, v, g, n, o_fwd=got[0])
                else:  # heads are independent: full attention is Ulysses' arithmetic
                    emul = full
                    bounds = [bf16_ulp(e_) + 1e-4 * e_.float().abs().max() for e_ in full]
                f32 = [q.float(), k.float(), v.float()]
                fo32, flse32 = flash_attention_plain(*f32, return_lse=True)
                full32 = [fo32, *flash_attention_bwd_plain(*f32, fo32, flse32, g.float())]
            case = {"launches": counts, "tensors": {}}
            for name_, a_, f_, e_, w32, b_ in zip(("o", "dq", "dk", "dv"), got, full, emul,
                                                 full32, bounds):
                top = float(f_.float().abs().max())
                d_full = float((a_.float() - f_.float()).abs().max())
                t_ = {"max": top, "full_err": d_full / top,
                      "rel_l2_vs_f32": rel_l2(a_, w32), "plain_rel_l2_vs_f32": rel_l2(f_, w32)}
                if dt == torch.float32:
                    t_["ok"] = d_full <= 1e-4 * top
                else:
                    diff = (a_.float() - e_.float()).abs()
                    t_["emul_err"] = float(diff.max()) / float(e_.float().abs().max())
                    t_["share"] = float((diff > 0).float().mean())
                    t_["margin"] = float((b_ - diff).min() / e_.float().abs().max())
                    t_["ok"] = bool((diff <= b_).all()) and t_["share"] <= 0.01
                case["tensors"][name_] = t_
            rec["cases"][f"{mode} {str(dt).split('.')[1]}"] = case
            del q, k, v, g, qg, kg, vg, o, got, full, emul, full32, bounds
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sp_phase(dev, smi, sizes=None, extra_sets=None):
    """Phase 27, A8c: ring and Ulysses sequence parallelism over the ViT's
    patch axis, two ranks sharing the card over gloo. (a) The attention
    alone (``sp_attention_run``'s ranks): ring and Ulysses at ``SP_SHAPE``
    in float32 and bfloat16, forward and backward on the CUDA flash kernels
    (the ring: 2 flash, 2 dq and 2 dk/dv launches a call on each rank, n
    hops; Ulysses 1/1/1 on H/2 heads), float32 within 1e-4 × max of the
    plain full attention and its backward, bfloat16 against the plain
    versions of the same arithmetic (``sp_ring_plain`` for the ring's
    rounded partials; full attention for Ulysses) within the phase 9 and 13
    gate (one bf16 ulp plus 1e-4 × max) on each kernel output, carried
    through the ring's float32 combination, with at most 1 % of the
    elements differing; each one's relative L2 distance to float32 full
    attention printed beside the plain bf16 full attention's. (b) ``--config vit_b16 --set
    train.train_encoder=true --set model.sp_mode=ring --set mesh.seq=2 --set
    mesh.partition=gspmd``, B 32, 3 steps: 144/120/120 flash, dq and dk/dv
    launches a step on each rank (each of the 72/60/60 attention calls of a
    step runs 2 hops); (c) ``--set model.sp_mode=ulysses --set
    mesh.model=2``: Ulysses and TP over the vocabulary on one group, 3
    steps, 72/60/60 a step on each rank; both: every rank gathers the same
    global state, equal to the checkpoint. (d) each of (b) and (c) again for
    one float32 step at n_critic 1, both at once, against one process at the
    global batch (``world_one_hold``). (b) and (c) run side by side, four
    ranks on the card; (a) beside (d). Prints, for (b) and (c), s/step, the
    collectives' ms a step (host clock), the launches a step per rank, peak
    memory per rank and the bytes each rank saves for the backward in one
    encoder forward against data parallelism's (``sp_saved_bytes``).
    ``sizes`` and ``extra_sets`` shrink it for a dry run on the CPU (the
    attention holds and launch counts then not run or held). Returns the
    numbers."""
    import torch

    z_ = {"steps": P27_STEPS, "images": VIT_IMAGES, "sp_shape": SP_SHAPE, **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    out = {"launches": {k_: 0 for k_ in kernel_counts()}}
    bad = []

    def argv(wd, sets, steps=z_["steps"]):
        a_ = ["--config", "vit_b16", "--workdir", wd, "--steps", str(steps)]
        for k_, v_ in sets.items():
            a_ += ["--set", f"{k_}={v_}"]
        return a_ + ([] if on_card else ["--device", "cpu"])

    def add_launches(recs):
        for x_ in recs:
            for c_ in x_["per_step"]:
                for k_, v_ in c_.items():
                    out["launches"][k_] += v_

    with tempfile.TemporaryDirectory() as tmp:
        # (b) ring over 'seq', (c) Ulysses over 'model' with TP.
        env = {"SGG_SMOKE_FIRST": "1", "SGG_SMOKE_ACT": "1"}
        base = {"train.train_encoder": "true", "data.num_synthetic_images": z_["images"],
                "train.log_every": 1, **(extra_sets or {})}
        runs = {"b": ("ring over mesh.seq=2", {"model.sp_mode": "ring", "mesh.seq": 2,
                                               "mesh.partition": "gspmd"}, 2),
                "c": ("ulysses over mesh.model=2 with TP", {"model.sp_mode": "ulysses",
                                                           "mesh.model": 2}, 1)}
        # (b) and (c) side by side: four ranks on the card.
        done, wall = in_threads(lambda k_: dp_launch(
            os.path.join(tmp, f"out_{k_}"),
            argv(os.path.join(tmp, f"wd_{k_}"), {**base, **runs[k_][1]}), 2, torchrun=False,
            env_extra=env), [("b",), ("c",)])
        for (key, (label, sets, hops)), (recs, _) in zip(runs.items(), done):
            wd = os.path.join(tmp, f"wd_{key}")
            lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
            r_ = {"s": wall, "s_per_step": 1 / lines[-1]["steps_per_sec"],
                  "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
                  "peak_gb": [x_["peak_gb"] for x_ in recs],
                  "saved_bytes": [x_["saved_bytes"] for x_ in recs],
                  "per_step": [x_["per_step"] for x_ in recs],
                  "finite": all(math.isfinite(l_["d_loss"]) and math.isfinite(l_["g_loss"])
                                for l_ in lines)}
            add_launches(recs)
            want_step = {"flash_attention": 72 * hops, "flash_attention_bwd_dq": 60 * hops,
                         "flash_attention_bwd_dkv": 60 * hops}
            sd = torch.load(os.path.join(wd, "checkpoints", str(z_["steps"]), "state.pt"),
                            map_location="cpu", weights_only=True)
            held = []
            if on_card and any([{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                               != [want_step] * len(x_["per_step"]) for x_ in recs):
                held.append(f"launches {r_['per_step']} (expected {want_step} a step)")
            if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs) or \
                    digest(tree_tensors(sd)) != recs[0]["global_digests"]:
                held.append("the ranks' gathered states differ, or differ from the checkpoint")
            if not r_["finite"]:
                held.append("a loss is not finite")
            log(f"phase 27 ({key}) {label}, vit_b16 train_encoder, 2 ranks (beside the other "
                f"run's two): "
                f"{r_['s_per_step']:.4f} s/step; collectives ms a step per rank (host clock, "
                f"after the first) {r_['coll_ms']}; launches a step per rank "
                f"{[x_['per_step'][-1] for x_ in recs]} (expected {want_step}); peak GB per "
                f"rank {r_['peak_gb']}; bytes saved for the backward in one encoder forward "
                f"per rank (SP, DP) {r_['saved_bytes']}; {r_['s']:.3f} s [{smi}]: "
                f"{'ok' if not held else 'FAILED: ' + '; '.join(held)}")
            bad += [f"({key}) {h_}" for h_ in held]
            out[key] = r_

        # (d) each for one float32 step at n_critic 1, against one process.
        f32 = {"model.compute_dtype": "float32", "model.use_pallas": "false",
               "train.checkpoint_every": 1, "train.n_critic": 1}
        # and (a) the attention alone, beside them.
        t_d = time.perf_counter()
        out_a = os.path.join(tmp, "out_a")

        def launch(k_):
            if k_ == "a":
                return dp_launch(out_a, [], 2, torchrun=False, entry=[
                    "--sp-attention-run", out_a, ROOT, "cuda" if on_card else "cpu",
                    ",".join(map(str, z_["sp_shape"]))])
            return dp_launch(
                os.path.join(tmp, f"out_d{k_}"),
                argv(os.path.join(tmp, f"wd_d{k_}"), {**base, **runs[k_][1], **f32}, steps=1),
                2, torchrun=False, env_extra={"SGG_SMOKE_FIRST": "1"})

        (recs_a, _), *done = in_threads(launch, [("a",), ("b",), ("c",)])[0]
        for recs_d, _ in done:
            add_launches(recs_d)
        want = {"ring": {"flash_attention": 2, "flash_attention_bwd_dq": 2,
                         "flash_attention_bwd_dkv": 2},
                "ulysses": {"flash_attention": 1, "flash_attention_bwd_dq": 1,
                            "flash_attention_bwd_dkv": 1}}
        for rec in recs_a:
            for label, case in rec["cases"].items():
                ok = ((case["launches"] == want[label.split()[0]] or not on_card)
                      and all(t_["ok"] for t_ in case["tensors"].values()))
                if rec["rank"] == 0 or not ok:
                    log(f"phase 27 (a) rank {rec['rank']} {label} {z_['sp_shape']} over "
                        f"{rec['world']} ranks ({rec['backend']}): launches "
                        f"{case['launches']}, "
                        + "; ".join(f"{n_} {json.dumps(t_)}"
                                    for n_, t_ in case["tensors"].items())
                        + f": {'ok' if ok else 'FAILED'}")
                if not ok:
                    bad.append(f"(a) rank {rec['rank']} {label}")
        out["a"] = {label: {n_: {k_: t_[k_] for k_ in t_ if k_ != "ok"}
                            for n_, t_ in case["tensors"].items()}
                    for label, case in recs_a[0]["cases"].items()}

        out["d"] = {}
        for k_ in ("b", "c"):
            ok_d, hold = world_one_hold(dev, os.path.join(tmp, f"wd_d{k_}"),
                                        os.path.join(tmp, f"out_d{k_}"), 1, 2,
                                        ("g_params", "d_params", "enc_params"))
            log(f"phase 27 (d) float32, {runs[k_][0]} against one process: "
                f"{'ok' if ok_d else 'FAILED'} {hold}")
            out["d"][k_] = hold
            if not ok_d:
                bad.append(f"(d) {k_}: {hold['bad']}")
        out["d_s"] = time.perf_counter() - t_d
    if bad:
        raise AssertionError(f"phase 27: {'; '.join(bad)}")
    return out


def phase27_line(v27, smi):
    def coll(r_):  # each rank's mean ms a step after the first
        return [round(sum(x_) / max(len(x_), 1), 3) for x_ in r_["coll_ms"]]

    b_, c_ = v27["b"], v27["c"]
    return (f"phase 27: ring over mesh.seq=2 {b_['s_per_step']:.4f} s/step, collectives "
            f"{coll(b_)} ms a step, peak GB {b_['peak_gb']}, saved bytes (SP, DP) "
            f"{b_['saved_bytes']}; ulysses over mesh.model=2 with TP {c_['s_per_step']:.4f} "
            f"s/step, collectives {coll(c_)} ms a step, peak GB {c_['peak_gb']}, saved bytes "
            f"{c_['saved_bytes']}; the attention and float32 holds {v27['d_s']:.3f} s; "
            f"launches {v27['launches']} [{smi}]")


def pp_flash_holds(dev, smi):
    """Phase 28: the flash forward at the shapes that the pipeline gives it,
    bfloat16 on the card, held with phase 9's gate (within one bf16 ulp of
    the plain value + 1e-4 × max, at most 1 % of the outputs differing, the
    lse within 1e-5 relative, o with lse equal to o without): a PP
    microbatch at each ``P28_FLASH_SHAPES``; under DP×SP×PP the ring over
    ``P28_RING_N`` ranks on ``P28_RING_SHAPE``'s shards, emulated in this
    process as ``RingFlashAttention``'s forward computes it (each rank's
    partials from the kernel, merged in float32), each partial held at the
    shard's shape and the merged output against ``sp_ring_plain`` within its
    bound. These launches count nowhere. Returns the worst relative errors."""
    import torch

    from sgg_torch.dist.sequence_parallel import _merge
    from sgg_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    bad, worst = [], {}

    def hold(name, q, k, v):
        o, lse = fa.flash_attention_with_lse(q, k, v)
        o_only = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        diff = (o.float() - want.float()).abs()
        top = want.float().abs().max().item()
        share = (diff > 0).float().mean().item()
        lse_rel = ((lse - want_lse).abs() / want_lse.abs()).max().item()
        in_ulp = bool((diff <= bf16_ulp(want) + 1e-4 * top).all())
        ok = (in_ulp and share <= 1e-2 and lse_rel <= 1e-5 and torch.equal(o, o_only)
              and bool(torch.isfinite(o.float()).all()))
        log(f"phase 28 flash_attention vs plain bf16 {name} {list(q.shape)}: max_abs_err "
            f"{diff.max().item():.3e}, max|plain| {top:.3e}, within 1 bf16 ulp + 1e-4 x max "
            f"{in_ulp}, share differing {share:.3e}, lse max rel err {lse_rel:.3e}: "
            f"{'ok' if ok else 'FAILED'}")
        worst[name] = max(worst.get(name, 0.0), diff.max().item() / top)
        if not ok:
            bad.append(f"flash_attention {name} {list(q.shape)}")
        return o, lse

    def randn(shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    for shape in P28_FLASH_SHAPES:
        hold("PP microbatch", *(randn(shape) for _ in range(3)))
    n = P28_RING_N
    q, k, v, g = (randn(P28_RING_SHAPE) for _ in range(4))
    qs, ks, vs = ([t_.chunk(n, 2)[i].contiguous() for i in range(n)] for t_ in (q, k, v))
    os_ = []
    for r_ in range(n):  # rank r's hops: its own k/v shard, then r - 1, ...
        o_, lse = hold("ring hop", qs[r_], ks[r_], vs[r_])
        o_ = o_.float()
        for j in range(1, n):
            o_, lse = _merge(o_, lse, *hold("ring hop", qs[r_], ks[(r_ - j) % n],
                                            vs[(r_ - j) % n]))
        os_.append(o_.to(q.dtype))
    got = torch.cat(os_, 2)
    with torch.no_grad():
        emul, bounds = sp_ring_plain(q, k, v, g, n, o_fwd=got)
    diff = (got.float() - emul[0].float()).abs()
    share = float((diff > 0).float().mean())
    ok = bool((diff <= bounds[0]).all()) and share <= 0.01
    worst["ring"] = float(diff.max()) / float(emul[0].float().abs().max())
    log(f"phase 28 ring over {n} ranks of {list(P28_RING_SHAPE)} ({list(qs[0].shape)} a rank) "
        f"vs sp_ring_plain: rel err {worst['ring']:.3e}, share differing {share:.3e}, "
        f"within its bound {bool((diff <= bounds[0]).all())} [{smi}]: "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        bad.append("the ring's merged output")
    return worst, bad


def pp_ep_phase(dev, smi, sizes=None, extra_sets=None):
    """Phase 28, A8d and A8e: the GPipe pipeline over the ViT's block stack
    and the expert-parallel MoE, each through ``sgg_torch.cli.train`` on the
    gspmd route, two ranks sharing the card over gloo. (a) PP: ``--config
    vit_b16 --set mesh.model=2 --set model.pp_microbatches=4 --set
    mesh.partition=gspmd`` (the frozen encoder at 768 x 12 x 12, 224 px, B 32,
    bf16, n_critic 5; TP over the vocabulary on the same group), 2 steps: 6
    blocks a stage, each rank's stage computing only the ticks where it holds
    a microbatch, so (n_critic + 1) encoder passes × 6 blocks × 4
    microbatches = 144 flash launches a step on each rank, exactly. (b) EP:
    ``--config vit_b16 --set train.train_encoder=true --set
    model.moe_experts=8 --set model.moe_top_k=2 --set mesh.expert=2 --set
    mesh.partition=gspmd`` (4 experts a rank), B 32, 2 steps: 72/60/60 flash,
    dq and dk/dv launches a step on each rank, exactly; each rank's state
    bytes below data parallelism's. Both: every rank gathers the same global
    state, equal to the checkpoint; the losses are finite; (a)'s and (b)'s
    checkpoints each restore into one process's state on the card, equal to
    the gathered global state, and ``sgg_torch.cli.generate`` runs on (b)'s
    workdir (the MoE ViT whole on one card: 12 flash launches a batch). (c)
    each of (a) and (b) again for one float32 step at n_critic 1 on the
    library routes (EP's at ``P28_HOLD_LAYERS`` of the 12 blocks), against
    one process at the global batch
    (``world_one_hold``; for (b) the one process's MoE term is the mean of
    the two shards' terms, as the EP term is). (a), (b) and (c)'s PP run run
    side by side, then (c)'s EP run beside the restores, generate and (c)'s
    PP hold. On the card :func:`pp_flash_holds` runs first.
    Prints s/step, the collectives' ms a step by kind
    (the pipeline's shifts and broadcast, EP's all-to-alls), the launches a
    step per rank, peak memory and state bytes per rank, and the share of
    (b)'s routing choices that capacity dropped. ``sizes`` and
    ``extra_sets`` shrink it for a dry run on the CPU (launch counts then
    printed, not held). Returns the numbers."""
    import torch

    from sgg_torch.cli import generate
    from sgg_torch.train.checkpoint import CheckpointManager, load_workdir
    from sgg_torch.train.state import create_train_state

    z_ = {"steps": P28_STEPS, "images": VIT_IMAGES, "gen_images": P28_GEN_IMAGES, "k": P28_K,
          **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    out = {"launches": {k_: 0 for k_ in kernel_counts()}}
    bad = []
    base = {"data.num_synthetic_images": z_["images"], "train.log_every": 1,
            **(extra_sets or {})}
    nc, layers = int(base.get("train.n_critic", 5)), int(base.get("model.vit_layers", 12))
    runs = {"a": (f"PP over mesh.model=2, {P28_MICRO} microbatches, frozen encoder",
                  {"mesh.model": 2, "model.pp_microbatches": P28_MICRO,
                   "mesh.partition": "gspmd"}, ("g_params", "d_params"),
                  {"flash_attention": (nc + 1) * (layers // 2) * P28_MICRO}),
            "b": (f"EP over mesh.expert=2, {P28_EXPERTS} experts top-{P28_TOP_K}, "
                  "train_encoder",
                  {"train.train_encoder": "true", "model.moe_experts": P28_EXPERTS,
                   "model.moe_top_k": P28_TOP_K, "mesh.expert": 2,
                   "mesh.partition": "gspmd"}, ("g_params", "d_params", "enc_params"),
                  {"flash_attention": (nc + 1) * layers, "flash_attention_bwd_dq": nc * layers,
                   "flash_attention_bwd_dkv": nc * layers})}

    def argv(wd, sets, steps=z_["steps"]):
        a_ = ["--config", "vit_b16", "--workdir", wd, "--steps", str(steps)]
        for k_, v_ in sets.items():
            a_ += ["--set", f"{k_}={v_}"]
        return a_ + ([] if on_card else ["--device", "cpu"])

    def add_launches(recs):
        for x_ in recs:
            for c_ in x_["per_step"]:
                for k_, v_ in c_.items():
                    out["launches"][k_] += v_

    def per_step_ms(recs, names):  # each rank's mean ms a step after the first
        return [round(sum(sum(c_.get(n_, 0.0) for n_ in names) for c_ in x_["coll_by"][1:])
                      / max(len(x_["coll_by"]) - 1, 1), 3) for x_ in recs]

    f32 = {"model.compute_dtype": "float32", "model.use_pallas": "false",
           "train.checkpoint_every": 1, "train.n_critic": 1}
    if on_card:
        t_h = time.perf_counter()
        out["flash_worst"], held = pp_flash_holds(dev, smi)
        bad += held
        out["flash_s"] = time.perf_counter() - t_h
    parts = {}  # the wall seconds of each part
    with tempfile.TemporaryDirectory() as tmp:
        def launch(k_):  # (a), (b), or (c)'s float32 run of either ("ca", "cb")
            if k_ in runs:
                return dp_launch(os.path.join(tmp, f"out_{k_}"),
                                 argv(os.path.join(tmp, f"wd_{k_}"), {**base, **runs[k_][1]}),
                                 2, torchrun=False,
                                 env_extra={"SGG_SMOKE_FIRST": "1", "SGG_SMOKE_MOE": "1"})
            cut = {"model.vit_layers": min(P28_HOLD_LAYERS, layers)} if k_ == "cb" else {}
            return dp_launch(os.path.join(tmp, f"out_{k_}"),
                             argv(os.path.join(tmp, f"wd_{k_}"),
                                  {**base, **runs[k_[1]][1], **f32, **cut}, steps=1),
                             2, torchrun=False,
                             env_extra={"SGG_SMOKE_FIRST": "1", "SGG_SMOKE_NO_DIGESTS": "1"})

        # (a) beside (b), and (c)'s float32 PP run beside both (it is small).
        t_c = time.perf_counter()
        (*done, done_ca), wall = in_threads(launch, [("a",), ("b",), ("ca",)])
        parts["(a), (b) and (c)'s PP run"] = wall
        for (key, (label, _, _, want_step)), (recs, text) in zip(runs.items(), done):
            wd = os.path.join(tmp, f"wd_{key}")
            lines = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_]
            whole = re.findall(r"state bytes on this rank: ([\d,]+) \(data parallel: ([\d,]+)\)",
                               text)
            r_ = {"s": wall, "s_per_step": 1 / lines[-1]["steps_per_sec"],
                  "coll_ms": [x_["coll_ms"][1:] for x_ in recs],
                  "shift_ms": per_step_ms(recs, ("shift_tensors", "broadcast_tensor")),
                  "a2a_ms": per_step_ms(recs, ("all_to_all_tensor",)),
                  "peak_gb": [x_["peak_gb"] for x_ in recs],
                  "state_bytes": [x_["state_bytes"] for x_ in recs],
                  "dp_bytes": int(whole[0][1].replace(",", "")),
                  "dropped": [x_.get("moe_dropped") for x_ in recs],
                  "per_step": [x_["per_step"] for x_ in recs],
                  "finite": all(math.isfinite(l_["d_loss"]) and math.isfinite(l_["g_loss"])
                                for l_ in lines)}
            add_launches(recs)
            sd = torch.load(os.path.join(wd, "checkpoints", str(z_["steps"]), "state.pt"),
                            map_location="cpu", weights_only=True)
            held = []
            if on_card and any([{k_: v_ for k_, v_ in c_.items() if v_} for c_ in x_["per_step"]]
                               != [want_step] * len(x_["per_step"]) for x_ in recs):
                held.append(f"launches {r_['per_step']} (expected {want_step} a step)")
            if any(x_["global_digests"] != recs[0]["global_digests"] for x_ in recs) or \
                    digest(tree_tensors(sd)) != recs[0]["global_digests"]:
                held.append("the ranks' gathered states differ, or differ from the checkpoint")
            if not r_["finite"]:
                held.append("a loss is not finite")
            if key == "b" and not all(b_ < r_["dp_bytes"] for b_ in r_["state_bytes"]):
                held.append("a rank holds no less than data parallelism")
            del sd
            log(f"phase 28 ({key}) {label}, vit_b16, 2 ranks (beside the other run's two and "
                f"(c)'s PP run): {r_['s_per_step']:.4f} s/step; collectives ms a step per rank "
                f"(host clock, after the first) {r_['coll_ms']}, of them the pipeline's shifts "
                f"and broadcast {r_['shift_ms']}, EP's all-to-alls {r_['a2a_ms']}; launches a "
                f"step per rank {[x_['per_step'][-1] for x_ in recs]} (expected {want_step}); "
                f"peak GB per rank {r_['peak_gb']}; state bytes per rank {r_['state_bytes']} "
                f"(data parallel {r_['dp_bytes']}); routing choices dropped per rank "
                f"{r_['dropped']}; {r_['s']:.3f} s [{smi}]: "
                f"{'ok' if not held else 'FAILED: ' + '; '.join(held)}")
            bad += [f"({key}) {h_}" for h_ in held]
            out[key] = r_

        def restores():
            """Each checkpoint restored into one process's state on the card,
            then generate on (b)'s: the MoE ViT whole on one card."""
            t_r = time.perf_counter()
            for key, (recs, _) in zip(runs, done):
                wd = os.path.join(tmp, f"wd_{key}")
                cfg_r, _ = load_workdir(wd)
                st = create_train_state(cfg_r, cfg_r.train.seed, device=dev)
                ok_r = (CheckpointManager(wd, None).restore(st, lenient=False) is not None
                        and digest(tree_tensors(st.state_dict())) == recs[0]["global_digests"])
                log(f"phase 28 ({key}) its checkpoint restored in one process: "
                    f"{'ok' if ok_r else 'FAILED'}")
                if not ok_r:
                    bad.append(f"({key}) the checkpoint did not restore the gathered state")
                del st
            gen_out = os.path.join(tmp, "graphs_b.json")
            gen_s, gen_counts = run_cli(generate.main, [
                "--workdir", os.path.join(tmp, "wd_b"), "--out", gen_out, "--split", "train",
                "--num-images", str(z_["gen_images"]), "--batch-size", "32",
                "--num-samples", str(z_["k"]), "--seed", str(SEED)]
                + ([] if on_card else ["--device", "cpu"]), "sgg_torch.cli.generate")
            want_gen = {k_: 0 for k_ in kernel_counts()}
            want_gen["flash_attention"] = math.ceil(z_["gen_images"] / 32) * layers
            with open(gen_out) as f:
                graphs = json.load(f)["scene_graphs"]
            parts["the restores and generate"] = time.perf_counter() - t_r
            log(f"phase 28 (b) generate on the EP checkpoint: {gen_s:.3f} s, {len(graphs)} "
                f"graphs, launches {gen_counts} (expected {want_gen}); the restores and it "
                f"{parts['the restores and generate']:.3f} s")
            for k_, v_ in gen_counts.items():
                out["launches"][k_] += v_
            if len(graphs) != z_["gen_images"] or (on_card and gen_counts != want_gen):
                bad.append("(b) generate on the EP checkpoint")
            if on_card:
                torch.cuda.empty_cache()
            hold_c("a")  # in this thread: create_train_state seeds the global generator

        out["c"] = {}

        def hold_c(key):
            label, _, trained, _ = runs[key]
            t_w = time.perf_counter()
            ok_c, hold = world_one_hold(dev, os.path.join(tmp, f"wd_c{key}"),
                                        os.path.join(tmp, f"out_c{key}"), 1, 2, trained,
                                        moe_shards=2 if key == "b" else 1)
            log(f"phase 28 (c) float32, {label}, against one process: "
                f"{'ok' if ok_c else 'FAILED'} {hold}")
            out["c"][key] = hold
            parts[f"(c) {key}'s one process"] = time.perf_counter() - t_w
            if not ok_c:
                bad.append(f"(c) {key}: {hold['bad']}")

        # (c)'s float32 EP run beside the restores, generate and (c)'s PP hold.
        (done_cb, _), parts["(c)'s EP run beside the restores"] = in_threads(
            lambda k_: launch(k_) if k_ == "cb" else restores(), [("cb",), ("restores",)])
        for recs_c, _ in (done_ca, done_cb):
            add_launches(recs_c)
        hold_c("b")
        out["c_s"] = time.perf_counter() - t_c
        out["parts"] = {k_: round(v_, 3) for k_, v_ in parts.items()}
    if bad:
        raise AssertionError(f"phase 28: {'; '.join(bad)}")
    return out


def phase28_line(v28, smi):
    a_, b_ = v28["a"], v28["b"]
    return (f"phase 28: PP over mesh.model=2 {a_['s_per_step']:.4f} s/step, shifts and "
            f"broadcast {a_['shift_ms']} ms a step, peak GB {a_['peak_gb']}, state bytes "
            f"{a_['state_bytes']} (DP {a_['dp_bytes']}); EP over mesh.expert=2 "
            f"{b_['s_per_step']:.4f} s/step, all-to-alls {b_['a2a_ms']} ms a step, peak GB "
            f"{b_['peak_gb']}, state bytes {b_['state_bytes']} (DP {b_['dp_bytes']}), dropped "
            f"{b_['dropped']}; all of it with the float32 holds {v28['c_s']:.3f} s (of it "
            f"{v28['parts']}; the flash holds before it {v28.get('flash_s', 0.0):.3f} s); "
            f"launches {v28['launches']} [{smi}]")


def zero_counts():
    """Set every kernel wrapper's launch count to 0."""
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import flash_attention as fa
    from sgg_torch.kernels import flash_attention_bwd as fb
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.kernels import matmul as mm

    fd.launches = mm.launches = cd.launches = fa.launches = 0
    fb.dq_launches = fb.dkv_launches = 0


def run_cli(main_fn, argv, what):
    """(seconds, launch counts) of one in-process CLI run; the counts are
    set to 0 just before it and read just after."""
    import torch

    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    zero_counts()
    t_run = time.perf_counter()
    rc = main_fn(argv)
    if on_card:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = kernel_counts()
    if rc != 0:
        raise AssertionError(f"{what} returned {rc}")
    return run_s, counts


def vg1k_reference_vocab(n_tokens):
    """A vocab of ``n_tokens`` (two specials, 7/8 objects, the rest
    predicates) on long-tailed counts."""
    from sgg_torch.data import Vocab

    n_obj = (n_tokens - 2) * 7 // 8
    n_pred = n_tokens - 2 - n_obj
    return Vocab.build({f"object{i}": 10**6 - i for i in range(n_obj)},
                       {f"predicate{i}": 10**6 - i for i in range(n_pred)})


def convert_grain_phase(dev, smi, sizes=None, extra_sets=None, v4_sets=None, vg_sets=None,
                        before=None):
    """Phase 25, A9's rest: (a) ``sgg_torch.convert.read_tf_checkpoint`` on the
    committed TensorFlow-written fixture (``tests/fixtures_torch/tf1_ckpt``)
    against its ``.npz``, bit for bit, with TensorFlow absent; (b) at vg1k's
    widths with a vocab of 1,024, reference-named arrays seeded by numpy
    written as an ``.npz`` and as a V2 bundle (``write_tf_checkpoint``), the
    bundle read back bit for bit, the CRC32C timed over every tensor,
    ``sgg_torch.cli.convert --config vg1k`` from each (the two workdirs
    equal, the arrays in place), then ``sgg_torch.cli.generate --decode
    fused`` on the converted workdir with its exact ``fused_decode`` launch
    count, and the fused sampler on the converted weights held against the
    CPU's plain decode on the same noise (phase 6's gate); (c) ``train
    --config pipeline_v4 --set data.loader=grain data.grain_workers=2`` on a
    seeded corpus, 15 steps with ``--profile`` unbroken, then
    resumed without workers from the unbroken run's checkpoint at step 10
    (state and sidecar, copied to a workdir of its own) by ``python -m
    sgg_torch.cli.train`` in a fresh process (whose first step is the
    process's first; the step launches no kernel): its state at 15 equals
    the unbroken run's bit for bit;
    (d) ``train --config vg_full`` on the host route with the grain loader's
    two spawned workers decoding the fixture's JPEGs (nvJPEG on the card's
    machine), 2 steps, 96 ``conv_direct`` launches a step. ``before`` holds phase 20's
    and 21's figures to print beside (c) and (d) when they ran. Returns the
    numbers and ``launches`` (the runs' kernel launches, each counted from
    0)."""
    import numpy as np
    import torch

    from sgg_torch import convert as conv
    from sgg_torch.cli import convert as convert_cli
    from sgg_torch.cli import generate as generate_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.config import get_config
    from sgg_torch.convert_flax import (
        critic_state_dict_to_flax,
        encoder_state_dict_to_flax,
        generator_state_dict_to_flax,
    )
    from sgg_torch.data import Vocab, write_feature_shard
    from sgg_torch.data.shards import shard_name
    from sgg_torch.eval.sampler import make_fused_sampler
    from sgg_torch.models.discriminator import TripleCritic
    from sgg_torch.models.encoders import make_encoder
    from sgg_torch.train.checkpoint import load_generator
    from sgg_torch.train.state import make_generator
    from sgg_torch.utils.gumbel import sample_gumbel

    z_ = {"vocab": P25_VOCAB, "images": P25_GEN_IMAGES, "v4_images": P25_V4_IMAGES,
          "v4_steps": P25_V4_STEPS, "v4_cut": P25_V4_CUT, "vg_images": P25_VG_IMAGES,
          "vg_steps": P25_VG_STEPS, "workers": P25_WORKERS, "image_size": 224,
          "hold_rows": 16, **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    before = before or {}
    out, launches = {}, {}

    def add(counts):
        for k_, v_ in counts.items():
            launches[k_] = launches.get(k_, 0) + v_

    def argv_of(args, sets):
        argv = list(args)
        for k_, v_ in sets.items():
            argv += ["--set", f"{k_}={v_}"]
        return argv + ([] if on_card else ["--device", "cpu"])

    # (a) The TensorFlow-written fixture, read here without TensorFlow.
    t_a = time.perf_counter()
    got = conv.read_tf_checkpoint(TF1_FIXTURE)
    with np.load(os.path.join(TF1_FIXTURE, "arrays.npz")) as zf:
        want = {k_: zf[k_] for k_ in zf.files}
    ok_a = sorted(got) == sorted(want) and all(
        got[k_].dtype == want[k_].dtype and got[k_].tobytes() == want[k_].tobytes()
        for k_ in want)
    tf_loaded = "tensorflow" in sys.modules
    log(f"phase 25 (a) the TensorFlow-written fixture ({len(got)} variables, "
        f"{sum(a_.nbytes for a_ in got.values())} bytes) read without TensorFlow (imported: "
        f"{tf_loaded}) against its .npz, bit for bit: {'ok' if ok_a else 'FAILED'} in "
        f"{time.perf_counter() - t_a:.3f} s")
    if not ok_a or tf_loaded:
        raise AssertionError("phase 25 (a): the reader disagrees with the fixture's arrays")

    with tempfile.TemporaryDirectory() as root:
        # (b) vg1k's widths, a vocab of 1,024: .npz and a V2 bundle -> convert.
        vocab = vg1k_reference_vocab(z_["vocab"])
        vocab_path = os.path.join(root, "vocab.json")
        vocab.save(vocab_path)
        cfg = get_config("vg1k").override(
            [f"{k_}={v_}" for k_, v_ in (extra_sets or {}).items()])
        cfg.model.vocab_size = len(vocab)
        g_tree = generator_state_dict_to_flax(make_generator(cfg).state_dict())
        d_tree = critic_state_dict_to_flax(TripleCritic.from_config(cfg).state_dict())
        sys.path.insert(0, TF1_FIXTURE)
        from make_fixture import reference_names

        arrays = reference_names(g_tree, d_tree, np.random.RandomState(SEED + 50))
        arrays["global_step"] = np.int64(100_000)
        nbytes = sum(a_.nbytes for a_ in arrays.values())
        npz, prefix = os.path.join(root, "ref.npz"), os.path.join(root, "tf", "model.ckpt")
        np.savez(npz, **arrays)
        t_w = time.perf_counter()
        conv.write_tf_checkpoint(prefix, arrays)
        write_s = time.perf_counter() - t_w
        t_crc = time.perf_counter()
        for a_ in arrays.values():
            conv.crc32c(np.ascontiguousarray(a_))
        crc_s = time.perf_counter() - t_crc
        t_r = time.perf_counter()
        back = conv.read_tf_checkpoint(prefix)
        read_s = time.perf_counter() - t_r
        ok_rt = sorted(back) == sorted(arrays) and all(
            back[k_].tobytes() == np.asarray(a_).tobytes() for k_, a_ in arrays.items())
        log(f"phase 25 (b) vg1k widths (V {len(vocab)}, H {cfg.model.hidden}, E "
            f"{cfg.model.embed_dim}, A {cfg.model.attn_dim}, F {cfg.data.feat_dim}): "
            f"{len(arrays)} reference variables, {nbytes / 1e6:.3f} MB; bundle written in "
            f"{write_s:.3f} s, read back (CRC checked) in {read_s:.3f} s, bit for bit "
            f"{'ok' if ok_rt else 'FAILED'}; CRC32C (numpy) over every tensor {crc_s:.3f} s "
            f"({nbytes / 1e6 / crc_s:.1f} MB/s on this host)")
        if not ok_rt:
            raise AssertionError("phase 25 (b): the bundle does not round-trip")
        wds = {}
        for how, src in (("tf", ["--tf-ckpt", prefix]), ("npz", ["--npz", npz])):
            wds[how] = os.path.join(root, f"wd_{how}")
            s_, c_ = run_cli(convert_cli.main, argv_of(
                ["--config", "vg1k", "--workdir", wds[how], "--vocab", vocab_path, *src],
                extra_sets or {}), f"sgg_torch.cli.convert {how}")
            out[f"convert_{how}_s"] = s_
            add(c_)
        sd_tf = torch.load(os.path.join(wds["tf"], "checkpoints", "0", "state.pt"),
                           weights_only=True)
        sd_np = torch.load(os.path.join(wds["npz"], "checkpoints", "0", "state.pt"),
                           weights_only=True)
        same = all(torch.equal(sd_tf[p_][k_], sd_np[p_][k_])
                   for p_ in ("g_params", "d_params") for k_ in sd_tf[p_])
        placed = np.array_equal(
            generator_state_dict_to_flax(sd_tf["g_params"])["TF1LSTMCell_0"]["kernel"],
            arrays["generator/rnn/basic_lstm_cell/kernel"]) and np.array_equal(
            critic_state_dict_to_flax(sd_tf["d_params"])["ln_0"]["scale"],
            arrays["discriminator/ln_0/gamma"])
        log(f"phase 25 (b) sgg_torch.cli.convert --config vg1k: from the bundle "
            f"{out['convert_tf_s']:.3f} s, from the .npz {out['convert_npz_s']:.3f} s wall in "
            f"process; the two workdirs equal {same}, the arrays in place {placed}")
        if not (same and placed):
            raise AssertionError("phase 25 (b): the converted workdirs disagree")
        n_img, K_ = z_["images"], K
        gen_out = os.path.join(root, "graphs.json")
        gen_s, gen_c = run_cli(generate_cli.main, argv_of(
            ["--workdir", wds["tf"], "--out", gen_out, "--num-samples", str(K_), "--decode",
             "fused", "--batch-size", str(BATCH), "--num-images", str(n_img), "--seed",
             str(SEED)], {}), "sgg_torch.cli.generate on the converted workdir")
        add(gen_c)
        want_launches = math.ceil(n_img / BATCH) * K_ if on_card else 0
        with open(gen_out) as f:
            graphs = json.load(f)["scene_graphs"]
        n_unique = legal_graphs(graphs, vocab, K_, gen_out)
        log(f"phase 25 (b) generate --decode fused on the converted workdir: {n_img} images in "
            f"{gen_s:.3f} s in process, fused_decode launches {gen_c['fused_decode']} "
            f"(expected {want_launches}), {n_unique} unique triples, all type-legal")
        if gen_c["fused_decode"] != want_launches:
            raise AssertionError("phase 25 (b): generate did not launch fused_decode as expected")
        g_sd = load_generator(wds["tf"])["g_params"]
        Ks, Bs = 8, z_["hold_rows"]
        sampler = make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=Ks)
        hold_gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        feats = torch.randn(Bs, cfg.data.regions, cfg.data.feat_dim, generator=hold_gen,
                            device=dev)
        zn = torch.randn(Ks, Bs, cfg.model.noise_dim, generator=hold_gen, device=dev)
        gn = sample_gumbel((Ks, Bs, 3, len(vocab)), hold_gen, device=dev)
        dev_tok = sampler({k_: v_.to(dev) for k_, v_ in g_sd.items()}, feats,
                          noise=(zn, gn)).cpu()
        cpu_tok = sampler(g_sd, feats.cpu(), noise=(zn.cpu(), gn.cpu()))
        agree = (dev_tok == cpu_tok).float().mean().item()
        log(f"phase 25 (b) the converted weights: fused sampler on {dev} vs the CPU's plain "
            f"decode, same noise ({Ks} draws x {Bs} rows): {agree:.4f} identical (>= 0.99)")
        if dev_tok.shape != (Bs, Ks, 3) or agree < 0.99:
            raise AssertionError("phase 25 (b): the kernel disagrees with the plain decode")
        out.update(generate_s=gen_s, fused_decode=gen_c["fused_decode"], agree=agree,
                   crc_s=crc_s, read_s=read_s, mb=nbytes / 1e6)

        # (c) pipeline_v4 on the grain loader: unbroken, and cut and resumed.
        t_c = time.perf_counter()
        v4_vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
        v4_cfg = get_config("pipeline_v4").override(
            [f"{k_}={v_}" for k_, v_ in (v4_sets or {}).items()])
        data_dir = os.path.join(root, "v4")
        os.makedirs(data_dir)
        v4_vocab.save(os.path.join(data_dir, "vocab.json"))
        feats4, tri4 = v4_corpus(v4_vocab, z_["v4_images"], SEED + 52, dev,
                                 v4_cfg.data.regions, v4_cfg.data.feat_dim)
        half = z_["v4_images"] // 2
        for s_ in range(2):
            sl = slice(s_ * half, (s_ + 1) * half)
            write_feature_shard(os.path.join(data_dir, shard_name(s_, 2)),
                                np.arange(sl.start, sl.stop), feats4[sl], tri4[sl])
        del feats4
        corpus_s = time.perf_counter() - t_c
        sets4 = {**(v4_sets or {}), "data.data_dir": data_dir, "data.loader": "grain",
                 "data.grain_workers": z_["workers"], "train.log_every": 1,
                 "train.checkpoint_every": z_["v4_cut"], "train.eval_every": 0}

        def v4_run(label, steps, profile=False, workers=z_["workers"]):
            wd = os.path.join(root, f"v4_{label}")
            printed = io.StringIO()
            with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
                s_, c_ = run_cli(train_cli.main, argv_of(
                    ["--config", "pipeline_v4", "--workdir", wd, "--steps", str(steps)]
                    + (["--profile"] if profile else []),
                    {**sets4, "data.grain_workers": workers}),
                    f"sgg_torch.cli.train pipeline_v4 grain {label}")
            add(c_)
            return wd, s_, printed.getvalue()

        whole_wd, whole_s, whole_txt = v4_run("whole", z_["v4_steps"], profile=True)
        # The cut: the unbroken run's checkpoint at v4_cut (state and
        # sidecar), in a workdir of its own, resumed to the end without
        # workers (the batches do not depend on their number).
        cut_wd, cut_at = os.path.join(root, "v4_cut"), str(z_["v4_cut"])
        os.makedirs(os.path.join(cut_wd, "checkpoints"))
        for f_ in ("config.json", "vocab.json"):
            shutil.copy(os.path.join(whole_wd, f_), cut_wd)
        shutil.copytree(os.path.join(whole_wd, "checkpoints", cut_at),
                        os.path.join(cut_wd, "checkpoints", cut_at))
        shutil.copy(os.path.join(whole_wd, "checkpoints", f"data_iter_{cut_at}.bin"),
                    os.path.join(cut_wd, "checkpoints"))
        # The resume runs in a fresh process: its first step is the one
        # under test (C3, a process's first step summing as later ones do).
        t_r = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sgg_torch.cli.train", *argv_of(
                ["--config", "pipeline_v4", "--workdir", cut_wd, "--steps",
                 str(z_["v4_steps"])], {**sets4, "data.grain_workers": 0})],
            cwd=ROOT, capture_output=True, text=True, timeout=P25_RESUME_TIMEOUT_S)
        res_s, res_txt = time.perf_counter() - t_r, proc.stdout
        if proc.returncode != 0:
            raise AssertionError(f"phase 25 (c): the resumed run exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        ref = torch.load(os.path.join(whole_wd, "checkpoints", str(z_["v4_steps"]), "state.pt"),
                         weights_only=True)
        got4 = torch.load(os.path.join(cut_wd, "checkpoints", str(z_["v4_steps"]), "state.pt"),
                          weights_only=True)

        def flat(x, pre=""):
            if torch.is_tensor(x):
                return {pre: x}
            if isinstance(x, dict):
                return {k2: v2 for k_, v_ in x.items() for k2, v2 in flat(v_, f"{pre}/{k_}").items()}
            if isinstance(x, (list, tuple)):
                return {k2: v2 for i_, v_ in enumerate(x) for k2, v2 in flat(v_, f"{pre}/{i_}").items()}
            return {pre: torch.tensor(float(x))} if x is not None else {}

        fa_, fb_ = flat(ref), flat(got4)
        differ = sorted(k_ for k_ in fa_ if k_ not in fb_ or not torch.equal(fa_[k_], fb_[k_]))
        lines = [r_ for r_ in read_metric_lines(whole_wd) if "d_loss" in r_]
        s_steps = [1 / r_["steps_per_sec"] for r_ in lines[1:] if "steps_per_sec" in r_]
        s_per_step = statistics.median(s_steps)
        idle, _ = read_profile(whole_wd, "pipeline_v4 grain")
        wait = re.search(r"grain loader: (\d+) super-batches, ([\d.]+) s waiting", whole_txt)
        restored = "grain iterator state restored (exact mid-epoch resume)" in res_txt
        fell_back = "falling back to per-step dispatch" in whole_txt
        e20 = before.get("v20")
        beside = (f"phase 20's eager run {e20['s_per_step']:.4f} s/step, idle {e20['idle']}"
                  if e20 else "phase 20 did not run in this process (PERF.md: eager 0.3497-0.3546 "
                  "s/step, idle 0.91-0.93)")
        log(f"phase 25 (c) train pipeline_v4 --set data.loader=grain data.grain_workers="
            f"{z_['workers']}: corpus {z_['v4_images']} images in {corpus_s:.3f} s; unbroken "
            f"{z_['v4_steps']} steps in {whole_s:.3f} s in process, median {s_per_step:.4f} "
            f"s/step, idle share {idle}, {wait.group(2) if wait else None} s waiting for "
            f"{wait.group(1) if wait else None} super-batches; its checkpoint at "
            f"{z_['v4_cut']} resumed to {z_['v4_steps']} without workers in a fresh process "
            f"({res_s:.3f} s, start-up included): "
            f"restored line "
            f"{restored}, "
            f"{len(differ)} of {len(fa_)} state tensors differ from the unbroken run's; "
            f"steps_per_dispatch fallback line {fell_back}; beside {beside} [{smi}]")
        if differ or not restored or not fell_back:
            raise AssertionError(f"phase 25 (c): the resumed grain run differs at {differ[:8]}")
        out["v4"] = {"s_per_step": s_per_step, "idle": idle, "whole_s": whole_s,
                     "wait_s": float(wait.group(2)) if wait else None}

        # (d) vg_full on the grain loader: spawned workers decode the JPEGs.
        vg_dir, ckpt = os.path.join(root, "vg"), os.path.join(root, "ckpt")
        vg_corpus(vg_dir, z_["vg_images"])
        torch.manual_seed(SEED + 53)
        os.makedirs(ckpt)
        np.savez(os.path.join(ckpt, "encoder_params.npz"),
                 **encoder_state_dict_to_flax(make_encoder("vgg19").state_dict(),
                                              "vgg19")["params"])
        with open(os.path.join(ckpt, "pretrain_meta.json"), "w") as f:
            json.dump({"encoder": "vgg19", "image_size": z_["image_size"],
                       "vit_dims": [768, 12, 12], "moe_experts": 0, "moe_top_k": 2}, f)
        vg_wd = os.path.join(root, "vg_wd")
        setsd = {**(vg_sets or {}), "data.data_dir": vg_dir, "data.loader": "grain",
                 "data.grain_workers": z_["workers"], "train.log_every": 1,
                 "train.checkpoint_every": z_["vg_steps"], "train.eval_every": 0}
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            vg_s, vg_c = run_cli(train_cli.main, argv_of(
                ["--config", "vg_full", "--workdir", vg_wd, "--steps", str(z_["vg_steps"]),
                 "--encoder-ckpt", ckpt], setsd), "sgg_torch.cli.train vg_full grain")
        add(vg_c)
        txt = printed.getvalue()
        dec = re.search(r"host decode: (\d+) images in ([\d.]+) s \(([\d.]+) s per step of "
                        r"(\d+) images", txt)
        wait = re.search(r"grain loader: (\d+) super-batches, ([\d.]+) s waiting", txt)
        vg_lines = [r_ for r_ in read_metric_lines(vg_wd) if "d_loss" in r_]
        vg_cfg = get_config("vg_full").override([f"{k_}={v_}" for k_, v_ in setsd.items()])
        per_step = vg_cfg.train.batch_size * (vg_cfg.train.n_critic + 1)
        want_conv = 16 * (vg_cfg.train.n_critic + 1) * z_["vg_steps"] if on_card else 0
        ok_d = (dec is not None and int(dec.group(1)) == per_step * z_["vg_steps"]
                and f"grain loader (workers={z_['workers']})" in txt
                and vg_c["conv_direct"] == want_conv
                and [r_["step"] for r_ in vg_lines] == list(range(1, z_["vg_steps"] + 1)))
        h21 = (before.get("v21") or {}).get("train", {}).get("host")
        beside = (f"phase 21's host-prefetch {h21['decode_s_per_step']} s a step" if h21 else
                  "phase 21 did not run in this process (PERF.md: host-prefetch 0.50-0.54 s a "
                  "step)")
        log(f"phase 25 (d) train vg_full --set data.loader=grain data.grain_workers="
            f"{z_['workers']}: {z_['vg_steps']} steps in {vg_s:.3f} s in process, last step "
            f"{1 / vg_lines[-1]['steps_per_sec']:.4f} s/step; the workers decoded "
            f"{dec.group(1) if dec else None} images in {dec.group(2) if dec else None} s "
            f"({dec.group(3) if dec else None} s of decode a step of {per_step} images, summed "
            f"over the workers); the step waited {wait.group(2) if wait else None} s for "
            f"{wait.group(1) if wait else None} super-batches; conv_direct launches "
            f"{vg_c['conv_direct']} (expected {want_conv}); beside {beside}: "
            f"{'ok' if ok_d else 'FAILED'} [{smi}]")
        if not ok_d:
            raise AssertionError("phase 25 (d): the grain run's decode, steps or launches are off")
        out["vg"] = {"s": vg_s, "s_per_step": 1 / vg_lines[-1]["steps_per_sec"],
                     "decode_s_per_step": float(dec.group(3)),
                     "wait_s": float(wait.group(2)) if wait else None}
    out["launches"] = launches
    return out


def float64_mode():
    """A ``TorchFunctionMode`` under which the port's float32 code computes in
    float64: ``Tensor.float()``, a cast to ``torch.float32`` and a factory
    asked for ``dtype=torch.float32`` give float64, and the default dtype is
    float64 while the mode is on."""
    import torch
    from torch.overrides import TorchFunctionMode

    f32, f64 = torch.float32, torch.float64

    class Float64(TorchFunctionMode):
        def __enter__(self):
            self._default = torch.get_default_dtype()
            torch.set_default_dtype(f64)
            return super().__enter__()

        def __exit__(self, *exc):
            torch.set_default_dtype(self._default)
            return super().__exit__(*exc)

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.float:
                return args[0].to(f64)
            kwargs = {k_: f64 if v_ is f32 else v_ for k_, v_ in (kwargs or {}).items()}
            return func(*(f64 if a_ is f32 else a_ for a_ in args), **kwargs)

    return Float64()


class _Recorded(Exception):
    """Raised once a step's first critic update has handed its gradients over."""


def first_update_grads(cfg, seed, data, noise, device, float64=False):
    """One ``train_encoder`` step of ``make_step_fn(cfg)`` on ``device`` from
    ``create_train_state(cfg, seed)``: (the metrics, the first critic update's
    gradients {"d": critic, "enc": encoder} as CPU tensors, the modules'
    parameters after the step). With ``float64`` the state is cast to float64
    and the step runs under ``float64_mode`` up to that update's gradients
    (the critic loss and the joint encoder path, ``torch.autograd.grad``),
    then stops: (None, the gradients, None)."""
    import torch

    from sgg_torch.train.state import create_train_state
    from sgg_torch.train.step import make_step_fn

    st = create_train_state(cfg, seed, device=device)
    rec = {}
    for key, tx in (("d", st.d_tx), ("enc", st.enc_tx)):
        update = tx.update

        def recording(g_, _u=update, _k=key):
            rec.setdefault(_k, [x_.detach().cpu() for x_ in g_])
            if float64 and _k == "enc":
                raise _Recorded
            return _u(g_)

        tx.update = recording
    batch = {k_: torch.from_numpy(v_).to(device) for k_, v_ in data.items()}
    noise = {k_: v_.to(device) for k_, v_ in noise.items()}
    if not float64:
        m_ = make_step_fn(cfg)(st, batch, noise)
        params = {"g_params": st.generator, "d_params": st.critic, "enc_params": st.encoder}
        return ({k_: float(v_) for k_, v_ in m_.items()}, rec,
                {k_: {n_: v_.detach().float().cpu() for n_, v_ in mod.state_dict().items()}
                 for k_, mod in params.items()})
    for mod in (st.generator, st.critic, st.encoder):
        mod.double()
    noise = {k_: v_.double() if v_.is_floating_point() else v_ for k_, v_ in noise.items()}
    try:
        with float64_mode():
            make_step_fn(cfg)(st, batch, noise)
    except _Recorded:
        return None, rec, None
    raise AssertionError("the float64 step ran past its first critic update")


def oracle_distance(grads, oracle):
    """The largest distance of ``grads`` from ``oracle`` over a module's
    tensors, each relative to the oracle tensor's largest element; and each
    tensor's."""
    per = [float((a_.double() - b_).abs().max() / b_.abs().max().clamp_min(1e-300))
           for a_, b_ in zip(grads, oracle)]
    return max(per), per


def cnn_hold_inputs(seed, batch, size, extra_sets=None):
    """``cnn_hold``'s config (``vg_full``, ``train_encoder``, float32, n_critic
    1, V 80), seeded batch (uint8 images and triples, numpy) and noise."""
    import numpy as np
    import torch

    from sgg_torch.config import get_config
    from sgg_torch.train.step import draw_noise

    sets = {"train.train_encoder": "true", "model.compute_dtype": "float32",
            "train.n_critic": 1, "train.batch_size": batch, "data.image_size": size,
            "model.vocab_size": 80, **(extra_sets or {})}
    cfg = get_config("vg_full").override([f"{k_}={v_}" for k_, v_ in sets.items()])
    r = np.random.RandomState(seed + 291)
    data = {"images": r.randint(0, 256, (2, batch, size, size, 3), dtype=np.uint8),
            "triples": r.randint(2, cfg.model.vocab_size, (2, batch, 3))}
    noise = draw_noise(cfg, batch, torch.Generator().manual_seed(seed + 292), "cpu")
    return cfg, data, noise


def cnn_hold(dev, seed=SEED, batch=P29_HOLD_BATCH, size=224, extra_sets=None,
             second_oracle=None):
    """Phase 29 (c): one ``vg_full`` step with ``train.train_encoder`` in
    float32 at n_critic 1 on the card and on the CPU, from one seeded state,
    batch and noise, and its first critic update's gradients in float64 (the
    oracle: the port's modules cast to float64 on a CPU copy of the state,
    under ``float64_mode``, ``first_update_grads``). The two float32
    runs compute one function; they differ in float32 sums (cuDNN's conv
    against the CPU's, TF32 never: float32 operands). n_critic 1 makes the
    metrics the critic update's, from the common state. The bounds:
      - each metric within 1e-4 relative plus 1e-6 (``world_one_hold``'s);
      - each module's parameters after the step (generator, critic,
        encoder): every element within 1e-6 + 1e-5 |p|, except at most 1 %
        of the module's elements, those within Adam's largest move, 2 lr C_1
        (``adam_step_bound``);
      - the critic's and the encoder's gradients: the card's distance from
        the oracle (the largest over a module's tensors, each relative to the
        oracle tensor's largest element, ``oracle_distance``) at most
        ``C4_FACTOR`` times the CPU's distance in the same run plus
        ``C4_FLOOR`` (``c4_gate``).
    With ``second_oracle`` (a device) the oracle is also computed there and
    the numbers say how far the two sit apart (``oracles_apart``).
    At initialization the critic scores real and fake triples nearly alike,
    so these gradients are differences of nearly equal terms and float32's
    rounding reaches a share of their elements on both devices; the gate
    asks that the card round no worse than the CPU.
    Returns (ok, numbers)."""
    import numpy as np

    cfg, data, noise = cnn_hold_inputs(seed, batch, size, extra_sets)
    t_ = cfg.train
    times = {}

    def timed(label, *a, **k):
        t0 = time.perf_counter()
        r_ = first_update_grads(cfg, seed, data, noise, *a, **k)
        times[label] = time.perf_counter() - t0
        return r_

    card, cpu = timed("card", dev), timed("cpu", "cpu")
    oracle = timed("oracle", "cpu", float64=True)[1]
    bad, nums = [], {"metrics": {}, "grads": {}, "params": {}, "seconds": times}
    if second_oracle is not None:
        other = timed("second_oracle", second_oracle, float64=True)[1]
        nums["oracles_apart"] = {k_: oracle_distance(other[k_], oracle[k_])[0] for k_ in oracle}
    for k_, v_ in cpu[0].items():
        d_ = abs(card[0][k_] - v_)
        nums["metrics"][k_] = (card[0][k_], v_, d_)
        if not d_ <= 1e-6 + 1e-4 * abs(v_):
            bad.append(f"{k_}: {card[0][k_]} against {v_}")
    for key in ("d", "enc"):
        (c_far, c_per), (p_far, p_per) = (oracle_distance(x_[1][key], oracle[key])
                                          for x_ in (card, cpu))
        ok, limit = c4_gate(c_far, p_far)
        worst = int(np.argmax(c_per))
        nums["grads"][key] = {"card": c_far, "cpu": p_far, "limit": limit,
                              "card_cpu": oracle_distance(card[1][key], cpu[1][key])[0],
                              "worst_tensor": worst, "cpu_at_worst": p_per[worst],
                              "per_tensor": list(zip(c_per, p_per))}
        if not ok:
            bad.append(f"{key} gradients: the card {c_far:.3e} from the float64 oracle, the "
                       f"CPU {p_far:.3e} (limit {limit:.3e})")
    move = 2 * adam_step_bound(float(t_.beta1), float(t_.beta2), 1)
    for tree, lr in (("g_params", t_.g_lr), ("d_params", t_.d_lr), ("enc_params", t_.enc_lr)):
        n_far = n_all = 0
        worst = 0.0
        for k_, w_ in cpu[2][tree].items():
            d_ = (card[2][tree][k_] - w_).abs()
            n_far += int((d_ > 1e-6 + 1e-5 * w_.abs()).sum())
            n_all += w_.numel()
            worst = max(worst, float(d_.max()))
        nums["params"][tree] = (n_far / n_all, worst, lr * move + 1e-6)
        if worst > lr * move + 1e-6 or n_far > 0.01 * n_all:
            bad.append(f"{tree}: {n_far} of {n_all} elements beyond 1e-6 + 1e-5 |p|, max |d| "
                       f"{worst:.3g} (bound {lr * move + 1e-6:.3g})")
    return not bad, {**nums, "bad": bad}


def c4_gate(card, cpu):
    """(whether the card's distance from the float64 oracle is at most
    ``C4_FACTOR`` times the CPU's plus ``C4_FLOOR``, that limit).

    The spread it comes from (``scripts/cnn_grad_spread.py``, seeds 0, 1, 2,
    an NVIDIA H100 80GB HBM3 at 700.00 W): the card's distance over the CPU's
    was 1.139, 0.705 and 5.427 for the critic and 1.048, 0.942 and 1.297 for
    the encoder, each distance 5.5e-4 to 1.3e-2 of the max; the two float64
    oracles, card and CPU, 1.3e-12 to 3.6e-12 apart. With cuDNN's TF32 on
    for the float32 convs (seed 0) the ratios were 561.2 and 33.4. The
    factor, 8, is about 1.5 times the largest sound ratio and a quarter of
    the smallest faulty one; the floor, 1e-6, keeps a CPU distance of 0
    from refusing a card at rounding."""
    limit = C4_FACTOR * cpu + C4_FLOOR
    return card <= limit, limit


def cnn_train_phase(dev, smi, sizes=None, extra_sets=None, r50_sets=None, hold_sets=None):
    """Phase 29, CNN encoders trained end to end on the configs that set
    ``model.use_pallas`` (the step's encoder on the library conv, the probe
    and generate on the kernels): (d) + (a) ``train --config vg_full`` on a
    VG-shaped corpus of 512 ids cycling the committed fixture (materialized),
    the frozen encoder (a seeded VGG-19 via ``--encoder-ckpt``) one step
    (96 conv_direct launches), then the same workdir resumed with
    ``train.train_encoder=true`` and ``train.grad_accum=4`` for 4 steps at
    full width (VGG-19 at 224 px, bf16, B 256, n_critic 5): the checkpoint
    restore's fallback line, the encoder's optimizer at zero when the first
    step begins, no kernel launch in a step, 16 conv_direct launches for the
    probe's one held-out batch of 64, every encoder tensor moved from the
    seeded weights; s/step, peak memory, enc_gnorm; the last step traced
    (``--profile``, its window moved onto it) and split by the step's regions
    (``read_regions``); (b) ``train --config
    resnet50 --set train.train_encoder=true`` (V 8,192 from ``vocab_of_size``,
    B 32, 224 px, bf16) 2 steps, no kernel launch in a step, then ``generate
    --decode fused`` on its checkpoint: exactly 13 conv_direct, 36
    fused_matmul and K fused_decode launches a batch of 32; (c) ``cnn_hold``;
    (e) the guard: ``conv2d_direct`` and ``fused_matmul`` raise on operands
    that need a gradient and launch nothing; (f) ``train --config v4_32 --set
    train.train_encoder=true`` under torchrun, two ranks sharing the card
    over gloo (B 128 a rank, grad_accum 2), 2 steps: the ranks' states equal
    bit for bit, their noise distinct, no kernel launch in a step
    (``dp_holds``). ``sizes``, ``extra_sets``,
    ``r50_sets`` and ``hold_sets`` shrink it for a dry run on the CPU
    (launches printed, not held). Returns the numbers."""
    import numpy as np
    import torch

    from sgg_torch.cli import generate as generate_cli
    from sgg_torch.cli import train as train_cli
    from sgg_torch.convert_flax import encoder_state_dict_to_flax
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import matmul as mm
    from sgg_torch.models.encoders import make_encoder
    from sgg_torch.utils.profiling import StepProfiler

    z_ = {"images": P29_IMAGES, "frozen": P29_FROZEN_STEPS, "steps": P29_STEPS,
          "accum": P29_ACCUM, "probe": P29_PROBE, "r50_steps": P29_R50_STEPS,
          "r50_batch": P29_R50_BATCH, "vocab": P29_R50_VOCAB, "gen_images": P29_GEN_IMAGES,
          "k": P29_K, "hold_batch": P29_HOLD_BATCH, "v4_steps": P29_V4_STEPS,
          "v4_accum": P29_V4_ACCUM, "image_size": 224, **(sizes or {})}
    on_card = torch.device(dev).type == "cuda"
    S = z_["image_size"]
    out = {"launches": {k_: 0 for k_ in kernel_counts()}}
    fallback = "[sgg_torch.checkpoint] strict restore failed (ValueError); falling back"

    def train(label, wd, config, steps, sets, extra=(), after=0, profile_at=None):
        """``profile_at``: the run's step (counted from its first) whose
        window of one step ``--profile`` traces."""
        argv = ["--config", config, "--workdir", wd, "--steps", str(steps), *extra]
        argv += [] if profile_at is None else ["--profile"]
        for k_, v_ in sets.items():
            argv += ["--set", f"{k_}={v_}"]
        per_step, first = [], {}
        make_step = train_cli.make_step_fn

        def counting(*a, **k):
            step_fn = make_step(*a, **k)

            @functools.wraps(step_fn)
            def counted(state, batch, *a2, **k2):
                tx = state.enc_tx
                if not first:
                    first["enc_opt_zero"] = tx is not None and tx.count == 0 and not any(
                        bool(t_.any()) for t_ in tx.mu + tx.nu)
                before = kernel_counts()
                r_ = step_fn(state, batch, *a2, **k2)
                after = kernel_counts()
                per_step.append({k_: after[k_] - before[k_] for k_ in after
                                 if after[k_] != before[k_]})
                return r_

            return counted

        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        printed, errs = io.StringIO(), io.StringIO()
        train_cli.make_step_fn = counting
        if profile_at is not None:  # the CLI's window opens 10 steps after its first
            train_cli.StepProfiler = lambda logdir, start_step: StepProfiler(
                logdir, start_step - 10 + profile_at, num_steps=1)
        try:
            with contextlib.redirect_stdout(Tee(sys.stdout, printed)), \
                    contextlib.redirect_stderr(Tee(sys.stderr, errs)):
                run_s, counts = run_cli(train_cli.main, argv + ([] if on_card else
                                                                ["--device", "cpu"]),
                                        f"sgg_torch.cli.train {config} {label}")
        finally:
            train_cli.make_step_fn, train_cli.StepProfiler = make_step, StepProfiler
        for k_, v_ in counts.items():
            out["launches"][k_] += v_
        logged = [r_ for r_ in read_metric_lines(wd) if "d_loss" in r_ and r_["step"] > after]
        last = logged[-1]  # a run's first logged step carries no rate
        r_ = {"s": run_s, "s_per_step": 1 / last["steps_per_sec"] if "steps_per_sec" in last
              else None, "images_per_s": last.get("images_per_sec"),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else float("nan"),
              "counts": counts, "per_step": per_step, "first": first, "logged": logged,
              "out": printed.getvalue(), "err": errs.getvalue()}
        if not all(math.isfinite(v_) for x_ in logged for v_ in x_.values()):
            raise AssertionError(f"phase 29 {label}: metrics.jsonl {logged}")
        return r_

    with tempfile.TemporaryDirectory() as tmp:
        vg_dir, ckpt, wd = (os.path.join(tmp, d_) for d_ in ("vg", "ckpt", "wd_vg"))
        vg_corpus(vg_dir, z_["images"])
        torch.manual_seed(SEED + 290)
        enc_sd = make_encoder("vgg19").state_dict()
        os.makedirs(ckpt)
        np.savez(os.path.join(ckpt, "encoder_params.npz"),
                 **encoder_state_dict_to_flax(enc_sd, "vgg19")["params"])
        with open(os.path.join(ckpt, "pretrain_meta.json"), "w") as f:
            json.dump({"encoder": "vgg19", "image_size": S, "vit_dims": [768, 12, 12],
                       "moe_experts": 0, "moe_top_k": 2}, f)

        # (d) the frozen twin, then (a) its workdir resumed with train_encoder.
        base = {**(extra_sets or {}), "data.data_dir": vg_dir, "train.log_every": 1,
                "train.eval_images": z_["probe"], "train.eval_samples": 8}
        t_d = time.perf_counter()
        fz = train("frozen", wd, "vg_full", z_["frozen"], {
            **base, "train.checkpoint_every": z_["frozen"], "train.eval_every": 0},
            extra=("--encoder-ckpt", ckpt))
        total = z_["frozen"] + z_["steps"]
        resume = {"train.checkpoint_every": total, "train.eval_every": total,
                     "train.train_encoder": "true", "train.grad_accum": z_["accum"]}
        te = train("train_encoder", wd, "vg_full", total, {**base, **resume},
                   extra=("--encoder-ckpt", ckpt), after=z_["frozen"],  # the checkpoint's win
                   profile_at=z_["steps"] - 1)  # the last step
        nc = int((extra_sets or {}).get("train.n_critic", 5))
        sd = torch.load(os.path.join(wd, "checkpoints", str(total), "state.pt"),
                        map_location="cpu", weights_only=True)
        moved = sum(not torch.equal(sd["enc_params"][k_].float(), v_.float())
                    for k_, v_ in enc_sd.items())
        step_counts = [c_.get("conv_direct", 0) for c_ in te["per_step"]]
        probe = te["counts"]["conv_direct"] - sum(step_counts)
        gnorms = [x_["enc_gnorm"] for x_ in te["logged"]]
        a_ok = (fallback in te["err"] and f"resumed from step {z_['frozen']}" in te["out"]
                and te["first"].get("enc_opt_zero") is True
                and [x_["step"] for x_ in te["logged"]] == list(range(z_["frozen"] + 1,
                                                                      total + 1))
                and all(g_ > 0 for g_ in gnorms) and moved == len(enc_sd)
                and sd["enc_opt"]["count"] == nc * z_["steps"]
                and (not on_card or (fz["per_step"] == [{"conv_direct": 16 * (nc + 1)}]
                                     * z_["frozen"]
                                     and te["per_step"] == [{}] * z_["steps"]
                                     and probe == 16 * math.ceil(z_["probe"] / 64))))
        log(f"phase 29 (d) vg_full frozen {z_['frozen']} step ({fz['per_step']} launches), "
            f"resumed with train_encoder: the fallback line {fallback in te['err']}, the "
            f"encoder's optimizer at zero when its first step began "
            f"{te['first'].get('enc_opt_zero')}, enc_opt count {sd['enc_opt']['count']} after "
            f"{z_['steps']} steps; {time.perf_counter() - t_d:.3f} s for both runs")
        # The last step is profiled; the steps between the first and it are not.
        clean = te["logged"][1:-1]
        te["s_per_step"] = 1 / clean[-1]["steps_per_sec"]
        te["images_per_s"] = clean[-1]["images_per_sec"]
        log(f"phase 29 (a) vg_full train_encoder (VGG-19 {S} px, B "
            f"{base.get('train.batch_size', 256)}, grad_accum {z_['accum']}): {z_['steps']} "
            f"steps in {te['s']:.3f} s in process (set-up, probe, profile and checkpoint "
            f"included); s/step {[round(1 / x_['steps_per_sec'], 4) for x_ in clean]} (the "
            f"first step's time is its log interval's start; the last step, profiled, "
            f"{1 / te['logged'][-1]['steps_per_sec']:.4f}), last unprofiled "
            f"{te['s_per_step']:.4f}, "
            f"{te['images_per_s']:.1f} images/s; peak device memory {te['peak_gb']:.3f} GB; "
            f"enc_gnorm {[round(g_, 4) for g_ in gnorms]}; launches per step {te['per_step']}, "
            f"conv_direct in the probe {probe} ({z_['probe']} held-out images); encoder "
            f"tensors moved {moved} of {len(enc_sd)}: {'ok' if a_ok else 'FAILED'} [{smi}]")
        # Where the step's time goes, by the step's regions (the profiled step).
        read_profile(wd, "vg_full train_encoder")
        split = read_regions(wd, "vg_full train_encoder", nc, nc * z_["accum"], False, smi)
        reg = split["regions"]
        busy = sum(reg[k_]["device_ms"] for k_ in ("critic_update", "generator_update")) \
            if on_card else None
        log(f"phase 29 (a) the profiled vg_full train_encoder step by region: "
            + "; ".join(f"{k_} host {r_['host_ms']:.1f} ms, device "
                        + (f"{r_['device_ms']:.1f} ms ({r_['device_ms'] / busy:.3f} of the "
                           "critic and generator updates' device time)" if on_card
                           else "not measured")
                        for k_, r_ in reg.items()) + f" [{smi}]")
        out["a"] = {k_: te[k_] for k_ in ("s", "s_per_step", "images_per_s", "peak_gb")}
        out["a"].update(enc_gnorm=gnorms, probe=probe, moved=moved,
                        B=int(base.get("train.batch_size", 256)),
                        regions={k_: {x_: r_[x_] for x_ in ("calls", "host_ms", "device_ms")}
                                 for k_, r_ in reg.items()})
        out["d"] = {"frozen_s": fz["s"], "frozen_launches": fz["per_step"]}

        # (b) resnet50 with train_encoder at V = 8,192, then generate --decode fused.
        wd_b = os.path.join(tmp, "wd_r50")
        sets_b = {"data.source": "vg", "data.data_dir": vg_dir,
                  "data.vocab_path": vocab_of_size(vg_dir, z_["vocab"]),
                  "train.batch_size": z_["r50_batch"], "train.train_encoder": "true",
                  "train.log_every": 1, "train.checkpoint_every": z_["r50_steps"],
                  "train.eval_every": 0, **(r50_sets or {})}
        r50 = train("resnet50", wd_b, "resnet50", z_["r50_steps"], sets_b)
        gen_out = os.path.join(tmp, "graphs_r50.json")
        gen_s, gen_counts = run_cli(generate_cli.main, [
            "--workdir", wd_b, "--out", gen_out, "--decode", "fused", "--split", "train",
            "--num-images", str(z_["gen_images"]), "--batch-size", "32",
            "--num-samples", str(z_["k"]), "--seed", str(SEED)]
            + ([] if on_card else ["--device", "cpu"]), "sgg_torch.cli.generate resnet50")
        for k_, v_ in gen_counts.items():
            out["launches"][k_] += v_
        n_b = math.ceil(z_["gen_images"] / 32)
        want_gen = {"fused_decode": n_b * z_["k"], "fused_matmul": n_b * 36,
                    "conv_direct": n_b * 13, "flash_attention": 0,
                    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
        with open(gen_out) as f:
            graphs = json.load(f)["scene_graphs"]
        b_ok = (len(graphs) == z_["gen_images"] and all(x_["enc_gnorm"] > 0
                                                         for x_ in r50["logged"])
                and (not on_card or (gen_counts == want_gen
                                     and r50["per_step"] == [{}] * z_["r50_steps"])))
        log(f"phase 29 (b) resnet50 train_encoder (V {z_['vocab']}, B {z_['r50_batch']}): "
            f"{z_['r50_steps']} steps in {r50['s']:.3f} s, last {r50['s_per_step']:.4f} s/step, "
            f"peak {r50['peak_gb']:.3f} GB, launches per step {r50['per_step']}; generate "
            f"--decode fused on its checkpoint: {gen_s:.3f} s, {len(graphs)} graphs, launches "
            f"{gen_counts} (expected {want_gen}): {'ok' if b_ok else 'FAILED'}")
        out["b"] = {"s_per_step": r50["s_per_step"], "peak_gb": r50["peak_gb"],
                    "B": z_["r50_batch"],
                    "generate_s": gen_s, "generate": gen_counts}

        # (f) v4_32 with train_encoder under torchrun, two ranks sharing the card.
        wd_f = os.path.join(tmp, "wd_v4_32")
        sets_f = {**(extra_sets or {}), "data.data_dir": vg_dir, "train.log_every": 1,
                  "train.train_encoder": "true", "train.grad_accum": z_["v4_accum"],
                  "train.eval_every": 0, "train.checkpoint_every": z_["v4_steps"]}
        argv_f = ["--config", "v4_32", "--workdir", wd_f, "--steps", str(z_["v4_steps"])]
        for k_, v_ in sets_f.items():
            argv_f += ["--set", f"{k_}={v_}"]
        t_f = time.perf_counter()
        recs_f, _ = dp_launch(os.path.join(tmp, "out_v4_32"),
                              argv_f + ([] if on_card else ["--device", "cpu"]), 2)
        for x_ in recs_f:
            for c_ in x_["per_step"]:
                for k_, v_ in c_.items():
                    out["launches"][k_] += v_
        logged_f = [r_ for r_ in read_metric_lines(wd_f) if "d_loss" in r_]
        f_ok, f_bad = dp_holds(recs_f, None, {} if on_card else None)
        f_ok = f_ok and all(x_["enc_gnorm"] > 0 for x_ in logged_f)
        out["f"] = {"s_per_step": 1 / logged_f[-1]["steps_per_sec"],
                    "images_per_s": logged_f[-1]["images_per_sec"],
                    "peak_gb": [x_["peak_gb"] for x_ in recs_f], "s": time.perf_counter() - t_f}
        log(f"phase 29 (f) v4_32 train_encoder over 2 ranks (gloo, B "
            f"{sets_f.get('train.batch_size', 128)} a rank, grad_accum {z_['v4_accum']}): "
            f"{z_['v4_steps']} steps in {out['f']['s']:.3f} s (launch and set-up included), last "
            f"{out['f']['s_per_step']:.4f} s/step, {out['f']['images_per_s']:.1f} images/s over "
            f"both, peak GB per rank {out['f']['peak_gb']}, launches a step per rank "
            f"{[x_['per_step'] for x_ in recs_f]}; the ranks' states equal, their noise "
            f"distinct: {'ok' if f_ok else 'FAILED ' + '; '.join(f_bad)}")

    # (c) the float32 hold, card against CPU.
    t_c = time.perf_counter()
    c_ok, c_nums = cnn_hold(dev, batch=z_["hold_batch"], size=S, extra_sets=hold_sets)
    shown = {**c_nums, "grads": {k_: {x_: y_ for x_, y_ in g_.items() if x_ != "per_tensor"}
                                 for k_, g_ in c_nums["grads"].items()}}
    log(f"phase 29 (c) float32 vg_full train_encoder step, card against CPU and the float64 "
        f"oracle (B {z_['hold_batch']}, n_critic 1): {'ok' if c_ok else 'FAILED'} {shown}; "
        f"{time.perf_counter() - t_c:.3f} s")
    out["c"] = c_nums

    # (e) the guard, on the card: operands that need a gradient are refused.
    e_ok = True
    if on_card:
        x = torch.randn(2, 14, 14, 64, device=dev)
        w = torch.randn(3, 3, 64, 64, device=dev, requires_grad=True)
        a = torch.randn(392, 64, device=dev, requires_grad=True)
        before = (cd.launches, mm.launches)
        for fn, args in ((cd.conv2d_direct, (x, w)), (mm.fused_matmul, (a, w.detach()[0, 0]))):
            try:
                fn(*args)
                e_ok = False
            except NotImplementedError:
                pass
        e_ok = e_ok and (cd.launches, mm.launches) == before
    log(f"phase 29 (e) conv2d_direct and fused_matmul refuse operands that need a gradient: "
        f"{'ok' if e_ok else 'FAILED'}")
    if not (a_ok and b_ok and c_ok and e_ok and f_ok):
        raise AssertionError("phase 29: a hold failed")
    return out


def phase29_line(v29, smi):
    a_, b_, c_ = v29["a"], v29["b"], v29["c"]
    return (f"phase 29: vg_full train_encoder (B {a_['B']}, grad_accum {P29_ACCUM}) "
            f"{a_['s_per_step']:.4f} s/step, {a_['images_per_s']:.1f} images/s, peak "
            f"{a_['peak_gb']:.3f} GB; resnet50 train_encoder (B {b_['B']}) {b_['s_per_step']:.4f} "
            f"s/step, peak {b_['peak_gb']:.3f} GB; v4_32 train_encoder over 2 ranks "
            f"{v29['f']['s_per_step']:.4f} s/step; float32 hold: shares beyond 1e-5 "
            + ", ".join(f"{k_.split('_')[0]} {v_[0]:.5f}" for k_, v_ in c_["params"].items())
            + "; gradients from the float64 oracle (card, CPU) "
            + ", ".join(f"{k_} ({g_['card']:.3e}, {g_['cpu']:.3e})"
                        for k_, g_ in c_["grads"].items())
            + "; the profiled step's device ms by region "
            + ", ".join(f"{k_} {r_['device_ms']:.1f}" for k_, r_ in a_["regions"].items()
                        if r_["device_ms"] is not None)
            + f"; launches {v29['launches']} [{smi}]")


def phase25_line(v25, smi):
    return (f"phase 25: convert --config vg1k {v25['convert_tf_s']:.3f} s from the bundle "
            f"({v25['mb']:.3f} MB, CRC32C {v25['crc_s']:.3f} s, read {v25['read_s']:.3f} s), "
            f"{v25['convert_npz_s']:.3f} s from the .npz; generate on it {v25['generate_s']:.3f} "
            f"s, {v25['fused_decode']} fused_decode launches, {v25['agree']:.4f} identical to "
            f"plain; pipeline_v4 on grain {v25['v4']['s_per_step']:.4f} s/step, idle "
            f"{v25['v4']['idle']}; vg_full on grain {v25['vg']['s_per_step']:.4f} s/step, "
            f"decode {v25['vg']['decode_s_per_step']:.4f} s a step; launches {v25['launches']} "
            f"[{smi}]")


def phase26_line(v26, smi):
    a_, b_ = v26["a"], v26["b"]

    def coll(r_):  # each rank's mean ms a step after the first
        return [round(sum(x_) / max(len(x_), 1), 3) for x_ in r_["coll_ms"]]

    return (f"phase 26: TP resnet50 (V 8192, 2 ranks) {a_['s_per_step']:.4f} s/step, "
            f"collectives {coll(a_)} ms a step, state bytes {a_['state_bytes']} (DP "
            f"{a_['dp_bytes']}), peak GB {a_['peak_gb']}; FSDP vit_b16 train_encoder (2 ranks) "
            f"{b_['s_per_step']:.4f} s/step, collectives {coll(b_)} ms a step, state bytes "
            f"{b_['state_bytes']} (DP {b_['dp_bytes']}), peak GB {b_['peak_gb']}; generate "
            f"--decode fused {v26['generate']['s']:.3f} s; launches {v26['launches']} [{smi}]")


def phase21_line(v21):
    ld, tr = v21["loader"], v21["train"]
    return (f"phase 21: loader {ld['route']} (build {ld['build_s']:.3f} s, mean |d| "
            f"{ld['mean']:.4f}, max {ld['max']}, {ld['images_per_s']:.1f} images/s in "
            f"{ld['threads']} threads); extraction " + ", ".join(
                f"{s_['images_per_sec']} images/s (decode-wait {s_['decode_wait_frac']})"
                for s_ in v21["extract"]["stats"]) + "; vg_full " + "; ".join(
                f"{k_} {r_['s_per_step']:.4f} s/step, {r_['images_per_s']:.1f} images/s, idle "
                f"{r_['idle']}, peak {r_['peak_gb']:.3f} GB" for k_, r_ in tr.items())
            + f"; generate {v21['infer']['generate_tps']:.1f} and evaluate "
            f"{v21['infer']['evaluate_tps']:.1f} triples/s")


def phase22_line(v22):
    c22, p22, m22 = v22["corpus"], v22["pretrain"], v22["moe"]
    return (f"phase 22: corpus {c22['images_per_s']:.1f} images/s ({c22['route']}, "
            f"{c22['mb']:.2f} MB, mean |d| {c22['mean_d'][0]:.4f}-{c22['mean_d'][1]:.4f}); "
            f"pretrain vgg19 {p22['s_per_step']:.4f} s/step, {p22['images_per_s']:.1f} "
            f"images/s, idle {p22['idle']}, peak {p22['peak_gb']:.3f} GB, loss "
            f"{p22['first']:.4f} -> {p22['last']:.4f}, held-out presence_recall "
            f"{p22['seeded']['presence_recall']:.4f} -> "
            f"{p22['held_out']['presence_recall']:.4f}, precision_at_k "
            f"{p22['seeded']['precision_at_k']:.4f} -> {p22['held_out']['precision_at_k']:.4f}, "
            f"cell_acc {p22['seeded'].get('cell_acc')} -> {p22['held_out'].get('cell_acc')}; "
            f"vit_b16 MoE {m22['s_per_step']:.4f} s/step, peak {m22['peak_gb']:.3f} GB, aux "
            f"{m22['aux']:.6f}, dropped in training {m22['dropped']:.4f}; extraction "
            f"{v22['rest']['stats'][0]['images_per_sec']} images/s; launches {v22['launches']}")


def phase24_line(v24, smi):
    return (f"phase 24: v4_32 over 2 ranks (gloo) {v24['a']['s_per_step']:.4f} s/step, "
            f"{v24['a']['images_per_s']:.1f} images/s over both, all-reduce "
            f"{max(v24['allreduce_ms_step']):.3f} ms a step, idle per rank {v24['a']['idle']}, "
            f"card {v24['a']['card_idle']}; world 1 (NCCL) {v24['b']['s_per_step']:.4f}, plain "
            f"{v24['plain']['s_per_step']:.4f} s/step; vit_b16 over 2 ranks "
            f"{v24['vit']['s_per_step']:.4f} s/step; launches {v24['launches']} [{smi}]")


def run_phases(chosen, dev, smi, results=None):
    """``--phases``: each chosen phase alone, in the order given, after the
    device and the build; prints its launches and its summary line, then the
    card's line and a last line that names the phases run. With ``results``
    (a path) those two lines are not printed: the summary lines and the
    launches go to that JSON file instead, for ``side_finish``."""
    import torch

    done, lines = {}, {}
    for n_ in chosen:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        if n_ == 21:
            done[n_] = vg_full_phase(dev, run_cli, kernel_counts)
            lines[n_] = phase21_line(done[n_])
        elif n_ == 22:
            done[n_] = grounded_recipe_phase(dev, run_cli, kernel_counts)
            lines[n_] = phase22_line(done[n_])
        elif n_ == 24:
            done[n_] = dp_phase(dev, smi)
            lines[n_] = phase24_line(done[n_], smi)
        elif n_ == 26:
            done[n_] = tp_fsdp_phase(dev, smi)
            lines[n_] = phase26_line(done[n_], smi)
        elif n_ == 27:
            done[n_] = sp_phase(dev, smi)
            lines[n_] = phase27_line(done[n_], smi)
        elif n_ == 28:
            done[n_] = pp_ep_phase(dev, smi)
            lines[n_] = phase28_line(done[n_], smi)
        elif n_ == 29:
            done[n_] = cnn_train_phase(dev, smi)
            lines[n_] = phase29_line(done[n_], smi)
        else:
            done[n_] = convert_grain_phase(dev, smi, before={"v21": done.get(21)})
            lines[n_] = phase25_line(done[n_], smi)
        log(lines[n_])
        phase(str(n_), t0)
        log(f"phase {n_} launches: {done[n_].get('launches')}")
    faulthandler.cancel_dump_traceback_later()
    if results:
        with open(results, "w") as f:
            json.dump({"lines": {str(n_): lines[n_] for n_ in chosen},
                       "launches": {str(n_): done[n_].get("launches") for n_ in chosen}},
                      f)
        return
    print(smi, flush=True)
    print(json.dumps({"ok": True, "phases": chosen, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def side_start(phases, deadline):
    """Start this script with ``--phases`` on ``phases`` in a session of its
    own, its output to a file and its watchdog set to fire ``SIDE_MARGIN_S``
    before ``deadline`` (this process's, on the monotonic clock);
    ``side_stop`` ends it if this process exits first. → the handle that
    ``side_finish`` takes."""
    import atexit

    out = tempfile.mkdtemp(prefix="chip_smoke_side_")
    left = int(deadline - time.monotonic() - SIDE_MARGIN_S)
    argv = [sys.executable, os.path.abspath(__file__), "--phases", ",".join(map(str, phases)),
            "--results", os.path.join(out, "results.json"), "--watchdog", str(left)]
    with open(os.path.join(out, "log.txt"), "w") as log_f:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
                                env=dict(os.environ, SGG_SMOKE_SIDE=str(os.getpid())),
                                start_new_session=True)
    atexit.register(side_stop, proc)
    log(f"side process {proc.pid}: phases {', '.join(map(str, phases))} beside phases 17-20 "
        f"and 23, watchdog {left} s")
    return {"proc": proc, "dir": out, "phases": phases, "deadline": deadline,
            "t0": time.perf_counter()}


def side_stop(proc):
    """End the side process's session if it is still running: SIGTERM (on
    which it kills its ranks' process groups as it unwinds), then SIGKILL."""
    if proc.poll() is not None:
        return
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def side_finish(side):
    """Wait for the side process (its own watchdog ends it in time), echo
    its output, raise if it failed → {"lines": {phase: summary line},
    "launches": {phase: {kernel: launches}}}."""
    proc = side["proc"]
    waited = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, side["deadline"] - time.monotonic() - 5))
    except subprocess.TimeoutExpired:
        rc = "timeout"
    side_stop(proc)
    with open(os.path.join(side["dir"], "log.txt")) as f:
        text = f.read()
    print(f"[chip_smoke] ---- the side process's output (phases "
          f"{', '.join(map(str, side['phases']))}) ----", flush=True)
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    print("[chip_smoke] ---- end of the side process's output ----", flush=True)
    if rc != 0:
        raise AssertionError(f"the side process (phases {side['phases']}) exited {rc}:\n"
                             f"{text[-4000:]}")
    with open(os.path.join(side["dir"], "results.json")) as f:
        got = json.load(f)
    shutil.rmtree(side["dir"], ignore_errors=True)
    log(f"side process: {time.perf_counter() - side['t0']:.3f} s from its start, "
        f"{time.perf_counter() - waited:.3f} s of it waited for here")
    return got


def side_process_setup():
    """In the side process: receive SIGTERM when the process that started it
    exits (as on that one's watchdog), and turn SIGTERM into SystemExit, so
    that the ``finally`` clauses kill the ranks it started."""
    import ctypes

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    if str(os.getppid()) != os.environ.get("SGG_SMOKE_SIDE"):
        raise SystemExit("chip_smoke: the process that started this side run is gone")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="chip smoke for sgg_torch on one H100")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone after the device and the build, "
                         f"of {', '.join(map(str, SELECTABLE_PHASES))} (default: every phase)")
    ap.add_argument("--results", default=None,
                    help="with --phases: write the phases' summary lines and launches to this "
                         "JSON file instead of the last two lines (the full run's side process)")
    ap.add_argument("--watchdog", type=int, default=WATCHDOG_SECONDS,
                    help=f"seconds before a stack trace and exit 1 (default {WATCHDOG_SECONDS})")
    args = ap.parse_args(argv)
    chosen = None
    if args.phases:
        chosen = [int(x_) for x_ in args.phases.split(",")]
        if not set(chosen) <= set(SELECTABLE_PHASES):
            ap.error(f"--phases takes {SELECTABLE_PHASES}; the others share the full run's "
                     "state")
    if args.results and not chosen:
        ap.error("--results goes with --phases")
    faulthandler.dump_traceback_later(args.watchdog, exit=True)
    deadline = time.monotonic() + args.watchdog
    if os.environ.get("SGG_SMOKE_SIDE"):
        side_process_setup()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs the card")
    sys.path.insert(0, ROOT)
    from collections import Counter

    import numpy as np
    import torch.nn.functional as Fnn

    from sgg_torch.cli import evaluate as evaluate_cli
    from sgg_torch.cli import generate
    from sgg_torch.cli import train as train_cli
    from sgg_torch.config import Config, get_config
    from sgg_torch.data import Vocab, write_feature_shard
    from sgg_torch.data.shards import shard_name
    from sgg_torch.eval.sampler import make_fused_sampler
    from sgg_torch.kernels import build
    from sgg_torch.kernels import conv_direct as cd
    from sgg_torch.kernels import flash_attention as fa
    from sgg_torch.kernels import flash_attention_bwd as fb
    from sgg_torch.kernels import fused_decode as fd
    from sgg_torch.kernels import matmul as mm
    from sgg_torch.models.encoders import normalize_for
    from sgg_torch.kernels.conv import max_pool_nhwc
    from sgg_torch.models.resnet import ResNet50Features
    from sgg_torch.models.vgg import VGG19Features
    from sgg_torch.models.generator import AttentionLSTMGenerator
    from sgg_torch.models.transformer import TransformerTripleGenerator
    from sgg_torch.models.vit import ViTB16Features
    from sgg_torch.eval.sampler import make_sampler
    from sgg_torch.data import ArrayImageTripleDataset
    from sgg_torch.data.pipeline import make_device_train_iterator
    from sgg_torch.train.checkpoint import (
        CheckpointManager,
        load_generator,
        load_workdir,
        save_generator,
    )
    from sgg_torch.train.state import create_train_state
    from sgg_torch.train.step import make_step_fn
    from sgg_torch.utils.gumbel import sample_gumbel

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    def time_ms(fn, target_s=0.05):
        """Mean ms per call over a warm run of about target_s."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        n = int(min(200, max(3, target_s / max(time.perf_counter() - t0, 1e-6))))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def graph_ms(fn, n=20, reps=5):
        """Mean ms per call of fn on the device: n calls captured in one CUDA
        graph, replayed reps times, warm. The host's cost per call does not
        enter, as it does in time_ms once a kernel takes less than that."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (n * reps)

    def in_turns(kernel, plain):
        """(kernel ms, plain ms): the lower of two turns each, taken plain,
        kernel, kernel, plain."""
        p1 = time_ms(plain)
        k1 = time_ms(kernel)
        k2 = time_ms(kernel)
        p2 = time_ms(plain)
        return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)

    def one_ulp_gate(got, want, f32_tol):
        """bf16 kernel vs plain: within one bf16 ulp of the plain value plus
        the float32 gate (both round float32 sums taken in another order)."""
        return bool(((got.float() - want.float()).abs() <= bf16_ulp(want) + f32_tol).all())

    def cut_split(x, n):
        """x with its three-way bf16 split cut to the first n terms, float32."""
        return sum(t_.float() for t_ in fa.split3(x)[:n])

    def f32_result_gate(name, errs, faults, tol):
        """The float32 results before the cast: every sound relative L2
        distance within tol and every cut-split fault's above it."""
        ok = max(errs) <= tol < min(faults)
        log(f"{name} float32 result before the cast vs plain in float32: rel L2 "
            f"{', '.join(f'{e:.3e}' for e in errs)} (<= {tol:.2e}, margin "
            f"{tol / max(max(errs), 1e-30):.2f}x); split cut to hi + mid (plain) "
            f"{', '.join(f'{e:.3e}' for e in faults)} (> {tol:.2e}, margin "
            f"{min(faults) / tol:.2f}x): {'ok' if ok else 'FAILED'}")
        return ok

    # 1. Device.
    t0 = time.perf_counter()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0)

    # 2. Build.
    t0 = time.perf_counter()
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    lib_path, build_s = build.build()
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = cpu1.ru_utime + cpu1.ru_stime - cpu0.ru_utime - cpu0.ru_stime
    log(f"nvcc build: {build_s:.2f} s wall, {cpu_s:.2f} s of compiler CPU time over "
        f"{len(build.sources())} sources and the link -> {os.path.relpath(lib_path, ROOT)}")
    for name, regs, spills in ptxas_report((build.BUILD_DIR / "build.log").read_text()):
        log(f"ptxas: {name}: {regs}; {spills}")
    lib = build.load_library()
    phase("build", t0)
    if chosen is not None:
        run_phases(chosen, dev, smi, args.results)
        return

    # 3. fused_decode vs plain, at the trained run's widths and at resnet50's.
    t0 = time.perf_counter()
    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        run_cfg = json.load(f)
    vocab = Vocab.load(os.path.join(TRAINED_RUN, "vocab.json"))
    cfg = Config.from_dict(run_cfg)
    cfg.model.vocab_size = len(vocab)
    m = cfg.model
    R, F, A, H, E, Z, V = (cfg.data.regions, cfg.data.feat_dim, m.attn_dim,
                           m.hidden, m.embed_dim, m.noise_dim, m.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    rng = np.random.default_rng(SEED)
    pix_vocab = Vocab.build(
        Counter({f"object{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 7190))}),
        Counter({f"predicate{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 1000))}),
    )
    assert len(pix_vocab) == PIX_VOCAB, len(pix_vocab)
    pix_cfg = get_config("resnet50")
    pix_cfg.data.num_synthetic_images = PIX_IMAGES
    pix_cfg.model.vocab_size = PIX_VOCAB
    pm = pix_cfg.model
    pix_widths = (pix_cfg.data.regions, pix_cfg.data.feat_dim, pm.attn_dim, pm.hidden,
                  pm.embed_dim, pm.noise_dim, PIX_VOCAB)

    def check_decode(cfg_, vocab_, batches, label, share_tol=None, row_tile=None):
        Rq, Fq = cfg_.data.regions, cfg_.data.feat_dim
        Zq, Vq = cfg_.model.noise_dim, cfg_.model.vocab_size
        torch.manual_seed(SEED)
        sd = AttentionLSTMGenerator.from_config(cfg_).state_dict()
        mb = fd.step_mask_bias(vocab_.step_mask(), dev)
        feats_all = torch.randn(max(batches), Rq, Fq, generator=gen, device=dev)
        errs = {}
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            params = fd.decode_params_from_generator(sd, dtype, dev)
            for B in batches:
                feats = feats_all[:B].to(dtype).contiguous()
                z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
                g = sample_gumbel((B, 3, Vq), gen, device=dev)
                y = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=False,
                                    row_tile=row_tile)
                torch.cuda.synchronize()
                want = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=False)
                diff = (y.float() - want.float()).abs()
                err = diff.max().item()
                # Each (row, step) against its own largest value: at V = 8192
                # a typical y is ~1e-4, so an absolute bound says little.
                row_max = want.float().abs().amax(-1)
                rel = (diff.amax(-1) / row_max).max().item()
                big = want.float().abs() >= 1e-3 * row_max[..., None]
                ulps = (diff / bf16_ulp(want))[big].max().item()
                moved = (diff > 0).float()
                share, row_share = moved.mean().item(), moved.amax(-1).mean().item()
                # Token agreement over 8 noise draws: 8 * B * 3 (row, step) pairs.
                same = total = 0
                for _ in range(8):
                    z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
                    g = sample_gumbel((B, 3, Vq), gen, device=dev)
                    yh = fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True,
                                         row_tile=row_tile)
                    torch.cuda.synchronize()
                    wh = fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=True)
                    same += (yh.argmax(-1) == wh.argmax(-1)).sum().item()
                    total += yh.shape[0] * 3
                agree = same / total
                tol, need = (1e-4, 0.999) if dtype == torch.float32 else (1e-2, 0.99)
                # bf16: kernel and plain round at the same points, so only a
                # float32 sum taken in another order moves a y by an ulp; at
                # vg1k widths a rounding the kernel skips (of ctx, h or c)
                # moves over ten times as many. At resnet50 widths the sums
                # alone move about 2 %, so the share is only reported there.
                share_max = share_tol if dtype == torch.bfloat16 else None
                ok = (rel <= tol and agree >= need and bool(torch.isfinite(y.float()).all())
                      and (share_max is None or share <= share_max))
                p_ = fd.plan(B, Rq, Fq, cfg_.model.attn_dim, cfg_.model.hidden,
                             cfg_.model.embed_dim, Zq, Vq, dtype, mm.sm_count(0), row_tile)
                log(f"fused_decode vs plain, {label} {name} B={B} ({p_.instance} instance): "
                    f"soft max_abs_err "
                    f"{err:.3e}, max_abs_err / row max {rel:.3e} (<= {tol}), max bf16 "
                    f"ulps where y >= 1e-3 x row max {ulps:.2f}, share of y differing "
                    f"{share:.3e}{f' (<= {share_max})' if share_max else ''}, of rows "
                    f"{row_share:.3e}; hard tokens identical "
                    f"{agree:.5f} of {total} (>= {need}) {'ok' if ok else 'FAILED'}")
                if not ok:
                    failed.append(f"{label} {name} B={B}")
                errs[(name, B)] = err
        return sd, errs

    log(f"widths vg1k: V={V} R={R} F={F} A={A} H={H} E={E} Z={Z} compute={m.compute_dtype}; "
        f"generic row tile {fd.plan(BATCH, R, F, A, H, E, Z, V, torch.float32).row_tile}")
    failed = []
    sd, vg_errs = check_decode(cfg, vocab, (BATCH, 37), "vg1k", share_tol=5e-3)
    # The 16-row instance, which resnet50 widths run, where the share of y
    # that differs can tell a skipped rounding (at resnet50 widths the sums
    # alone move about 2 %).
    check_decode(cfg, vocab, (BATCH,), "vg1k row tile 16", share_tol=5e-3, row_tile=16)
    log(f"widths resnet50: R, F, A, H, E, Z, V = {pix_widths}; generic row tile "
        f"{fd.plan(PIX_BATCH, *pix_widths, torch.float32).row_tile}")
    pix_sd, _ = check_decode(pix_cfg, pix_vocab, (PIX_BATCH,), "resnet50")

    def check_batched(cfg_, sd_, B, label):
        """The batched bf16 instance, exactly: (i) an exact tie, where wv's
        and bv's column n2 is a copy of n1 < n2, 32 * 6 columns on (so the
        two lie in items that different blocks take), with the Gumbel noise
        copied too and no mask: both columns hold the maximum of every row
        and step and the kernel must pick n1, as decode_plain does; (ii) two
        launches on the same inputs give the same bits, soft and hard;
        (iii) B = 37 gives rows 0-36 of the B call bit for bit."""
        Rq, Fq, Zq, Vq = (cfg_.data.regions, cfg_.data.feat_dim, cfg_.model.noise_dim,
                          cfg_.model.vocab_size)
        params = fd.decode_params_from_generator(sd_, torch.bfloat16, dev)
        g_tie = torch.Generator(device=dev).manual_seed(SEED + 41)  # leaves gen's stream as it was
        feats = torch.randn(B, Rq, Fq, generator=g_tie, device=dev).to(torch.bfloat16)
        z = torch.randn(B, Zq, generator=g_tie, device=dev).to(torch.bfloat16)
        g = sample_gumbel((B, 3, Vq), g_tie, device=dev)
        n1, n2 = 5, 5 + 32 * 6
        p_ = fd.plan(B, Rq, Fq, cfg_.model.attn_dim, cfg_.model.hidden, cfg_.model.embed_dim,
                     Zq, Vq, torch.bfloat16, mm.sm_count(0))
        blocks = {n: next(b_ for b_, cols in p_.items("logits") if n in cols) for n in (n1, n2)}
        tied = dict(params)
        tied["wv"] = params["wv"].clone()
        tied["wv"][:, n2] = tied["wv"][:, n1]
        tied["bv"] = params["bv"].clone()
        tied["bv"][[n1, n2]] = 100.0
        gt = g.clone()
        gt[:, :, n2] = gt[:, :, n1]
        yk = fd.fused_decode(tied, feats, z, gt, hard=True)
        torch.cuda.synchronize()
        yp = fd.decode_plain(tied, feats, z, gt, hard=True)
        tie_ok = (p_.instance == "batched" and blocks[n1] != blocks[n2]
                  and bool((yk.argmax(-1) == n1).all()) and bool((yp.argmax(-1) == n1).all()))
        same = True
        for hard in (False, True):
            a_ = fd.fused_decode(params, feats, z, g, hard=hard)
            b_ = fd.fused_decode(params, feats, z, g, hard=hard)
            torch.cuda.synchronize()
            same = same and torch.equal(a_, b_)
        full = fd.fused_decode(params, feats, z, g, hard=False)
        part = fd.fused_decode(params, feats[:37].contiguous(), z[:37].contiguous(),
                               g[:37].contiguous(), hard=False)
        torch.cuda.synchronize()
        rows_ok = torch.equal(part, full[:37])
        ok = tie_ok and same and rows_ok
        log(f"fused_decode batched instance, {label} bf16 B={B}: exact tie at columns {n1} "
            f"(block {blocks[n1]}) and {n2} (block {blocks[n2]}): kernel picks {n1} in every "
            f"row and step {bool((yk.argmax(-1) == n1).all())}, plain "
            f"{bool((yp.argmax(-1) == n1).all())}; two launches bit for bit {same}; B = 37 "
            f"gives rows 0-36 of B = {B} bit for bit {rows_ok}: {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(f"{label} batched exact cases")

    check_batched(cfg, sd, BATCH, "vg1k")
    check_batched(pix_cfg, pix_sd, 64, "resnet50")
    if failed:
        raise AssertionError(f"fused_decode disagrees with decode_plain: {failed}")
    phase("fused_decode_vs_plain", t0)

    # 4. fused_matmul and conv_direct vs plain at the pixels-in path's shapes.
    t0 = time.perf_counter()
    shape_errs = {}

    def mm_inputs(M, K_, N, dtype):
        a = torch.randn(M, K_, generator=gen, device=dev).to(dtype)
        b = (torch.randn(K_, N, generator=gen, device=dev) / K_ ** 0.5).to(dtype)
        bias = 0.1 * torch.randn(N, generator=gen, device=dev)
        scale = 1.0 + 0.1 * torch.randn(N, generator=gen, device=dev)
        return a, b, bias, scale

    def conv_inputs(shape, cout, dtype, k=3):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        w = (torch.randn(k, k, shape[-1], cout, generator=gen, device=dev)
             / (k * k * shape[-1]) ** 0.5).to(dtype)
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        scale = 1.0 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        return x, w, bias, scale

    def gate(name, got, want, dtype):
        ref = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        f32_tol = 1e-4 * max(ref, 1e-6)
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got.float()).all())
              and (err <= f32_tol if dtype == torch.float32
                   else one_ulp_gate(got, want, f32_tol)))
        log(f"{name}: max_abs_err {err:.3e}, max|plain| {ref:.3e} "
            f"({'<= 1e-4 x max' if dtype == torch.float32 else '<= 1 bf16 ulp + 1e-4 x max'})"
            f" {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return err

    for M, K_, N, relu, guard in ([(M, K_, N, relu, 0) for M, K_, N, relu, _ in
                                    RESNET_1X1 + [VGG_IM2COL]] + MM_EDGES):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            a, b, bias, scale = mm_inputs(M + 2 * guard, K_, N, dtype)
            a = a[guard:guard + M]  # inside seeded guard rows, where guard > 0
            p_ = mm.plan(M, K_, N, dtype, dtype, mm.aligned(a), mm.aligned(b),
                         mm.sm_count(a.device.index))
            for r_ in ((relu, not relu) if dtype == torch.bfloat16 else (relu,)):
                got = mm.fused_matmul(a, b, bias, scale, relu=r_)
                torch.cuda.synchronize()
                label = f"fused_matmul {name} M={M} K={K_} N={N} relu={r_}"
                want = mm.fused_matmul_plain(a, b, bias, scale, relu=r_)
                err = gate(label, got, want, dtype)
                log(f"{label}: instance {p_.instance}, tile {p_.bm}x{p_.bn}x{p_.bk}, "
                    f"{p_.stages} stages, {p_.threads} threads, {p_.grid[0] * p_.grid[1]} "
                    f"blocks{f', a inside {guard} guard rows on each side' if guard else ''}; "
                    f"share of outputs differing from plain "
                    f"{(got != want).float().mean().item():.3e}")
                shape_errs[("mm", M, K_, N, name, r_, guard)] = err
    conv_cases = [(s_, c_, 3) for s_, c_, _ in RESNET_3X3 + VGG_3X3] + CONV_EDGES
    for shape, cout, k_ in conv_cases:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x, w, bias, scale = conv_inputs(shape, cout, dtype, k=k_)
            got = cd.conv2d_direct(x, w, bias, scale, relu=True)
            torch.cuda.synchronize()
            want = cd.conv2d_direct_plain(x, w, bias, scale, relu=True)
            label = f"conv_direct {name} {list(shape)}->{cout} {k_}x{k_}"
            err = gate(label, got, want, dtype)
            p_ = cd.plan(*shape, cout, k_, k_, dtype, mm.aligned(x), mm.aligned(w),
                         cd.sm_count(x.device.index))
            log(f"{label}: instance {p_.instance}, tile {p_.bm}x{p_.bn}x{p_.bk}, "
                f"{p_.stages} stages, {p_.threads} threads, {p_.grid[0] * p_.grid[1]} blocks; "
                f"share of outputs differing from plain {(got != want).float().mean().item():.3e}")
            shape_errs[("conv", shape, cout, name)] = err
    phase("kernels_vs_plain", t0)

    # 5. Encoders, kernel routes vs the library route, 8 seeded images.
    t0 = time.perf_counter()
    images = torch.from_numpy(
        np.random.RandomState(SEED).randint(0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(dev)
    encoder_cls = {"resnet50": ResNet50Features, "vgg19": VGG19Features}

    def seeded_encoder_state(name):
        torch.manual_seed(SEED + 3)
        sd_ = encoder_cls[name]().state_dict()
        g_ = torch.Generator().manual_seed(SEED + 4)
        for k_, v_ in sd_.items():
            n_ = v_.shape
            if k_.endswith("bn_scale"):
                v_.copy_(1.0 + 0.2 * torch.randn(n_, generator=g_))
            elif k_.endswith("bn_bias") or k_.endswith("bn_mean"):
                v_.copy_(0.1 * torch.randn(n_, generator=g_))
            elif k_.endswith("bn_var"):
                v_.copy_(0.5 + torch.rand(n_, generator=g_))
            elif k_.endswith(".bias"):
                v_.copy_(0.1 * torch.randn(n_, generator=g_))
        return sd_

    def load_encoder(name, state, dtype, impl):
        enc = encoder_cls[name](conv_impl=impl, dtype=dtype)
        enc.load_state_dict(state)
        return enc.to(dev)

    def run_encoder(name, state, dtype, impl, x):
        enc = load_encoder(name, state, dtype, impl)
        before = (cd.launches, mm.launches)
        with torch.no_grad():
            out = enc(x).float()
        torch.cuda.synchronize()
        return out, (cd.launches - before[0], mm.launches - before[1])

    def dist(a, b):
        return (a - b).abs().max().item(), ((a - b).norm() / b.norm()).item()

    def resnet_blocks_bf16(state, x):
        """The bf16 kernel route against the bf16 library route block by
        block, each block fed the library route's output of the block
        before → worst (share of elements that differ, rel L2) over the
        stem and the 16 blocks."""
        ker, lib_ = (load_encoder("resnet50", state, torch.bfloat16, i) for i in ("auto", "xla"))
        worst_frac = worst_rel = 0.0
        with torch.no_grad():
            x16 = x.to(torch.bfloat16)
            pairs = [(ker.stem(x16), lib_.stem(x16))]
            prev = max_pool_nhwc(pairs[0][1], 3, 2, "SAME")
            for name in lib_.blocks:
                want_ = getattr(lib_, name)(prev)
                pairs.append((getattr(ker, name)(prev), want_))
                prev = want_
        for got_, want_ in pairs:
            worst_frac = max(worst_frac, (got_ != want_).float().mean().item())
            worst_rel = max(worst_rel, dist(got_.float(), want_.float())[1])
        return worst_frac, worst_rel

    # float32: the kernel route within 1e-4 of the library route. bfloat16:
    # both routes round to bf16 at the same points, so only a float32 sum
    # taken in another order can flip a rounding, which 16 to 53 layers carry
    # on. The kernel route must stay as close to the float32 library result
    # as the bf16 library route does (rel L2 within 1.5x, max within 3x).
    # ResNet-50 is also held block by block, each block of the kernel route
    # fed the library route's input: at most 1 % of a block's elements
    # differ, rel L2 <= 1e-3 (a misplaced cast moves 15 % or more, as the
    # CPU tests show against the reference). VGG-19 is held end to end to
    # the bf16 library route: max within 2e-2 x max, rel L2 within 1.5e-2.
    for name, impls in (("resnet50", ("auto",)), ("vgg19", ("direct", "pallas"))):
        state = seeded_encoder_state(name)
        x = normalize_for(name, images)
        want, _ = run_encoder(name, state, torch.float32, "xla", x)
        plain16, _ = run_encoder(name, state, torch.bfloat16, "xla", x)
        p_err, p_rel = dist(plain16, want)
        ref, ref16 = want.abs().max().item(), plain16.abs().max().item()
        log(f"encoder {name} xla bf16 vs xla f32: max_abs_err {p_err:.3e} of max "
            f"{ref:.3e}, rel L2 {p_rel:.3e}")
        for impl in impls:
            got, ran = run_encoder(name, state, torch.float32, impl, x)
            err, rel2 = dist(got, want)
            log(f"encoder {name} {impl} f32 vs xla f32: out {tuple(got.shape)}, "
                f"max_abs_err {err:.3e} (<= 1e-4 x max), rel L2 {rel2:.3e} (<= 1e-4), "
                f"launches conv_direct {ran[0]}, fused_matmul {ran[1]}")
            if not (err <= 1e-4 * ref and rel2 <= 1e-4 and ran != (0, 0)
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"encoder {name} {impl} f32 disagrees")
            got16, ran = run_encoder(name, state, torch.bfloat16, impl, x)
            err, rel2 = dist(got16, want)
            d_err, d_rel = dist(got16, plain16)
            if name == "resnet50":
                b_frac, b_rel = resnet_blocks_bf16(state, x)
                direct_ok = b_frac <= 7e-2 and b_rel <= 2e-3
                direct = (f"block by block: worst share of elements differing {b_frac:.3e} "
                          f"(<= 7e-2), worst rel L2 {b_rel:.3e} (<= 2e-3)")
            else:
                direct_ok = d_err <= 2e-2 * ref16 and d_rel <= 1.5e-2
                direct = f"(<= 2e-2 x {ref16:.3e} and rel L2 <= 1.5e-2)"
            log(f"encoder {name} {impl} bf16 vs xla f32: max_abs_err {err:.3e} (<= 3 x "
                f"{p_err:.3e}), rel L2 {rel2:.3e} (<= 1.5 x {p_rel:.3e}); vs xla bf16: "
                f"max_abs_err {d_err:.3e}, rel L2 {d_rel:.3e} {direct}; launches "
                f"conv_direct {ran[0]}, fused_matmul {ran[1]}")
            if not (err <= 3 * p_err and rel2 <= 1.5 * p_rel and direct_ok and ran != (0, 0)
                    and bool(torch.isfinite(got16).all())):
                raise AssertionError(f"encoder {name} {impl} bf16 disagrees")
    phase("encoders_vs_plain", t0)

    read_counts = kernel_counts

    def run_generate(argv):
        return run_cli(generate.main, argv, "sgg_torch.cli.generate")

    def check_graphs(out_path, vocab_, n_images, k_draws=K):
        with open(out_path) as f:
            out = json.load(f)
        graphs = out["scene_graphs"]
        if out["num_images"] != n_images or len(graphs) != n_images:
            raise AssertionError("wrong number of scene graphs")
        n_unique = legal_graphs(graphs, vocab_, k_draws, out_path)
        log(f"output: {len(graphs)} graphs, {n_unique} unique triples, all type-legal")

    # 6. Main path, precomputed features: the generate CLI end to end.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        data_dir = os.path.join(wd, "shards")
        os.makedirs(data_dir)
        run_cfg["data"]["source"] = "shards"
        run_cfg["data"]["data_dir"] = data_dir
        run_cfg["data"]["vocab_path"] = ""
        run_cfg["workdir"] = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            json.dump(run_cfg, f, indent=2)
        vocab.save(os.path.join(wd, "vocab.json"))
        vocab.save(os.path.join(data_dir, "vocab.json"))
        torch.manual_seed(SEED + 1)
        g_params = AttentionLSTMGenerator.from_config(cfg).state_dict()
        torch.manual_seed(SEED + 2)
        g_ema = AttentionLSTMGenerator.from_config(cfg).state_dict()
        save_generator(wd, g_params, g_ema, step=0)
        objs = np.flatnonzero(vocab.is_object)
        preds = np.flatnonzero(vocab.is_predicate)
        shard_n = N_IMAGES // 2
        for s in range(2):
            feats = rng.standard_normal((shard_n, R, F), dtype=np.float32)
            triples = []
            for _ in range(shard_n):
                n = int(rng.integers(1, 9))
                triples.append(np.stack([rng.choice(objs, n), rng.choice(preds, n),
                                         rng.choice(objs, n)], axis=1))
            write_feature_shard(
                os.path.join(data_dir, shard_name(s, 2)),
                np.arange(s * shard_n, (s + 1) * shard_n), feats, triples)
        log(f"workdir written: {N_IMAGES} images x {R} x {F} float32 shards")
        out_path = os.path.join(wd, "graphs.json")
        gen_s, counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "fused",
             "--batch-size", str(BATCH), "--recall-k", "50", "--ema", "--seed", str(SEED)])
        want_launches = math.ceil(N_IMAGES / BATCH) * K
        log(f"generate vg1k: {gen_s:.3f} s in process, launches {counts} "
            f"(fused_decode expected {want_launches}), "
            f"{N_IMAGES * K / gen_s:.0f} triples/s including set-up")
        if counts["fused_decode"] != want_launches:
            raise AssertionError("the main path did not launch fused_decode as expected")
        check_graphs(out_path, vocab, N_IMAGES)

        # One batch of the CUDA sampler against the CPU sampler (plain
        # version) given the same noise.
        Ks, Bs = 8, 16
        sampler = make_fused_sampler(cfg, step_mask=vocab.step_mask(), num_samples=Ks)
        feats = torch.from_numpy(rng.standard_normal((Bs, R, F), dtype=np.float32))
        z = torch.randn(Ks, Bs, Z, generator=gen, device=dev).to(cfg.model.dtype)
        g = sample_gumbel((Ks, Bs, 3, V), gen, device=dev)
        gpu_tok = sampler({k_: v_.to(dev) for k_, v_ in g_ema.items()}, feats.to(dev),
                          noise=(z, g)).cpu()
        cpu_tok = sampler(g_ema, feats, noise=(z.cpu(), g.cpu()))
        agree = (gpu_tok == cpu_tok).float().mean().item()
        log(f"sampler tokens, CUDA vs CPU plain, same noise: {agree:.4f} identical")
        if gpu_tok.shape != (Bs, Ks, 3) or agree < 0.99:
            raise AssertionError("CUDA sampler disagrees with the CPU sampler")
    phase("main_path_vg1k", t0)

    # 7. Main path, pixels in: resnet50 config, synthetic images.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        pix_cfg.workdir = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            f.write(pix_cfg.to_json())
        pix_vocab.save(os.path.join(wd, "vocab.json"))
        torch.manual_seed(SEED + 5)
        pix_g = AttentionLSTMGenerator.from_config(pix_cfg).state_dict()
        save_generator(wd, pix_g, step=0, enc_params=seeded_encoder_state("resnet50"))
        out_path = os.path.join(wd, "graphs.json")
        pix_s, pix_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "fused",
             "--batch-size", str(PIX_BATCH), "--recall-k", "50", "--seed", str(SEED)])
        n_batches = math.ceil(PIX_IMAGES / PIX_BATCH)
        want_counts = {"fused_decode": n_batches * K, "fused_matmul": n_batches * 36,
                       "conv_direct": n_batches * 13, "flash_attention": 0,
                       "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
        log(f"generate resnet50: {pix_s:.3f} s in process, launches {pix_counts} "
            f"(expected {want_counts}), {PIX_IMAGES / pix_s:.1f} images/s and "
            f"{PIX_IMAGES * K / pix_s:.0f} triples/s including set-up")
        if pix_counts != want_counts:
            raise AssertionError("the pixels-in path did not launch its kernels as expected")
        check_graphs(out_path, pix_vocab, PIX_IMAGES)
    phase("main_path_resnet50", t0)

    # 8. Timing at the main paths' shapes (warm L2).
    t0 = time.perf_counter()
    records = {}

    def add(name, ms, plain_ms, lib_ms, bound_s, bound_by, weight):
        r_ = records.setdefault(name, {"w": 0, "ms": 0.0, "plain": 0.0, "lib": 0.0,
                                       "bound": 0.0, "by": Counter()})
        r_["w"] += weight
        r_["ms"] += weight * ms
        r_["plain"] += weight * plain_ms
        r_["lib"] += weight * (lib_ms or 0.0)
        r_["bound"] += weight * bound_s * 1e3
        r_["by"][bound_by] += weight

    # fused_decode, bf16 hard: the vg1k path (B = 64) and the resnet50 path
    # (B = 32). The record is the host clock (CUDA events around eager
    # calls, in turns with plain); printed apart: the device's clock (the
    # cooperative launch captured in a CUDA graph), the generic instance on
    # the same inputs, and the per-phase split from the timed check-only
    # entry (block 0's %globaltimer at every grid barrier).
    phase_names = ["mean, z, copies", "init c, h + proj", "hp", "step 1 scores", "step 1 ctx"]
    for t_ in range(1, 4):
        nxt = t_ < 3
        phase_names += [f"step {t_} gates + cell", f"step {t_} dec + next hp",
                        f"step {t_} logits" + (f" + step {t_ + 1} scores" if nxt else ""),
                        f"step {t_} sample + feedback" + (f" + step {t_ + 1} ctx" if nxt else "")]

    def decode_split(params, feats, z, g, mb):
        """Block 0's time in each phase of one launch of the timed batched
        instance, us, in phase_names' order (the last phase ends at block
        0's end, not at a barrier)."""
        B_, R_, F_ = feats.shape
        A_, H_ = params["wf"].shape[1], params["wc"].shape[1]
        E_, V_ = params["emb"].shape[1], params["wv"].shape[1]
        p_ = fd.plan(B_, R_, F_, A_, H_, E_, z.shape[1], V_, feats.dtype, mm.sm_count(0))
        stamps = torch.zeros(fd.MAX_MARKS, dtype=torch.int64, device=dev)
        scratch = torch.empty(p_.scratch, dtype=torch.uint8, device=dev)
        y = torch.empty(B_, 3, V_, dtype=feats.dtype, device=dev)
        ws = [params[n_].data_ptr() for n_ in fd.WEIGHT_NAMES]
        runs = []
        for _ in range(3):
            stamps.zero_()
            err_ = lib.sgg_fused_decode_batched_timed(
                1, B_, R_, F_, A_, H_, E_, z.shape[1], V_, feats.data_ptr(), z.data_ptr(),
                g.data_ptr(), mb.data_ptr(), 1.0, *ws, scratch.data_ptr(), y.data_ptr(),
                p_.row_tiles, p_.grid, p_.threads, p_.stages, p_.smem, p_.scratch,
                stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err_ != 0:
                raise RuntimeError(f"timed fused_decode launch failed: CUDA error {err_}")
            t_ = [v_ for v_ in stamps.tolist() if v_]
            runs.append([(t_[i_ + 1] - t_[i_]) / 1e3 for i_ in range(len(t_) - 1)])
        if any(len(r_) != len(phase_names) for r_ in runs):
            raise AssertionError(f"the timed instance stamped {[len(r_) for r_ in runs]} "
                                 f"phases, expected {len(phase_names)}")
        return [min(r_[i_] for r_ in runs) for i_ in range(len(phase_names))]

    for label, cfg_, sd_, B in (("vg1k", cfg, sd, BATCH), ("resnet50", pix_cfg, pix_sd, PIX_BATCH)):
        Rq, Fq, Aq, Hq, Eq, Zq, Vq = (cfg_.data.regions, cfg_.data.feat_dim,
                                      cfg_.model.attn_dim, cfg_.model.hidden,
                                      cfg_.model.embed_dim, cfg_.model.noise_dim,
                                      cfg_.model.vocab_size)
        dtype = cfg_.model.dtype
        params = fd.decode_params_from_generator(sd_, dtype, dev)
        mb = fd.step_mask_bias((vocab if label == "vg1k" else pix_vocab).step_mask(), dev)
        feats = torch.randn(B, Rq, Fq, generator=gen, device=dev).to(dtype)
        z = torch.randn(B, Zq, generator=gen, device=dev).to(dtype)
        g = sample_gumbel((B, 3, Vq), gen, device=dev)
        k_ms, p_ms, turns = in_turns(
            lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True),
            lambda: fd.decode_plain(params, feats, z, g, mask_bias=mb, hard=True))
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        nbytes, flops = decode_work(B, Rq, Fq, Aq, Hq, Eq, Zq, Vq, feats.element_size())
        b_s, b_by = bound(nbytes, flops, peak)
        soft_b, _ = bound(*decode_work(B, Rq, Fq, Aq, Hq, Eq, Zq, Vq, feats.element_size(),
                                       hard=False), peak)
        log(f"time fused_decode {label} {cfg_.model.compute_dtype} B={B} (record, host clock): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (turns k,k,p,p "
            f"{', '.join(f'{t:.4f}' for t in turns)}), bound {b_s * 1e3:.5f} ms ({b_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; hard mode's feedback reads the "
            f"chosen rows of emb, 3 * B * E; with all of emb and y @ emb, as soft mode needs, "
            f"{soft_b * 1e3:.5f} ms), kernel at {b_s * 1e3 / k_ms:.4f} of the bound, per batch "
            f"of {K} draws {K * k_ms:.2f} ms")
        dev_ms = graph_ms(lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True))
        rt = max(t_ for t_ in fd.ROW_TILES
                 if fd.generic_smem(Rq, Fq, Aq, Hq, Eq, Zq, Vq, t_) <= 232_448)
        gen_ms = time_ms(lambda: fd.fused_decode(params, feats, z, g, mask_bias=mb, hard=True,
                                                 row_tile=rt))
        split = decode_split(params, feats, z, g, mb)
        log(f"time fused_decode {label} B={B} on the device's clock (the cooperative launch "
            f"captured in a CUDA graph): "
            f"{dev_ms:.4f} ms; the generic instance (row tile {rt}) on the same inputs, host "
            f"clock: {gen_ms:.4f} ms (batched / generic {k_ms / gen_ms:.4f})")
        log(f"time fused_decode {label} B={B} per phase (timed instance, block 0, us, best "
            f"of 3; total {sum(split):.2f}): "
            + "; ".join(f"{n_} {v_:.2f}" for n_, v_ in zip(phase_names, split)))
        if label == "vg1k":  # the widths and batch of pipeline_v4's evaluate --decode fused
            add("fused_decode", k_ms, p_ms, None, b_s, b_by, K)
    tiny = fd.cast_params({n_: (torch.randn(*shape_, generator=torch.Generator().manual_seed(1))
                                / 4).numpy() for n_, shape_ in (
        ("wf", (24, 16)), ("wh", (32, 16)), ("bh", (16,)), ("v", (16,)), ("wc", (24, 32)),
        ("bc", (32,)), ("wi", (24, 32)), ("bi", (32,)), ("k", (80, 128)), ("bk", (128,)),
        ("wd", (56, 16)), ("bd", (16,)), ("wv", (16, 40)), ("bv", (40,)), ("emb", (40, 16)))},
        torch.bfloat16, dev)
    t_feats = torch.randn(4, 9, 24, device=dev).to(torch.bfloat16)
    t_z = torch.randn(4, 8, device=dev).to(torch.bfloat16)
    t_g = torch.randn(4, 3, 40, device=dev)
    fd.fused_decode(tiny, t_feats, t_z, t_g)
    torch.cuda.synchronize()
    host_runs = []
    for _ in range(5):  # the host's clock is shared: the least of 5 runs of 100 calls
        t_host = time.perf_counter()
        for _ in range(100):
            fd.fused_decode(tiny, t_feats, t_z, t_g)
        host_runs.append((time.perf_counter() - t_host) / 100 * 1e6)
        torch.cuda.synchronize()
    host_us = min(host_runs)
    # Printed against its limit, not held to it: a loaded host moves it (29
    # to 52 us between calls on the same code, H100).
    log(f"time fused_decode wrapper's host cost at B=4, R=9, F=24, A=16, H=32, E=16, Z=8, V=40 "
        f"(batched instance): {host_us:.1f} us per call, the least of 5 runs of 100 calls "
        f"without a synchronize ({', '.join(f'{v_:.1f}' for v_ in host_runs)}): "
        f"{'within' if host_us <= DECODE_HOST_US_LIMIT else 'OVER'} the limit of "
        f"{DECODE_HOST_US_LIMIT} us")

    # fused_matmul timed as every kernel here (host clock, CUDA events
    # around eager calls) for the record; then on the device's clock (CUDA
    # graphs) the kernel, torch.matmul and the generic instance (the tile
    # core shared with conv_direct, the kernel's earlier design) on the same
    # bf16 inputs through its own C entry, printed apart.
    def mm_generic(a, b, bias, scale, out, relu):
        M_, K__ = a.shape
        err_ = lib.sgg_fused_matmul(1, 1, int(relu), M_, b.shape[1], K__, a.data_ptr(),
                                    b.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), int(K__ % 16 == 0), int(b.shape[1] % 8 == 0),
                                    torch.cuda.current_stream().cuda_stream)
        if err_ != 0:
            raise RuntimeError(f"generic fused_matmul launch failed: CUDA error {err_}")

    mm_graph = Counter()
    for M, K_, N, relu, per_batch in RESNET_1X1 + [VGG_IM2COL]:
        a, b, bias, scale = mm_inputs(M, K_, N, torch.bfloat16)
        k_ms, p_ms, _ = in_turns(lambda: mm.fused_matmul(a, b, bias, scale, relu=relu),
                                 lambda: mm.fused_matmul_plain(a, b, bias, scale, relu=relu))
        l_ms = time_ms(lambda: torch.matmul(a, b))
        kg_ms = graph_ms(lambda: mm.fused_matmul(a, b, bias, scale, relu=relu))
        lg_ms = graph_ms(lambda: torch.matmul(a, b))
        g_out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        gg_ms = graph_ms(lambda: mm_generic(a, b, bias, scale, g_out, relu))
        p_ = mm.plan(M, K_, N, torch.bfloat16, torch.bfloat16, mm.aligned(a), mm.aligned(b),
                     mm.sm_count(a.device.index))
        nbytes, flops = matmul_work(M, K_, N, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"time fused_matmul bf16 M={M} K={K_} N={N} relu={relu} (x{per_batch} per "
            f"batch), {p_.instance} {p_.bm}x{p_.bn}x{p_.bk}, {p_.grid[0] * p_.grid[1]} blocks: "
            f"kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain "
            f"{p_ms:.4f}, torch.matmul {l_ms:.4f} (no epilogue), bound {b_s * 1e3:.5f} ms "
            f"({b_by}), kernel at {b_s * 1e3 / k_ms:.3f} of the bound; on the device's clock "
            f"(CUDA graphs): kernel {kg_ms:.4f} ms ({flops / kg_ms / 1e9:.1f} TFLOP/s, "
            f"{nbytes / kg_ms / 1e6:.0f} GB/s, {b_s * 1e3 / kg_ms:.3f} of the bound), "
            f"torch.matmul {lg_ms:.4f}, generic instance {gg_ms:.4f} (kernel / that "
            f"{kg_ms / gg_ms:.3f})")
        if per_batch:
            add("fused_matmul", k_ms, p_ms, l_ms, b_s, b_by, per_batch)
            for key, v_ in (("w", 1.0), ("kernel", kg_ms), ("library", lg_ms),
                            ("generic", gg_ms), ("host", k_ms), ("bound", b_s * 1e3)):
                mm_graph[key] += per_batch * v_
    mw = mm_graph["w"]
    log(f"time fused_matmul bf16, launch-weighted over the 36 ResNet-50 1x1 launches per "
        f"batch: on the device's clock (CUDA graphs) kernel {mm_graph['kernel'] / mw:.4f} ms, "
        f"torch.matmul {mm_graph['library'] / mw:.4f} ms, generic instance "
        f"{mm_graph['generic'] / mw:.4f} ms (kernel / generic "
        f"{mm_graph['kernel'] / mm_graph['generic']:.3f}, kernel / torch.matmul "
        f"{mm_graph['kernel'] / mm_graph['library']:.3f}); host clock kernel "
        f"{mm_graph['host'] / mw:.4f} ms; bound {mm_graph['bound'] / mw:.5f} ms; per batch "
        f"of 36 on the device: kernel {mm_graph['kernel']:.4f} ms, generic "
        f"{mm_graph['generic']:.4f} ms")
    g_small = torch.Generator(device=dev).manual_seed(SEED + 31)  # leaves gen's stream as it was
    a = torch.randn(64, 64, generator=g_small, device=dev).to(torch.bfloat16)
    b = (torch.randn(64, 64, generator=g_small, device=dev) / 8).to(torch.bfloat16)
    bias, scale = torch.zeros(64, device=dev), torch.ones(64, device=dev)

    def small_mm():
        mm.fused_matmul(a, b, bias, scale, relu=True)

    log(f"time fused_matmul wrapper, back-to-back calls at [64, 64] @ [64, 64]: "
        f"{1e3 * time_ms(small_mm):.1f} us per call (the kernel alone, device clock "
        f"{1e3 * graph_ms(small_mm):.1f} us)")

    # conv_direct timed as every kernel here (host clock, CUDA events around
    # eager calls) for the record; then on the device's clock (each call
    # captured in a CUDA graph, so the wrapper's host cost drops out) the
    # kernel, F.conv2d and the earlier design (the generic instance,
    # gemm_tile.cuh) on the same bf16 inputs through its own C entry.
    def conv_generic(x, w, bias, scale, out):
        B_, H_, W_, C_ = x.shape
        err_ = lib.sgg_conv_direct(1, 1, B_, H_, W_, C_, 3, 3, w.shape[-1], x.data_ptr(),
                                   w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), 1, 1, torch.cuda.current_stream().cuda_stream)
        if err_ != 0:
            raise RuntimeError(f"generic conv_direct launch failed: CUDA error {err_}")

    graph_rec = Counter()
    for shape, cout, per_batch in RESNET_3X3 + VGG_3X3:
        x, w, bias, scale = conv_inputs(shape, cout, torch.bfloat16)
        k_ms, p_ms, turns = in_turns(lambda: cd.conv2d_direct(x, w, bias, scale, relu=True),
                                     lambda: cd.conv2d_direct_plain(x, w, bias, scale, relu=True))
        x_cl = x.permute(0, 3, 1, 2)  # channels-last NCHW view of the NHWC tensor
        w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        l_ms = time_ms(lambda: Fnn.conv2d(x_cl, w_cl, padding=1))
        kg_ms = graph_ms(lambda: cd.conv2d_direct(x, w, bias, scale, relu=True))
        lg_ms = graph_ms(lambda: Fnn.conv2d(x_cl, w_cl, padding=1))
        p_ = cd.plan(*shape, cout, 3, 3, torch.bfloat16, mm.aligned(x), mm.aligned(w),
                     cd.sm_count(x.device.index))
        g_txt = ""
        if shape[-1] % 16 == 0:
            g_out = torch.empty(*shape[:3], cout, dtype=torch.bfloat16, device=dev)
            gg_ms = graph_ms(lambda: conv_generic(x, w, bias, scale, g_out))
            g_txt = f", generic instance {gg_ms:.4f} (kernel / that {kg_ms / gg_ms:.3f})"
            graph_rec["generic"] += per_batch * gg_ms
        nbytes, flops = conv_work(shape, cout, 3, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        log(f"time conv_direct bf16 {list(shape)}->{cout} (x{per_batch} per batch), "
            f"{p_.instance} {p_.bm}x{p_.bn}x{p_.bk}, {p_.grid[0] * p_.grid[1]} blocks: kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s; turns k,k,p,p "
            f"{', '.join(f'{t_:.4f}' for t_ in turns)}), plain {p_ms:.4f}, F.conv2d "
            f"channels-last {l_ms:.4f} (no epilogue), bound {b_s * 1e3:.5f} ms ({b_by}), "
            f"kernel at {b_s * 1e3 / k_ms:.3f} of the bound; on the device's clock (CUDA "
            f"graphs): kernel {kg_ms:.4f} ms ({flops / kg_ms / 1e9:.1f} TFLOP/s, "
            f"{b_s * 1e3 / kg_ms:.3f} of the bound), F.conv2d {lg_ms:.4f}{g_txt}")
        if per_batch:
            add("conv_direct", k_ms, p_ms, l_ms, b_s, b_by, per_batch)
            graph_rec["w"] += per_batch
            graph_rec["kernel"] += per_batch * kg_ms
            graph_rec["library"] += per_batch * lg_ms
    # The wrapper's host cost per call: back-to-back eager calls at a shape
    # whose kernel takes a few microseconds, so the host's cost sets the pace.
    g_small = torch.Generator(device=dev).manual_seed(SEED + 30)  # leaves gen's stream as it was
    x = torch.randn(1, 8, 8, 64, generator=g_small, device=dev).to(torch.bfloat16)
    w = (torch.randn(3, 3, 64, 64, generator=g_small, device=dev) / 24).to(torch.bfloat16)
    bias, scale = torch.zeros(64, device=dev), torch.ones(64, device=dev)

    def small():
        cd.conv2d_direct(x, w, bias, scale, relu=True)

    log(f"time conv_direct wrapper, back-to-back calls at [1, 8, 8, 64]->64: "
        f"{1e3 * time_ms(small):.1f} us per call (the kernel alone, device clock "
        f"{1e3 * graph_ms(small):.1f} us)")
    log(f"time conv_direct bf16, launch-weighted over the ResNet-50 3x3 shapes, on the "
        f"device's clock (CUDA graphs): kernel {graph_rec['kernel'] / graph_rec['w']:.4f} ms, "
        f"F.conv2d {graph_rec['library'] / graph_rec['w']:.4f} ms, generic instance "
        f"{graph_rec['generic'] / graph_rec['w']:.4f} ms")

    # The ResNet-50 encoder on one batch of the pixels-in path (B = 32,
    # 224 px, bf16): the kernel route against the library route.
    batch = torch.from_numpy(np.random.RandomState(SEED + 6).randint(
        0, 256, (PIX_BATCH, 224, 224, 3), dtype=np.uint8)).to(dev)
    state = seeded_encoder_state("resnet50")
    encs = {}
    for impl in ("auto", "xla"):
        encs[impl] = ResNet50Features(conv_impl=impl, dtype=torch.bfloat16)
        encs[impl].load_state_dict(state)
        encs[impl].to(dev)

    def encode(impl):
        with torch.no_grad():
            return encs[impl](normalize_for("resnet50", batch))

    k_ms, p_ms, turns = in_turns(lambda: encode("auto"), lambda: encode("xla"))
    log(f"time resnet50 encoder bf16 B={PIX_BATCH} (normalize + 53 convs): kernel route "
        f"{k_ms:.4f} ms, library route {p_ms:.4f} ms (turns k,k,l,l "
        f"{', '.join(f'{t:.4f}' for t in turns)})")

    # The same kernel-route encoder with its 3x3 convs, then its 1x1 convs,
    # on the generic instance (each kernel's earlier design) instead: ten
    # pairs each in this process, alternating which side runs first, each
    # timed eager (host clock) and as one CUDA graph (device clock). Calls
    # across processes and machines spread more than two designs differ.
    xn = normalize_for("resnet50", batch)

    def generic_conv_plan(B_, H_, W_, C_, N_, kh_, kw_, dtype_, *rest):
        return cd_plan(B_, H_, W_, C_, N_, kh_, kw_, torch.float32, *rest)

    def generic_mm_plan(M_, K__, N_, dtype_, *rest):
        return mm_plan(M_, K__, N_, torch.float32, *rest)

    def encoder_ms(mod, plan_):
        def run():
            with torch.no_grad():
                encs["auto"](xn)
        tiled_plan_ = mod.plan
        mod.plan = plan_
        try:
            return time_ms(run), graph_ms(run, n=1, reps=10)
        finally:
            mod.plan = tiled_plan_

    cd_plan, mm_plan = cd.plan, mm.plan
    for what, mod, tiled_plan, generic_plan in (
            ("3x3 convs", cd, cd_plan, generic_conv_plan),
            ("1x1 convs", mm, mm_plan, generic_mm_plan)):
        ab = {"tiled": [], "generic": []}
        for i in range(10):
            for name in (("tiled", "generic") if i % 2 == 0 else ("generic", "tiled")):
                ab[name].append(encoder_ms(mod, tiled_plan if name == "tiled" else generic_plan))
        for j, clock in ((0, "eager, host clock"), (1, "one CUDA graph, device clock")):
            t_, g_ = ([r_[j] for r_ in ab[n_]] for n_ in ("tiled", "generic"))
            log(f"time resnet50 encoder bf16 B={PIX_BATCH}, {what} tiled vs generic, 10 pairs "
                f"({clock}): median {statistics.median(t_):.4f} ms vs "
                f"{statistics.median(g_):.4f} ms, tiled faster in "
                f"{sum(a < b for a, b in zip(t_, g_))} of 10 pairs; tiled "
                f"{', '.join(f'{v:.4f}' for v in t_)}; generic "
                f"{', '.join(f'{v:.4f}' for v in g_)}")
    log(f"expected gain of the 1x1 convs in the CUDA graph: 36 x (generic - tiled) on the "
        f"device's clock = {mm_graph['generic'] - mm_graph['kernel']:.4f} ms per batch")
    phase("timing", t0)

    # 9. flash_attention vs plain at the ViT shapes and a ragged S.
    t0 = time.perf_counter()
    flash_errs = {}
    for shape in FLASH_SHAPES:
        q32, k32, v32 = (torch.randn(*shape, generator=gen, device=dev) for _ in range(3))
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k_, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            o, lse = fa.flash_attention_with_lse(q, k_, v)
            o_only = fa.flash_attention(q, k_, v)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_plain(q, k_, v, return_lse=True)
            diff = (o.float() - want.float()).abs()
            ref = want.float().abs().max().item()
            err, f32_tol = diff.max().item(), 1e-4 * ref
            share = (diff > 0).float().mean().item()
            lse_rel = ((lse - want_lse).abs() / want_lse.abs()).max().item()
            in_ulp = one_ulp_gate(o, want, f32_tol)
            if dtype == torch.float32:
                close = err <= f32_tol
            else:  # the share tells p rounded to bf16 before P.V from sum order
                close = in_ulp and share <= 1e-2
            ok = (close and lse_rel <= 1e-5 and torch.equal(o, o_only)
                  and o.dtype == dtype and o.shape == q.shape
                  and bool(torch.isfinite(o.float()).all()))
            gate = ("max_abs_err <= 1e-4 x max" if dtype == torch.float32
                    else "within 1 bf16 ulp + 1e-4 x max, share <= 1e-2")
            log(f"flash_attention vs plain {name} {list(shape)}: max_abs_err {err:.3e}, "
                f"max|plain| {ref:.3e}, within 1 bf16 ulp + 1e-4 x max {in_ulp}, share of "
                f"outputs differing {share:.3e}, lse max rel err {lse_rel:.3e} (<= 1e-5), "
                f"o with lse == o without {torch.equal(o, o_only)}; gate: {gate}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"flash_attention {name} {shape} disagrees with plain")
            flash_errs[(shape, name)] = err
            if dtype == torch.bfloat16:
                o32 = fa.launch_f32_result(q, k_, v)
                torch.cuda.synchronize()
                want32 = fa.flash_attention_plain(q, k_, v, cast=False)
                sc = ((q * torch.tensor(shape[-1] ** -0.5, dtype=dtype, device=dev)).float()
                      @ k_.float().transpose(-1, -2))
                p_ = torch.exp(sc - sc.amax(-1, keepdim=True))
                fault = fa.f32_result_error(
                    (cut_split(p_, 2) @ v.float()) / p_.sum(-1, keepdim=True), want32)
                if not f32_result_gate(f"flash_attention {list(shape)}",
                                       [fa.f32_result_error(o32, want32)], [fault],
                                       fa.F32_RESULT_TOL):
                    raise AssertionError(f"flash_attention bf16 {shape}: float32 result gate")
    phase("flash_vs_plain", t0)

    # 10. ViT-B/16, kernel route vs plain route, 8 seeded images.
    t0 = time.perf_counter()

    def seeded_vit_state():
        torch.manual_seed(SEED + 7)
        sd_ = ViTB16Features().state_dict()
        g_ = torch.Generator().manual_seed(SEED + 8)
        for k_, v_ in sd_.items():
            if k_.endswith(".scale"):
                v_.copy_(1.0 + 0.2 * torch.randn(v_.shape, generator=g_))
            elif k_.endswith(".bias"):
                v_.copy_(0.1 * torch.randn(v_.shape, generator=g_))
        return sd_

    vit_state = seeded_vit_state()

    def load_vit(dtype, kernel_route):
        kw = {"use_pallas": True} if kernel_route else {"attn_fn": fa.flash_attention_plain}
        enc = ViTB16Features(dtype=dtype, **kw)
        enc.load_state_dict(vit_state)
        return enc.requires_grad_(False).eval().to(dev)

    x = normalize_for("vit_b16", images)
    vits = {(dt, kr): load_vit(dt, kr) for dt in (torch.float32, torch.bfloat16)
            for kr in (True, False)}
    with torch.no_grad():
        want = vits[(torch.float32, False)](x).float()
        fa.launches = 0
        got = vits[(torch.float32, True)](x).float()
        torch.cuda.synchronize()
        ran = fa.launches
    err, rel2 = dist(got, want)
    ref = want.abs().max().item()
    log(f"encoder vit_b16 f32 kernel route vs plain route: out {tuple(got.shape)}, "
        f"max_abs_err {err:.3e} (<= 1e-4 x {ref:.3e}), rel L2 {rel2:.3e}, "
        f"flash_attention launches {ran} (12 expected)")
    if not (err <= 1e-4 * ref and ran == 12 and bool(torch.isfinite(got).all())):
        raise AssertionError("ViT-B/16 kernel route f32 disagrees with the plain route")
    ker, pln = vits[(torch.bfloat16, True)], vits[(torch.bfloat16, False)]
    worst_frac = worst_rel = 0.0
    with torch.no_grad():
        prev = pln.embed(x)
        for name in pln.blocks:
            want_ = getattr(pln, name)(prev)
            got_ = getattr(ker, name)(prev)
            worst_frac = max(worst_frac, (got_ != want_).float().mean().item())
            worst_rel = max(worst_rel, dist(got_.float(), want_.float())[1])
            prev = want_
        end_err, end_rel = dist(ker(x).float(), pln(x).float())
    torch.cuda.synchronize()
    log(f"encoder vit_b16 bf16 kernel route vs plain route, block by block: worst share "
        f"of elements differing {worst_frac:.3e} (<= 7e-2), worst rel L2 {worst_rel:.3e} "
        f"(<= 2e-3); end to end max_abs_err {end_err:.3e}, rel L2 {end_rel:.3e}")
    if not (worst_frac <= 7e-2 and worst_rel <= 2e-3):
        raise AssertionError("ViT-B/16 kernel route bf16 disagrees with the plain route")
    del vits, ker, pln
    phase("vit_vs_plain", t0)

    # 11. Main path, vit_b16: ViT-B/16 encoder, transformer decoder.
    t0 = time.perf_counter()
    vit_vocab = Vocab.build(
        Counter({f"object{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 872))}),
        Counter({f"predicate{i}": int(c) for i, c in enumerate(rng.integers(1, 10**6, 150))}),
    )
    assert len(vit_vocab) == VIT_VOCAB, len(vit_vocab)
    vit_cfg = get_config("vit_b16")
    vit_cfg.data.num_synthetic_images = VIT_IMAGES
    vit_cfg.model.vocab_size = VIT_VOCAB
    with tempfile.TemporaryDirectory() as wd:
        vit_cfg.workdir = wd
        with open(os.path.join(wd, "config.json"), "w") as f:
            f.write(vit_cfg.to_json())
        vit_vocab.save(os.path.join(wd, "vocab.json"))
        torch.manual_seed(SEED + 9)
        vit_g = TransformerTripleGenerator.from_config(vit_cfg).state_dict()
        save_generator(wd, vit_g, step=0, enc_params=vit_state)
        out_path = os.path.join(wd, "graphs.json")
        vit_s, vit_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", str(K), "--decode", "xla",
             "--batch-size", str(VIT_BATCH), "--recall-k", "50", "--seed", str(SEED)])
        n_batches = math.ceil(VIT_IMAGES / VIT_BATCH)
        want_counts = {"fused_decode": 0, "fused_matmul": 0, "conv_direct": 0,
                       "flash_attention": n_batches * 12, "flash_attention_bwd_dq": 0,
                       "flash_attention_bwd_dkv": 0}
        log(f"generate vit_b16: {vit_s:.3f} s in process, launches {vit_counts} "
            f"(expected {want_counts}), {VIT_IMAGES / vit_s:.1f} images/s and "
            f"{VIT_IMAGES * K / vit_s:.0f} triples/s including set-up")
        if vit_counts != want_counts:
            raise AssertionError("the vit_b16 path did not launch its kernels as expected")
        check_graphs(out_path, vit_vocab, VIT_IMAGES)

    # One batch of the CUDA sampler against the CPU sampler (plain
    # versions) given the same features (the CUDA encoder's, on the kernel
    # route, held to its plain route in phase 10) and the same noise.
    Ks, Bs = 8, VIT_BATCH
    imgs = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
        0, 256, (Bs, 224, 224, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        feats = load_vit(torch.bfloat16, True)(normalize_for("vit_b16", imgs))
    z = torch.randn(Ks, Bs, vit_cfg.model.noise_dim, generator=gen, device=dev)
    g = sample_gumbel((Ks, Bs, 3, VIT_VOCAB), gen, device=dev)
    sampler = make_sampler(vit_cfg, step_mask=vit_vocab.step_mask(), num_samples=Ks)
    gpu_tok = sampler({k_: v_.to(dev) for k_, v_ in vit_g.items()}, feats, noise=(z, g)).cpu()
    cpu_tok = make_sampler(vit_cfg, step_mask=vit_vocab.step_mask(), num_samples=Ks)(
        vit_g, feats.cpu(), noise=(z.cpu(), g.cpu()))
    agree = (gpu_tok == cpu_tok).float().mean().item()
    log(f"vit_b16 sampler tokens, CUDA vs CPU plain, same features and noise: "
        f"{agree:.4f} identical of {cpu_tok.numel()} (>= 0.99)")
    if gpu_tok.shape != (Bs, Ks, 3) or agree < 0.99:
        raise AssertionError("the CUDA vit_b16 sampler disagrees with the CPU sampler")
    phase("main_path_vit_b16", t0)

    # 12. Timing of flash_attention and the ViT-B/16 encoder (bf16, warm L2).
    t0 = time.perf_counter()
    for shape in FLASH_SHAPES[:2]:
        q, k_, v = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(3))
        k_ms, p_ms, turns = in_turns(lambda: fa.flash_attention(q, k_, v),
                                     lambda: fa.flash_attention_plain(q, k_, v))
        l_ms = time_ms(lambda: Fnn.scaled_dot_product_attention(q, k_, v))
        nbytes, flops = flash_work(shape, 2)
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        per_batch = 12 if shape == FLASH_SHAPES[0] else 0
        log(f"time flash_attention bf16 {list(shape)} (x{per_batch} per batch): kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} (turns "
            f"k,k,p,p {', '.join(f'{t:.4f}' for t in turns)}), scaled_dot_product_attention "
            f"{l_ms:.4f}, bound {b_s * 1e3:.5f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP), kernel at {b_s * 1e3 / k_ms:.3f} of the bound")
        if per_batch:
            add("flash_attention", k_ms, p_ms, l_ms, b_s, b_by, per_batch)

    batch = torch.from_numpy(np.random.RandomState(SEED + 11).randint(
        0, 256, (VIT_BATCH, 224, 224, 3), dtype=np.uint8)).to(dev)
    vits = {kr: load_vit(torch.bfloat16, kr) for kr in (True, False)}

    def vit_encode(kernel_route):
        with torch.no_grad():
            return vits[kernel_route](normalize_for("vit_b16", batch))

    k_ms, p_ms, turns = in_turns(lambda: vit_encode(True), lambda: vit_encode(False))
    log(f"time vit_b16 encoder bf16 B={VIT_BATCH} (normalize + 12 blocks): kernel route "
        f"{k_ms:.4f} ms, plain route {p_ms:.4f} ms (turns k,k,p,p "
        f"{', '.join(f'{t:.4f}' for t in turns)})")
    phase("timing_vit", t0)

    # 13. The flash backward (dq and dk/dv kernels) vs plain.
    t0 = time.perf_counter()
    bwd_errs = {}

    def faulty_bwd(q, k_, v, o, lse, do, n=1, cast=True):
        """The plain backward with p and ds cut to the first n terms of their
        split before the three products that take them (n = 1: rounded to
        bf16): another function, which the gates must refuse."""
        s_ = q.shape[-1] ** -0.5
        qs = (q * torch.tensor(s_, dtype=q.dtype, device=dev)).float()
        p = torch.exp(qs @ k_.float().transpose(-1, -2) - lse[..., None])
        ds = p * (do.float() @ v.float().transpose(-1, -2) - fb.dstat(o, do)[..., None])
        p, ds = cut_split(p, n), cut_split(ds, n)
        out = ((ds @ k_.float()) * s_, ds.transpose(-1, -2) @ qs, p.transpose(-1, -2) @ do.float())
        return tuple(t_.to(q.dtype) for t_ in out) if cast else out

    def bwd_gate(got, want, dtype):
        """dq, dk, dv against plain → (all pass, max_abs_errs, shares differing).
        float32: within 1e-4 x max; bf16: within one bf16 ulp plus that, and at
        most 1 % of the outputs differing at all (sound runs read 0.020-0.031 %,
        p and ds rounded to bf16 about 41 %)."""
        ok, errs_, shares = True, [], []
        for g_, w_ in zip(got, want):
            d_ = (g_.float() - w_.float()).abs()
            tol = 1e-4 * w_.float().abs().max().item()
            share = (d_ > 0).float().mean().item()
            close = (d_.max().item() <= tol if dtype == torch.float32
                     else one_ulp_gate(g_, w_, tol) and share <= 1e-2)
            ok = (ok and close and g_.dtype == w_.dtype and g_.shape == w_.shape
                  and bool(torch.isfinite(g_.float()).all()))
            errs_.append(d_.max().item())
            shares.append(share)
        return ok, errs_, shares

    for shape in FLASH_SHAPES:
        base = [torch.randn(*shape, generator=gen, device=dev) for _ in range(4)]
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k_, v, do = (t_.to(dtype) for t_ in base)
            o, lse = fa.flash_attention_with_lse(q, k_, v)
            got = fb.flash_attention_bwd(q, k_, v, o, lse, do)
            torch.cuda.synchronize()
            want = fb.flash_attention_bwd_plain(q, k_, v, o, lse, do)
            ok, b_errs, b_shares = bwd_gate(got, want, dtype)
            qa, ka, va = (t_.clone().requires_grad_() for t_ in (q, k_, v))
            auto = torch.autograd.grad(fa.flash_attention(qa, ka, va), (qa, ka, va), do)
            same = all(torch.equal(a_, b_) for a_, b_ in zip(auto, got))
            fault_ok, f_errs, f_shares = bwd_gate(faulty_bwd(q, k_, v, o, lse, do), want, dtype)
            log(f"flash backward vs plain {name} {list(shape)}: dq, dk, dv max_abs_err "
                f"{', '.join(f'{e:.3e}' for e in b_errs)}, share differing "
                f"{', '.join(f'{x:.3e}' for x in b_shares)}; autograd through flash_attention "
                f"== the kernels {same}; seeded fault (p, ds rounded to bf16) max_abs_err "
                f"{', '.join(f'{e:.3e}' for e in f_errs)}, share "
                f"{', '.join(f'{x:.3e}' for x in f_shares)}, refused {not fault_ok}: "
                f"{'ok' if ok and same and not fault_ok else 'FAILED'}")
            if not (ok and same):
                raise AssertionError(f"flash backward {name} {shape} disagrees with plain")
            if fault_ok:
                raise AssertionError(f"the backward gate passes a seeded fault ({name} {shape})")
            bwd_errs[(shape, name)] = b_errs
            if dtype == torch.bfloat16:
                D = fb.dstat(o, do).contiguous()
                got32 = (fb.launch_dq_f32_result(q, k_, v, do, lse, D),
                         *fb.launch_dkv_f32_result(q, k_, v, do, lse, D))
                torch.cuda.synchronize()
                want32 = (fb.dq_plain(q, k_, v, do, lse, D, cast=False),
                          *fb.dkv_plain(q, k_, v, do, lse, D, cast=False))
                cut2 = faulty_bwd(q, k_, v, o, lse, do, n=2, cast=False)
                if not f32_result_gate(
                        f"flash backward dq, dk, dv {list(shape)}",
                        [fa.f32_result_error(g_, w_) for g_, w_ in zip(got32, want32)],
                        [fa.f32_result_error(c_, w_) for c_, w_ in zip(cut2, want32)],
                        fa.F32_RESULT_TOL):
                    raise AssertionError(f"flash backward bf16 {shape}: float32 result gate")
    phase("flash_backward_vs_plain", t0)

    # 14. ViT-B/16 gradients, kernel route vs plain route, 8 seeded images and
    # a fixed linear loss.
    t0 = time.perf_counter()
    x = normalize_for("vit_b16", images)
    w_lin = torch.randn(8, 196, 768, generator=gen, device=dev)

    def vit_grads(dtype, kernel_route):
        kw = {"use_pallas": True} if kernel_route else {"attn_fn": fa.flash_attention_plain}
        enc = ViTB16Features(dtype=dtype, **kw)
        enc.load_state_dict(vit_state)
        enc.to(dev)
        zero_counts()
        loss = (enc(x).float() * w_lin).sum()
        grads = torch.autograd.grad(loss, list(enc.parameters()))
        torch.cuda.synchronize()
        ran = (fa.launches, fb.dq_launches, fb.dkv_launches)
        return {n_: g_.float() for (n_, _), g_ in zip(enc.named_parameters(), grads)}, ran

    def rel_l2(a_, b_):
        return ((a_ - b_).norm() / b_.norm()).item()

    def rel_l2_all(ga, gb):
        num = sum(((ga[n_] - gb[n_]) ** 2).sum() for n_ in gb)
        return (num.sqrt() / sum((g_ ** 2).sum() for g_ in gb.values()).sqrt()).item()

    want32, _ = vit_grads(torch.float32, False)
    got32, ran = vit_grads(torch.float32, True)
    worst = max((got32[n_] - w_).abs().max().item() / max(w_.abs().max().item(), 1e-30)
                for n_, w_ in want32.items())
    log(f"vit_b16 gradients f32, kernel route vs plain route: {len(want32)} parameters, worst "
        f"max_abs_err / max|plain| {worst:.3e} (<= 1e-4), rel L2 over all "
        f"{rel_l2_all(got32, want32):.3e}; launches flash_attention, dq, dk/dv {ran} "
        f"(12 each expected)")
    if not (worst <= 1e-4 and ran == (12, 12, 12)
            and all(bool(torch.isfinite(g_).all()) for g_ in got32.values())):
        raise AssertionError("ViT-B/16 kernel-route gradients disagree in float32")
    got16, ran16 = vit_grads(torch.bfloat16, True)
    plain16, _ = vit_grads(torch.bfloat16, False)
    k_worst = max(rel_l2(got16[n_], w_) for n_, w_ in want32.items())
    p_worst = max(rel_l2(plain16[n_], w_) for n_, w_ in want32.items())
    k_all, p_all = rel_l2_all(got16, want32), rel_l2_all(plain16, want32)
    log(f"vit_b16 gradients bf16 vs the f32 plain gradients: kernel route worst parameter rel L2 "
        f"{k_worst:.3e} (<= 1.5 x {p_worst:.3e}, the bf16 plain route's), over all {k_all:.3e} "
        f"(<= 1.5 x {p_all:.3e}); kernel vs plain route in bf16 over all "
        f"{rel_l2_all(got16, plain16):.3e}; launches {ran16}")
    if not (k_worst <= 1.5 * p_worst and k_all <= 1.5 * p_all and ran16 == (12, 12, 12)):
        raise AssertionError("ViT-B/16 kernel-route gradients disagree in bfloat16")
    del want32, got32, got16, plain16
    phase("vit_gradients", t0)

    # 15. Main path, training: the train CLI on vit_b16 with train_encoder,
    # then generate on its workdir; one step at V = 1024; and vg1k.
    t0 = time.perf_counter()
    enc_counts = {"fused_decode": 0, "fused_matmul": 0, "conv_direct": 0,
                  "flash_attention": 72, "flash_attention_bwd_dq": 60,
                  "flash_attention_bwd_dkv": 60}
    metric_keys = {"d_loss", "w_dist", "gp", "real_score", "fake_score", "g_loss",
                   "g_fake_score", "tau"}

    def read_metrics(wd, n_steps, keys):
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        if [r_["step"] for r_ in lines] != list(range(1, n_steps + 1)):
            raise AssertionError(f"metrics.jsonl steps {[r_['step'] for r_ in lines]}")
        for r_ in lines:
            if not keys <= set(r_) or not all(math.isfinite(v_) for v_ in r_.values()):
                raise AssertionError(f"metrics.jsonl line {r_} lacks a key or is not finite")
        if "images_per_sec" not in lines[-1]:
            raise AssertionError("metrics.jsonl has no throughput")
        return lines

    per_step = []  # the launches of each step of the CLI's run
    make_step = train_cli.make_step_fn

    def counting_step_fn(cfg_, step_mask=None):
        step_fn = make_step(cfg_, step_mask)

        def counted(state, batch, *args, **kwargs):
            before = read_counts()
            out = step_fn(state, batch, *args, **kwargs)
            after = read_counts()
            per_step.append({k_: after[k_] - before[k_] for k_ in after})
            return out

        return counted

    with tempfile.TemporaryDirectory() as wd:
        torch.cuda.reset_peak_memory_stats()
        train_cli.make_step_fn = counting_step_fn
        try:
            train_s, train_counts = run_cli(train_cli.main, [
                "--config", "vit_b16", "--workdir", wd, "--steps", str(VIT_TRAIN_STEPS),
                "--profile", "--set", "train.train_encoder=true",
                "--set", f"data.num_synthetic_images={VIT_IMAGES}", "--set",
                "train.log_every=1"], "sgg_torch.cli.train")
        finally:
            train_cli.make_step_fn = make_step
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want_counts = {k_: VIT_TRAIN_STEPS * v_ for k_, v_ in enc_counts.items()}
        lines = read_metrics(wd, VIT_TRAIN_STEPS, metric_keys | {"enc_gnorm"})
        vit_profile = read_profile(wd, "vit_b16 train_encoder")
        train_cfg, train_vocab = load_workdir(wd)
        train_cfg.model.vocab_size = len(train_vocab)
        t_cfg = train_cfg.train
        vit_regions = read_regions(wd, "vit_b16 train_encoder", t_cfg.n_critic,
                                   t_cfg.n_critic * max(1, t_cfg.grad_accum), False, smi)
        # Every flash backward launch of the window (the autograd engine's
        # device thread launches them) lies inside critic_update.
        crit = vit_regions["regions"]["critic_update"]["kernels"]
        bwd = {k_: sum(n_ for name_, n_ in crit.items() if k_ in name_)
               for k_ in ("flash_bwd_dq", "flash_bwd_dkv")}
        want_bwd = {"flash_bwd_dq": vit_regions["steps"] * enc_counts["flash_attention_bwd_dq"],
                    "flash_bwd_dkv": vit_regions["steps"] * enc_counts["flash_attention_bwd_dkv"]}
        log(f"regions vit_b16 train_encoder: flash backward launches inside critic_update "
            f"{bwd} (expected {want_bwd}, every one of the window's)")
        if bwd != want_bwd:
            raise AssertionError("the flash backward's launches fall outside critic_update")
        log(f"train vit_b16 train_encoder: {VIT_TRAIN_STEPS} steps in {train_s:.3f} s in process, "
            f"launches {train_counts} (expected {want_counts}); last step "
            f"{1 / lines[-1]['steps_per_sec']:.4f} s/step, {lines[-1]['images_per_sec']:.1f} "
            f"images/s; peak device memory {peak_gb:.2f} GB; widths: ViT "
            f"{train_cfg.model.vit_dims}, {train_cfg.data.image_size} px, decoder hidden "
            f"{train_cfg.model.hidden} x {train_cfg.model.num_layers} layers, V = "
            f"{train_cfg.model.vocab_size} (the synthetic source's vocab), batch "
            f"{train_cfg.train.batch_size}, n_critic {train_cfg.train.n_critic}, "
            f"{train_cfg.model.compute_dtype}; last losses d {lines[-1]['d_loss']:.4f}, "
            f"g {lines[-1]['g_loss']:.4f}, gp {lines[-1]['gp']:.4f}, enc_gnorm "
            f"{lines[-1]['enc_gnorm']:.4f}")
        log(f"launches per step: {per_step}")
        if train_counts != want_counts or per_step != [enc_counts] * VIT_TRAIN_STEPS:
            raise AssertionError("the training path did not launch its kernels as expected")
        mgr = CheckpointManager(wd, train_cfg)
        fresh = create_train_state(train_cfg, train_cfg.train.seed, device=dev)
        initial = {k_: v_.clone() for k_, v_ in fresh.encoder.state_dict().items()}
        if mgr.all_steps() != [VIT_TRAIN_STEPS] or mgr.restore(fresh, lenient=False) is None \
                or fresh.step != VIT_TRAIN_STEPS:
            raise AssertionError(f"checkpoint steps {mgr.all_steps()}, restored {fresh.step}")
        trained = fresh.encoder.state_dict()
        moved = sum(not torch.equal(initial[k_], v_) for k_, v_ in trained.items())
        saved = torch.load(os.path.join(wd, "generator.pt"), map_location="cpu",
                           weights_only=True)
        same_enc = all(torch.equal(saved["enc_params"][k_], v_.cpu())
                       for k_, v_ in trained.items())
        log(f"checkpoint {mgr.all_steps()} read back at step {fresh.step}; encoder tensors "
            f"moved {moved} of {len(trained)}; generator.pt holds the trained encoder {same_enc}")
        if moved != len(trained) or not same_enc or saved["step"] != VIT_TRAIN_STEPS:
            raise AssertionError("the trained encoder did not move or was not saved")
        del fresh, initial, trained, saved
        out_path = os.path.join(wd, "graphs.json")
        tg_s, tg_counts = run_generate(
            ["--workdir", wd, "--out", out_path, "--num-samples", "4",
             "--batch-size", str(VIT_BATCH), "--seed", str(SEED)])
        n_batches = math.ceil(VIT_IMAGES / VIT_BATCH)
        log(f"generate on the trained workdir: {tg_s:.3f} s, launches {tg_counts}")
        if tg_counts["flash_attention"] != n_batches * 12 or tg_counts["flash_attention_bwd_dq"]:
            raise AssertionError("generate on the trained workdir launched unexpectedly")
        check_graphs(out_path, train_vocab, VIT_IMAGES, k_draws=4)

    # One step at V = 1024 through the entry points the CLI uses.
    cfg1k = get_config("vit_b16")
    cfg1k.train.train_encoder = True
    cfg1k.model.vocab_size = VIT_VOCAB
    objs1k, preds1k = np.flatnonzero(vit_vocab.is_object), np.flatnonzero(vit_vocab.is_predicate)
    tri1k = [np.stack([rng.choice(objs1k, 4), rng.choice(preds1k, 4), rng.choice(objs1k, 4)],
                      axis=1).astype(np.int32) for _ in range(VIT_IMAGES)]
    ds1k = ArrayImageTripleDataset(images=np.random.RandomState(SEED + 12).randint(
        0, 256, (VIT_IMAGES, 224, 224, 3), dtype=np.uint8), triples=tri1k)
    state1k = create_train_state(cfg1k, SEED, device=dev)
    step1k = make_step_fn(cfg1k, step_mask=vit_vocab.step_mask())
    it1k = make_device_train_iterator(ds1k, cfg1k.train.batch_size, cfg1k.train.n_critic,
                                      device=dev)
    batch1k = next(it1k)
    torch.cuda.synchronize()
    zero_counts()
    t1k = time.perf_counter()
    m1k = {k_: float(v_) for k_, v_ in step1k(state1k, batch1k).items()}
    step1k_s = time.perf_counter() - t1k
    counts1k = read_counts()
    log(f"train step vit_b16 V = {VIT_VOCAB}: {step1k_s:.3f} s (the first step, cold), "
        f"launches {counts1k}, metrics {m1k}")
    if counts1k != enc_counts or not all(math.isfinite(v_) for v_ in m1k.values()):
        raise AssertionError("the V = 1024 step launched unexpectedly or is not finite")
    del state1k, step1k, it1k, batch1k, ds1k

    with tempfile.TemporaryDirectory() as wd:
        vg_s, vg_counts = run_cli(train_cli.main, [
            "--config", "vg1k", "--workdir", wd, "--steps", str(TRAIN_STEPS),
            "--set", "train.log_every=1"], "sgg_torch.cli.train")
        vg_lines = read_metrics(wd, TRAIN_STEPS, metric_keys)
        log(f"train vg1k: {TRAIN_STEPS} steps in {vg_s:.3f} s in process, launches {vg_counts} "
            f"(none expected); last step {1 / vg_lines[-1]['steps_per_sec']:.4f} s/step, "
            f"{vg_lines[-1]['images_per_sec']:.1f} images/s")
        if any(vg_counts.values()):
            raise AssertionError("vg1k training launched a kernel")
    phase("main_path_train", t0)

    # 16. Timing of the dq and dk/dv kernels (bf16, warm L2).
    t0 = time.perf_counter()
    shape = FLASH_SHAPES[0]
    q, k_, v, do = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(4))
    o, lse = fa.flash_attention_with_lse(q, k_, v)
    D = fb.dstat(o, do)
    qa, ka, va = (t_.clone().requires_grad_() for t_ in (q, k_, v))
    so = Fnn.scaled_dot_product_attention(qa, ka, va)
    l_ms = time_ms(lambda: torch.autograd.grad(so, (qa, ka, va), do, retain_graph=True))
    Bq, Hq, Sq, Dq = shape
    bhsd, bhs = Bq * Hq * Sq * Dq, Bq * Hq * Sq
    for name, kern, plain, n_in, n_out, n_prod in (
            ("flash_attention_bwd_dq", lambda: fb.launch_dq(q, k_, v, do, lse, D),
             lambda: fb.dq_plain(q, k_, v, do, lse, D), 4, 1, 3),
            ("flash_attention_bwd_dkv", lambda: fb.launch_dkv(q, k_, v, do, lse, D),
             lambda: fb.dkv_plain(q, k_, v, do, lse, D), 4, 2, 4)):
        k_ms, p_ms, turns = in_turns(kern, plain)
        nbytes = (n_in + n_out) * bhsd * 2 + 2 * bhs * 4  # + lse and D, float32
        flops = n_prod * 2 * Bq * Hq * Sq * Sq * Dq
        b_s, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        f32_floor = (n_prod - 2) * 2 * Bq * Hq * Sq * Sq * Dq / F32_FLOPS_PER_S
        log(f"time {name} bf16 {list(shape)} (x60 per train step): kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} (turns k,k,p,p "
            f"{', '.join(f'{t_:.4f}' for t_ in turns)}), scaled_dot_product_attention backward "
            f"(dq, dk and dv together) {l_ms:.4f}, bound {b_s * 1e3:.5f} ms ({b_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), reference line: float32 floor "
            f"of its products that take p or ds on the CUDA cores {f32_floor * 1e3:.5f} ms (they "
            f"now run split on the tensor cores); kernel at {b_s * 1e3 / k_ms:.3f} of the bound")
        add(name, k_ms, p_ms, l_ms, b_s, b_by, 60)
    phase("timing_backward", t0)

    # The side processes: phases 27, 22, 26, 24 and 21, 25, 28, 29 from here on,
    # beside phases 17-20 and 23 (every kernel's time is taken by now).
    torch.cuda.empty_cache()
    log(f"phases 1-16: {time.perf_counter() - t_all:.3f} s (the time by which to scale a slower "
        "machine's run)")
    sides = [side_start(g_, deadline) for g_ in SIDE_PHASES]

    # 17. Main path, pipeline_v4: a seeded corpus, the train CLI at full
    # widths (balance, int8, rotating subsets, the probe, --profile), the
    # gather's holds, then evaluate with its recipe and on fused_decode.
    # 18. The serving tier, on phase 17's workdir before it is removed, then
    # on resnet50 and vit_b16 workdirs, and its entry point in a subprocess.
    t0 = time.perf_counter()
    serving = {}

    v19, v20 = {}, {}

    def serve_v4(wd):
        t18 = time.perf_counter()
        serving.update(serve_phase(
            dev, wd, vocab, (pix_cfg, pix_vocab, pix_g, seeded_encoder_state("resnet50")),
            (vit_cfg, vit_vocab, vit_g, vit_state), zero_counts, read_counts))
        phase("serve", t18)
        # 19 (a) and (b): PredCls and REINFORCE on phase 17's workdir and corpus.
        t19 = time.perf_counter()
        v19.update(v4_predcls_reinforce_phase(dev, wd, vocab, run_cli))
        phase("predcls and reinforce on pipeline_v4", t19)
        # 20. train.steps_per_dispatch on phase 17's corpus, then the holds.
        t20 = time.perf_counter()
        v20.update(fused_dispatch_phase(dev, os.path.join(os.path.dirname(wd), "shards"),
                                        vocab, run_cli, read_counts))
        phase("fused dispatch (phase 20)", t20)

    v4_fused_counts = pipeline_v4_phase(dev, vocab, run_cli, on_workdir=serve_v4)
    phase("main_path_pipeline_v4 and serve", t0)
    log(f"serving launches: resnet50 {serving['resnet50']['launches']} over "
        f"{serving['resnet50']['chunks']} encoder chunks (warmup's included); vit_b16 "
        f"{serving['vit_b16']['launches']} for one request of {serving['vit_b16']['images']} "
        "images")

    # 19 (c). REINFORCE on vit_b16 with train_encoder: the estimator changes
    # only the generator's loss, so each step launches what phase 15's does
    # (enc_counts): the 12 attention layers of the encoder run forward with
    # gradient and backward in each of the n_critic = 5 critic updates (12 x 5
    # flash, dq and dk/dv launches) and forward once more, without gradient,
    # for the generator update (12 flash): 72, 60 and 60; the transformer
    # decoder's attention, the fakes and the surrogate launch none.
    t0 = time.perf_counter()
    per_step.clear()
    with tempfile.TemporaryDirectory() as wd:
        train_cli.make_step_fn = counting_step_fn
        try:
            vrl_s, vrl_counts = run_cli(train_cli.main, [
                "--config", "vit_b16", "--workdir", wd, "--steps", str(VIT_RL_STEPS),
                "--set", "train.train_encoder=true", "--set", "train.estimator=reinforce",
                "--set", "train.rl_entropy=0.01", "--set",
                f"data.num_synthetic_images={VIT_IMAGES}", "--set", "train.log_every=1"],
                "sgg_torch.cli.train vit_b16 reinforce")
        finally:
            train_cli.make_step_fn = make_step
        vrl_lines = read_metrics(wd, VIT_RL_STEPS, metric_keys | {
            "enc_gnorm", "rl_surrogate", "rl_adv_std", "rl_log_prob", "rl_entropy"})
    want_vrl = {k_: VIT_RL_STEPS * v_ for k_, v_ in enc_counts.items()}
    log(f"train vit_b16 train_encoder --set train.estimator=reinforce: {VIT_RL_STEPS} steps in "
        f"{vrl_s:.3f} s in process, launches {vrl_counts} (expected {want_vrl}), per step "
        f"{per_step}; last step {1 / vrl_lines[-1]['steps_per_sec']:.4f} s/step; last losses "
        f"d {vrl_lines[-1]['d_loss']:.4f}, g {vrl_lines[-1]['g_loss']:.4f}, rl_surrogate "
        f"{vrl_lines[-1]['rl_surrogate']:.4f}, rl_entropy {vrl_lines[-1]['rl_entropy']:.4f}")
    if vrl_counts != want_vrl or per_step != [enc_counts] * VIT_RL_STEPS:
        raise AssertionError("REINFORCE on vit_b16 did not launch the flash kernels as expected")
    phase("reinforce on vit_b16", t0)

    # 19 (d). preprocess on a VG-shaped corpus, then pipeline_v4 on its shards.
    t0 = time.perf_counter()
    v19["preprocess"] = preprocess_phase(dev, run_cli)
    phase("preprocess and train on its shards", t0)

    # 21 and 22 run in the side processes.

    # 23. The deployment tier: the encoders' int8 PTQ (the holds at full width,
    # the cosine contract, generate and serve --quant int8) and the exported
    # sampler (cli.export --check, serve --artifact, the bare artifact).
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with open(os.path.join(TRAINED_RUN, "config.json")) as f:
        v1k_cfg = Config.from_dict(json.load(f))
    v1k_cfg.model.vocab_size = len(vocab)
    v23 = deployment_phase(
        dev, smi, (pix_cfg, pix_vocab, pix_g, seeded_encoder_state("resnet50")),
        (vit_cfg, vit_vocab, vit_g, vit_state), seeded_encoder_state("vgg19"),
        (v1k_cfg, vocab), run_cli, read_counts,
        lambda fn: graph_ms(fn, n=P23_GRAPH_CALLS, reps=P23_GRAPH_REPS))
    phase("deployment tier (phase 23)", t0)

    # 27, 22, 26, 24 and 21, 25, 28 ran in the side processes: their output,
    # summary lines and launches.
    t0 = time.perf_counter()
    side = {"lines": {}, "launches": {}}
    for s_ in sides:
        got = side_finish(s_)
        for k_ in side:
            side[k_].update(got[k_])
    phase("the side processes' phases", t0)
    log(f"phase 19 launches: flash_attention {vrl_counts['flash_attention']}, dq "
        f"{vrl_counts['flash_attention_bwd_dq']}, dk/dv {vrl_counts['flash_attention_bwd_dkv']} "
        f"({VIT_RL_STEPS} REINFORCE steps on vit_b16); none on PredCls, REINFORCE on "
        f"pipeline_v4 or preprocess")
    e20, f20 = v20["eager"], v20["fused"]
    log(f"phase 20: pipeline_v4 eager {e20['s_per_step']:.4f} s/step, idle {e20['idle']}, "
        f"{e20['syncs']} syncs a step, peak {e20['peak_gb']:.3f} GB; fused (N = {V20_N}) "
        f"{f20['s_per_step']:.4f} s/step, idle {f20['idle']}, {f20['syncs']} syncs a step, "
        f"peak {f20['peak_gb']:.3f} GB, capture {f20['capture_s']} s and {f20['capture_gb']} "
        f"GB; {e20['s_per_step'] / f20['s_per_step']:.2f}x; holds bit for bit: pipeline_v4 "
        f"{v20['hold_v4']['equal']}, vit_b16 {v20['hold_vit']['equal']}")
    for n_ in (21, 22):
        log(side["lines"][str(n_)])
    g23 = v23["generate"]
    log(f"phase 23: {len(v23['holds'])} int8 shapes bit for bit; cosine medians "
        + ", ".join(f"{k_} {v_:.5f}" for k_, v_ in v23["cosine"].items())
        + "; generate images/s int8 vs float: " + ", ".join(
            f"{n_} {g23[(n_, 'int8')]['images_per_s']:.1f} vs "
            f"{g23[(n_, 'none')]['images_per_s']:.1f}" for n_ in ("resnet50", "vit_b16"))
        + "; export --check " + ", ".join(f"{k_} {v_['s']:.3f} s ({v_['mb']:.1f} MB)"
                                          for k_, v_ in v23["export"].items())
        + f"; launches {v23['launches']} [{smi}]")
    for n_ in (24, 25, 26, 27, 28, 29):
        log(side["lines"][str(n_)])
    log(f"total: {time.perf_counter() - t_all:.3f} s")

    sources = {"fused_decode": ("sgg_torch/kernels/csrc/fused_decode.cu",
                                "sgg/kernels/fused_decode.py:127"),
               "fused_matmul": ("sgg_torch/kernels/csrc/fused_matmul.cu",
                                "sgg/kernels/matmul.py:43"),
               "conv_direct": ("sgg_torch/kernels/csrc/conv_direct.cu",
                               "sgg/kernels/conv_direct.py:93"),
               "flash_attention": ("sgg_torch/kernels/csrc/flash_attention.cu",
                                   "sgg/kernels/flash_attention.py:35"),
               "flash_attention_bwd_dq": ("sgg_torch/kernels/csrc/flash_attention_bwd.cu",
                                          "sgg/kernels/flash_attention_bwd.py:69"),
               "flash_attention_bwd_dkv": ("sgg_torch/kernels/csrc/flash_attention_bwd.cu",
                                           "sgg/kernels/flash_attention_bwd.py:122")}
    errs = {"fused_decode": vg_errs[("bf16", BATCH)],
            "fused_matmul": max(v for k_, v in shape_errs.items()
                                if k_[0] == "mm" and k_[4] == "bf16"),
            "conv_direct": max(v for k_, v in shape_errs.items()
                               if k_[0] == "conv" and k_[3] == "bf16"),
            "flash_attention": flash_errs[(FLASH_SHAPES[0], "bf16")],
            "flash_attention_bwd_dq": bwd_errs[(FLASH_SHAPES[0], "bf16")][0],
            "flash_attention_bwd_dkv": max(bwd_errs[(FLASH_SHAPES[0], "bf16")][1:])}
    path_counts = dict(pix_counts, **{k_: train_counts[k_] for k_ in (
        "flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
    path_counts["fused_decode"] = v4_fused_counts["fused_decode"]
    for k_, v_ in v23["launches"].items():  # phase 23's int8 generate runs, from 0
        path_counts[k_] += v_
    # The side processes' runs (phase 22's paths, phase 25's CLI runs, every
    # rank of 24, 26, 27 and 28, 28's generate, and phase 29's CLI runs), each
    # counted from 0; phase 21 adds none.
    for n_ in (22, 24, 25, 26, 27, 28, 29):
        for k_, v_ in side["launches"][str(n_)].items():
            path_counts[k_] += v_
    kernels = []
    for name, (src, replaces) in sources.items():
        r_ = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": path_counts[name], "max_abs_err": errs[name],
            "ms": r_["ms"] / r_["w"], "plain_ms": r_["plain"] / r_["w"],
            "bound_ms": r_["bound"] / r_["w"], "bound_by": r_["by"].most_common(1)[0][0],
            "library_ms": r_["lib"] / r_["w"] if name != "fused_decode" else None,
        })
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-run"]:
        sys.exit(rank_run(sys.argv[2:]))
    if sys.argv[1:2] == ["--sp-attention-run"]:
        sys.exit(sp_attention_run(sys.argv[2:]))
    main()
