"""``convert`` entry point: a reference TF1 checkpoint → a port workdir.

Port of ``sgg/cli/convert.py``. It writes a self-describing workdir
(``config.json``, ``vocab.json``, and the train state at step 0 through
``sgg_torch.train.checkpoint.CheckpointManager``, with ``generator.pt``)
whose generator, and critic when the source holds one, come from a
reference checkpoint, so that ``sgg_torch.cli.generate``, ``evaluate`` and
``serve`` decode with the reference's weights:

  python -m sgg_torch.cli.convert --tf-ckpt ref/model.ckpt --vocab ref_vocab.json \\
      --config vg1k --workdir /tmp/converted

``--tf-ckpt`` is read without TensorFlow (``sgg_torch.convert.read_tf_checkpoint``);
``--npz`` takes a name → array ``.npz`` instead. ``--dry-run`` prints which
variable feeds which parameter and exits 1 when one is unmatched or
ambiguous. The modules are built on ``--device`` (the card unless ``--device
cpu``); the state is saved from there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from sgg_torch.cli.common import add_config_args, resolve_config, resolve_device
from sgg_torch.convert import (
    DEFAULT_DISCRIMINATOR_MAPPING,
    DEFAULT_GENERATOR_MAPPING,
    DISCRIMINATOR_EXCLUDE,
    GENERATOR_EXCLUDE,
    convert_from_arrays,
    match_report,
    read_tf_checkpoint,
)
from sgg_torch.convert_flax import (
    critic_flax_to_state_dict,
    critic_state_dict_to_flax,
    generator_flax_to_state_dict,
    generator_state_dict_to_flax,
)
from sgg_torch.data.vocab import Vocab
from sgg_torch.train.checkpoint import CheckpointManager
from sgg_torch.train.state import create_train_state


def _load(module: torch.nn.Module, sd: dict) -> None:
    """Copy a CPU state_dict into ``module`` on its own device and dtype."""
    like = module.state_dict()
    module.load_state_dict({k: v.to(like[k].device, like[k].dtype) for k, v in sd.items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_config_args(p)
    p.add_argument("--tf-ckpt", default=None, help="TF1 Saver checkpoint prefix")
    p.add_argument("--npz", default=None, help="name→array .npz with reference vars")
    p.add_argument("--vocab", required=True, help="vocab.json matching the checkpoint")
    p.add_argument("--lenient", action="store_true",
                   help="leave unmatched params at their initialization")
    p.add_argument("--skip-discriminator", action="store_true",
                   help="convert generator weights only")
    p.add_argument("--dry-run", action="store_true",
                   help="print the variable↔param match report and exit "
                        "without writing anything")
    args = p.parse_args(argv)

    if not (args.tf_ckpt or args.npz):
        p.error("one of --tf-ckpt / --npz is required")
    if not args.workdir and not args.dry_run:
        p.error("--workdir is required")
    device = resolve_device(args.device)

    vocab = Vocab.load(args.vocab)
    cfg = resolve_config(args)
    cfg.model.vocab_size = len(vocab)

    if args.tf_ckpt:
        tf_vars = read_tf_checkpoint(args.tf_ckpt)
    else:
        with np.load(args.npz) as z:
            tf_vars = {k: z[k] for k in z.files}
    print(f"[sgg.convert] {len(tf_vars)} reference variables", flush=True)

    state = create_train_state(cfg, cfg.train.seed, device=device)
    g_tree = generator_state_dict_to_flax(state.generator.state_dict())
    d_tree = critic_state_dict_to_flax(state.critic.state_dict())

    targets = {"generator": (g_tree, DEFAULT_GENERATOR_MAPPING, GENERATOR_EXCLUDE)}
    if not args.skip_discriminator:
        targets["discriminator"] = (d_tree, DEFAULT_DISCRIMINATOR_MAPPING,
                                    DISCRIMINATOR_EXCLUDE)

    if args.dry_run:
        rep = match_report(tf_vars, targets)
        for label, name, shape in rep["matched"]:
            print(f"  match     {label}  ←  {name}  {shape}")
        for label in rep["unmatched_params"]:
            print(f"  UNMATCHED {label}")
        for label, hits in rep["ambiguous"]:
            print(f"  AMBIGUOUS {label}  ←  {hits}")
        for name in rep["unused_vars"]:
            print(f"  unused    {name}")
        print(f"[sgg.convert] dry run: {len(rep['matched'])} matched, "
              f"{len(rep['unmatched_params'])} unmatched params, "
              f"{len(rep['ambiguous'])} ambiguous, "
              f"{len(rep['unused_vars'])} unused reference vars", flush=True)
        return 1 if (rep["unmatched_params"] or rep["ambiguous"]) else 0

    g_params, unmatched = convert_from_arrays(tf_vars, g_tree, strict=not args.lenient,
                                              exclude=GENERATOR_EXCLUDE)
    if unmatched:
        print(f"[sgg.convert] WARNING unmatched: {unmatched}", file=sys.stderr)
    _load(state.generator, generator_flax_to_state_dict(g_params, cfg))

    if not args.skip_discriminator:
        rep = match_report(tf_vars, {"d": (d_tree, DEFAULT_DISCRIMINATOR_MAPPING,
                                           DISCRIMINATOR_EXCLUDE)})
        if not rep["matched"]:
            # The source holds no critic variables (e.g. a generator-only
            # .npz): a generator-only conversion stays valid.
            print("[sgg.convert] no discriminator variables found — converting "
                  "generator only", flush=True)
        else:
            d_params, d_unmatched = convert_from_arrays(
                tf_vars, d_tree, mapping=DEFAULT_DISCRIMINATOR_MAPPING,
                strict=not args.lenient, exclude=DISCRIMINATOR_EXCLUDE)
            if d_unmatched:
                print(f"[sgg.convert] WARNING unmatched (discriminator): {d_unmatched}",
                      file=sys.stderr)
            _load(state.critic, critic_flax_to_state_dict(d_params, cfg))

    ckpt = CheckpointManager(cfg.workdir, cfg)
    ckpt.save_vocab(vocab)
    ckpt.save(state)
    print(f"[sgg.convert] wrote converted checkpoint → {cfg.workdir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
