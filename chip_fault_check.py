#!/usr/bin/env python3
"""Seeded-fault check of the flash backward's gate, on the card.

  python3 chip_fault_check.py

Copies the port (``sgg_torch/``) into a temporary directory, rounds p and ds
to bfloat16 in the copy's ``csrc/flash_attention_bwd.cu`` before the three
products that take them (another function than the reference's), builds the
copy's kernels with nvcc, and holds its dq, dk and dv against the plain
backward under ``chip_smoke.py``'s bf16 gate (within one bf16 ulp of plain plus
1e-4 x max, and at most 1 % of the outputs differing) at [32, 12, 196, 64] and
[32, 12, 100, 64]. Exits 0 when the gate refuses the faulty kernel for every
shape and output, 1 when it passes any. The tree itself is not touched.
"""

import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(32, 12, 196, 64), (32, 12, 100, 64)]
# (sound line, faulty line) of the copy's kernel source.
FAULTS = [
    ("srow[key] = p * (prow[key] - d_r);  // ds",
     "srow[key] = __bfloat162float(__float2bfloat16(p * (prow[key] - d_r)));"),
    ("      srow[qi] = p;\n",
     "      srow[qi] = __bfloat162float(__float2bfloat16(p));\n"),
    ("prow[qi] = p * (prow[qi] - Ds[qi]);  // ds",
     "prow[qi] = __bfloat162float(__float2bfloat16(p * (prow[qi] - Ds[qi])));"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_fault_check: CUDA is not available; this script needs the card")
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ROOT, "sgg_torch"), os.path.join(tmp, "sgg_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(tmp, "sgg_torch", "kernels", "csrc", "flash_attention_bwd.cu")
        with open(src) as f:
            text = f.read()
        for sound, faulty in FAULTS:
            if text.count(sound) != 1:
                raise SystemExit(f"chip_fault_check: the kernel no longer has {sound.strip()!r}")
            text = text.replace(sound, faulty)
        with open(src, "w") as f:
            f.write(text)
        sys.path.insert(0, tmp)
        from sgg_torch.kernels import flash_attention as fa
        from sgg_torch.kernels import flash_attention_bwd as fb

        if not fb.__file__.startswith(tmp):
            raise SystemExit(f"chip_fault_check: imported {fb.__file__}, not the copy")
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        refused = []
        for shape in SHAPES:
            q, k, v, do = (torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                           for _ in range(4))
            o, lse = fa.flash_attention_with_lse(q, k, v)
            got = fb.flash_attention_bwd(q, k, v, o, lse, do)
            want = fb.flash_attention_bwd_plain(q, k, v, o, lse, do)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                w32 = w.float()
                diff = (g.float() - w32).abs()
                ulp = torch.ldexp(torch.ones_like(w32), torch.frexp(w32.abs())[1] - 8)
                ulp = torch.where(w32 == 0, torch.zeros_like(ulp), ulp)
                in_ulp = bool((diff <= ulp + 1e-4 * w32.abs().max()).all())
                share = (diff > 0).float().mean().item()
                passes = in_ulp and share <= 1e-2
                refused.append(not passes)
                print(f"[chip_fault_check] p, ds rounded to bf16, {list(shape)} {name}: "
                      f"max_abs_err {diff.max().item():.3e}, within 1 ulp + 1e-4 x max "
                      f"{in_ulp}, share differing {share:.3e}; the gate refuses it "
                      f"{not passes}", flush=True)
    ok = all(refused)
    verdict = "the gate refuses the fault" if ok else "THE GATE PASSES THE FAULT"
    print(f"[chip_fault_check] {verdict}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
