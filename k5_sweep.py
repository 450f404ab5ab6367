#!/usr/bin/env python3
"""Device time of kernel K5's tensor-core route against its split count.

Run from the root of a checkout on one CUDA card:

    python3 k5_sweep.py

For each of the cnn's three conv shapes at batch 64, bf16 (channels_last
activations, as the train step holds them), the wrapper's
``TARGET_BLOCKS`` takes each value of ``BLOCKS`` in turn (one, two, three
and four blocks a SM of an H100): the launch at each value is first held
against ``conv3x3_dw_plain`` (``TOL_DW`` of the largest value), then all
values are timed in each of ``TRIES`` torch.profiler traces (``chip_smoke.device_ms_tries``), and the median,
least and most device time per launch are printed with the split plan.
The wrapper's own value is restored at the end.  Prints the card's name
and power limit first; exits non-zero without a card.
"""

from __future__ import annotations

import sys

import chip_smoke as cs

BLOCKS = (132, 264, 396, 528)
TRIES = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_sweep: no CUDA card", file=sys.stderr)
        return 1
    cs.phase_environment()
    from distributedpytorch_tpu_torch.ops import conv

    kept = conv.TARGET_BLOCKS
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
    try:
        for (h, w, ci, co) in cs.CNN_CONVS:
            b = cs.TRAIN_BATCH
            x = torch.randn((b, ci, h, w), generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            dy = torch.randn((b, co, h, w), generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            xn, dyn = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
            ref = conv.conv3x3_dw_plain(xn, dyn)

            def launch(t):
                conv.TARGET_BLOCKS = t
                return conv._launch(xn, dyn, tensor_core=True)

            for t in BLOCKS:
                _, err = cs.rel_err(launch(t), ref)
                if not err <= cs.TOL_DW:
                    cs.fail(f"K5 at TARGET_BLOCKS {t} disagrees with its "
                            f"plain version at {(b, h, w, ci, co)}: rel err "
                            f"{err} (tol {cs.TOL_DW})")
            fns = {t: (lambda t=t: launch(t)) for t in BLOCKS}
            dev = cs.device_ms_tries(fns, tries=TRIES)
            for t in BLOCKS:
                conv.TARGET_BLOCKS = t
                med, least, most = cs.spread(dev[t])
                cs.say(f"K5 {(b, h, w, ci, co)} bfloat16 TARGET_BLOCKS {t}: "
                       f"plan {conv.mma_plan(b * h * w, ci, co)}; device_ms "
                       f"median {cs.fmt_ms(med)} [least {cs.fmt_ms(least)}, "
                       f"most {cs.fmt_ms(most)} of {len(dev[t])} traces]")
    finally:
        conv.TARGET_BLOCKS = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
