# -*- coding: utf-8 -*-
"""Time kernel F's two variants against kernel C and the library's conv, on the card.

The counterpart of ``scripts/bench_head_bwd_probe.py``, which timed on the
TPU candidate replacements for the fusion head's input gradient to channel 0
(the dX of its 9x9 conv1). At the training head's shape, [192, 128, 128, 64]
bf16 (g channels_last, seeded), :func:`probe`:

1. checks F1 ("flat") and F2 ("dyfac") of
   :func:`climsr_tpu_torch.ops.head_bwd.dc0` against ``dc0_reference``
   (max |kernel - plain| / max |plain|, within ``TOL``). On the card both
   variants launch kernel C's kernel through F's entry point (its weight
   view and its own count), so F1, F2 and C time the same kernel;
2. times, with CUDA events (median of 5 runs of 5 calls, after a warm-up),
   the library call that computes the same function
   (``F.conv_transpose2d(g, W[:, :1], padding=4)``), the plain version
   ``dc0_reference``, kernel C (``conv9_dx_c0``), F1 and F2.

The TPU probe's "NHWC -> (C, L) transpose" timing (its steps 2 and 4) is
dropped: the port has no relayout, its kernels read g where it lies. Its
``chain_kernel`` mock is not in the TPU script's code either.

Usage: ``python -m climsr_tpu_torch.scripts.bench_head_bwd_probe`` (one CUDA card).
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from typing import Dict

import torch
import torch.nn.functional as F

from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0, dc0_reference

B, H, W, C = 192, 128, 128, 64
# bf16: both sides read the same bf16 g and bf16-rounded weights and sum in
# f32; they differ by summation order and by the output's one rounding (2^-8)
TOL = 1e-2


def cuda_ms(fn, reps: int = 5, inner: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def probe(device: torch.device) -> Dict[str, Dict[str, float]]:
    """Check and time the candidates at [B, H, W, C] bf16; raises if a kernel
    disagrees with its plain version. Returns {name: {"ms", ...}} with
    ``max_abs_err`` and ``rel_err`` for F1 ("dc0_flat") and F2 ("dc0_dyfac")."""
    if device.type != "cuda":
        raise RuntimeError(f"the probe times kernels on a CUDA card, got {device}")
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(B, C, H, W, generator=gen).to(device, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w1c0 = (torch.randn(9, 9, C, generator=gen) * 0.05).to(device)
    weight = w1c0.permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)  # (C, 1, 9, 9): W[c, 0, u, v] = w1c0[u, v, c]
    print(f"# probe at [{B},{H},{W},{C}] bf16 on {torch.cuda.get_device_name(device)}")
    ref = dc0_reference(g, w1c0).float()
    results: Dict[str, Dict[str, float]] = {}
    for variant in ("flat", "dyfac"):
        got = dc0(g, w1c0, variant).float()
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = abs_err / max(ref.abs().max().item(), 1e-30)
        print(f"  {variant}: max rel err vs dc0_reference = {rel:.2e} (tol {TOL:g})")
        if not (rel <= TOL):
            raise AssertionError(f"dc0 {variant} disagrees with dc0_reference ({rel:.3e})")
        results[f"dc0_{variant}"] = dict(max_abs_err=abs_err, rel_err=rel)
    timed = {
        "library conv_transpose2d": lambda: F.conv_transpose2d(g, weight, padding=4),
        "plain dc0_reference": lambda: dc0_reference(g, w1c0),
        "kernel C conv9_dx_c0": lambda: conv9_dx_c0(g, weight),
        "dc0_flat": lambda: dc0(g, w1c0, "flat"),
        "dc0_dyfac": lambda: dc0(g, w1c0, "dyfac"),
    }
    for name, fn in timed.items():
        ms = cuda_ms(fn)
        results.setdefault(name, {})["ms"] = ms
        print(f"  {name}: {ms:.4f} ms")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_head_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"# card: {card}")
    probe(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
