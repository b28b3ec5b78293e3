# -*- coding: utf-8 -*-
"""Kernels A, B1, B2 and D in bf16 at each (nf, gc) asked for, on the card.

For each width: A (with and without the folded residual), B1 (out and feat),
B2 (dx, every dW and db) and D (``fused_rdb_nhwc``) against their plain
versions on seeded inputs, at the training shape (192 x nf x 32 x 32) and a
ragged one (3 x nf x 29 x 45), within chip_smoke.py's bf16 tolerances
(max |kernel - plain| / max |plain|: 2e-2 for A and D, 3e-2 for B1 and B2);
then A, B1 and B2 timed at the training shape with CUDA events (median of 5
runs of 5 calls) beside their bound on an H100 (the larger of the operations
at the dense bf16 rate and the bytes at the memory rate). One JSON line per
width.

``--root DIR`` imports ``climsr_tpu_torch`` from DIR, so one call can time
another checkout of the repo (a parent commit unpacked with ``git archive``)
beside this one, in turns; run the script by its path for that:

    python climsr_tpu_torch/scripts/bench_rdb_widths.py --root DIR --nf 64 --gc 16,32 --no-check

Usage: ``python -m climsr_tpu_torch.scripts.bench_rdb_widths [--nf 32,48,96,128] [--gc 16,32]``
(one CUDA card).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

TOL = {"A": 2e-2, "D": 2e-2, "B1": 3e-2, "B2": 3e-2}  # chip_smoke.py's KERNEL_TOL, TRAIN_KERNEL_TOL in bf16
SHAPES = ((192, 32, 32), (3, 29, 45))  # the training shape (timed) and a ragged one
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12  # H100 SXM, NVIDIA's data sheet


def inputs(n: int, h: int, w: int, nf: int, gc: int, device: torch.device):
    """x, x0, g (N, nf, H, W) channels_last bf16 (g at an upstream gradient's scale), five (weight, bias) pairs."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def act(scale=1.0):
        t = scale * torch.randn(n, nf, h, w, generator=gen)
        return t.to(device, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, x0, g = act(), act(), act(0.01)
    weights = []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        s = (9 * cin) ** -0.5
        weights.append(tuple(((torch.rand(*shape, generator=gen) * 2 - 1) * s).to(device, torch.bfloat16)
                             for shape in ((cout, cin, 3, 3), (cout,))))
    return x, x0, g, weights


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def macs_per_px(nf: int, gc: int) -> int:
    return 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)


def bound_ms(flops: float, moved: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check(rdb, nf: int, gc: int, device: torch.device) -> dict:
    """The largest relative error of each kernel over both shapes; raises past its tolerance."""
    worst = dict.fromkeys(TOL, 0.0)
    for n, h, w in SHAPES:
        x, x0, g, weights = inputs(n, h, w, nf, gc, device)
        packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
        for res in (None, x0):
            worst["A"] = max(worst["A"], rel(rdb.fused_rdb(x, weights, res, packed),
                                             rdb.rdb_reference(x, weights, res)))
        out, feat = rdb.fused_rdb_fwd_save(x, weights, None, packed)
        ref_out, ref_feat = rdb.rdb_fwd_save_reference(x, weights)
        worst["B1"] = max(worst["B1"], rel(out, ref_out), rel(feat, ref_feat))
        for res, (gy, gx) in ((None, (0.2, 1.0)), (x0, (0.04, 0.2))):
            got = rdb.fused_rdb_bwd(ref_feat, g, weights, gy, gx)
            want = rdb.rdb_bwd_reference(ref_feat, g, weights, gy, gx)
            worst["B2"] = max(worst["B2"], *(rel(a, b) for a, b in zip([got[0], *got[1], *got[2]],
                                                                     [want[0], *want[1], *want[2]])))
        hwio = [t for wt, bs in weights for t in (wt.permute(2, 3, 1, 0), bs)]
        worst["D"] = max(worst["D"], rel(rdb.fused_rdb_nhwc(x.permute(0, 2, 3, 1), *hwio),
                                         rdb.rdb_reference(x, weights).permute(0, 2, 3, 1)))
    torch.cuda.synchronize()
    for name, err in worst.items():
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at nf={nf}, gc={gc}: kernel disagrees with its plain version ({err:.3e})")
    return worst


def times(rdb, nf: int, gc: int, device: torch.device) -> dict:
    """{kernel: {ms, plain_ms, bound_ms, bound_by}} at the training shape."""
    from climsr_tpu_torch.scripts.bench_head_bwd_probe import cuda_ms  # the timed checkout's

    n, h, w = SHAPES[0]
    x, _, g, weights = inputs(n, h, w, nf, gc, device)
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    _, feat = rdb.fused_rdb_fwd_save(x, weights, None, packed)
    px, total, macs = n * h * w, nf + 4 * gc, macs_per_px(nf, gc)
    wbytes = 4 * macs + 4 * (4 * gc + nf)
    runs = {
        "A": (lambda: rdb.fused_rdb(x, weights, None, packed), lambda: rdb.rdb_reference(x, weights),
              bound_ms(2.0 * macs * px, px * 2 * 2 * nf + wbytes)),
        "B1": (lambda: rdb.fused_rdb_fwd_save(x, weights, None, packed),
               lambda: rdb.rdb_fwd_save_reference(x, weights),
               bound_ms(2.0 * macs * px, px * 2 * (2 * nf + total) + wbytes)),
        "B2": (lambda: rdb.fused_rdb_bwd(feat, g, weights, 0.2, 1.0),
               lambda: rdb.rdb_bwd_reference(feat, g, weights, 0.2, 1.0),
               bound_ms(4.0 * macs * px, px * 2 * (total + 2 * nf) + wbytes)),
    }
    return {name: dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), bound_ms=b[0], bound_by=b[1])
            for name, (kernel, plain, b) in runs.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nf", default="32,48,96,128", help="comma-separated widths")
    parser.add_argument("--gc", default="16,32", help="comma-separated growth widths")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                        help="the checkout whose climsr_tpu_torch is timed")
    parser.add_argument("--tag", default="", help="a label printed on each line")
    parser.add_argument("--no-check", action="store_true", help="time only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rdb_widths needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from climsr_tpu_torch.ops import rdb

    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# bf16 RDB kernels from {Path(rdb.__file__).resolve().parents[2]} ({card})", flush=True)
    for nf in (int(v) for v in args.nf.split(",")):
        for gc in (int(v) for v in args.gc.split(",")):
            row = dict(tag=args.tag, nf=nf, gc=gc, tile=list(rdb._tile(nf, gc, torch.bfloat16)), card=card)
            if not args.no_check:
                row["rel_err"] = check(rdb, nf, gc, device)
            row.update(times(rdb, nf, gc, device))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
