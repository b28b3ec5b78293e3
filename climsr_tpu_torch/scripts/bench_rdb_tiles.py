# -*- coding: utf-8 -*-
"""Kernels A, B1 and B2 in bf16 at each output tile the chain could take, on the card.

The bf16 chain (``csrc/rdb_common.cuh`` ``conv_chain``) runs the first tile of
``ops/rdb.py`` ``_TILES`` whose feature buffer fits beside the weight ring.
At the reference defaults' widths (nf=64, gc=32) 16 x 16 does not fit, and
three tiles do: 12 x 12 (least halo recompute), 8 x 16 and 16 x 8. This script
forces each candidate in turn, twice over in the order given (so a drift of
the card shows as a difference between the two rounds), checks each kernel
against its plain version (max |kernel - plain| / max |plain| within
chip_smoke.py's bf16 tolerances) and times it with CUDA events (median of 5
runs of 5 calls) at the main paths' shapes: A at 16 x 64 x 128 x 128 (the
sweep), B1 and B2 at 192 x 64 x 32 x 32 (pre-training), seeded inputs.

Usage: ``python -m climsr_tpu_torch.scripts.bench_rdb_tiles [--gc 32]`` (one
CUDA card).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Dict, Tuple

import torch

from climsr_tpu_torch.ops import rdb
from climsr_tpu_torch.scripts.bench_head_bwd_probe import cuda_ms

NF = 64
TILES = ((12, 12), (8, 16), (16, 8))
TOL = {"A": 2e-2, "B1": 3e-2, "B2": 3e-2}  # chip_smoke.py's KERNEL_TOL and TRAIN_KERNEL_TOL in bf16


def _inputs(n: int, h: int, w: int, gc: int, device: torch.device):
    """x (N, 64, H, W) channels_last bf16, g like it at an upstream gradient's scale, five (weight, bias) pairs."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def act(scale=1.0):
        t = scale * torch.randn(n, NF, h, w, generator=gen)
        return t.to(device, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, g = act(), act(0.01)
    weights = []
    for k in range(5):
        cin, cout = NF + k * gc, gc if k < 4 else NF
        s = (9 * cin) ** -0.5
        weights.append(tuple(((torch.rand(*shape, generator=gen) * 2 - 1) * s).to(device, torch.bfloat16)
                             for shape in ((cout, cin, 3, 3), (cout,))))
    return x, g, weights


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def tile_times(tile: Tuple[int, int], gc: int, device: torch.device) -> Dict[str, Tuple[float, float]]:
    """{kernel: (ms, relative error)} with the bf16 chain held to ``tile``."""
    kept = rdb._TILES[torch.bfloat16]
    rdb._TILES[torch.bfloat16] = (tile,)
    try:
        x, _, weights = _inputs(16, 128, 128, gc, device)
        packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
        err = _rel(rdb.fused_rdb(x, weights, None, packed), rdb.rdb_reference(x, weights))
        result = {"A": (cuda_ms(lambda: rdb.fused_rdb(x, weights, None, packed)), err)}

        x, g, weights = _inputs(192, 32, 32, gc, device)
        packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
        out, feat = rdb.fused_rdb_fwd_save(x, weights, None, packed)
        ref_out, ref_feat = rdb.rdb_fwd_save_reference(x, weights)
        err = max(_rel(out, ref_out), _rel(feat, ref_feat))
        result["B1"] = (cuda_ms(lambda: rdb.fused_rdb_fwd_save(x, weights, None, packed)), err)
        got = rdb.fused_rdb_bwd(ref_feat, g, weights, 0.2, 1.0)
        want = rdb.rdb_bwd_reference(ref_feat, g, weights, 0.2, 1.0)
        err = max(_rel(a, b) for a, b in zip([got[0], *got[1], *got[2][:4]], [want[0], *want[1], *want[2][:4]]))
        result["B2"] = (cuda_ms(lambda: rdb.fused_rdb_bwd(ref_feat, g, weights, 0.2, 1.0)), err)
    finally:
        rdb._TILES[torch.bfloat16] = kept
    for name, (_, err) in result.items():
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at gc={gc}, tile {tile}: kernel disagrees with its plain version ({err:.3e})")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gc", type=int, default=32)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_rdb_tiles needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"# bf16 RDB kernels at nf={NF}, gc={args.gc}, by forced tile ({card}); the wrapper's own: "
          f"{rdb._tile(NF, args.gc, torch.bfloat16)}")
    for rnd in (1, 2):
        for tile in TILES:
            r = tile_times(tile, args.gc, device)
            print(f"round {rnd} tile {tile[0]}x{tile[1]}: " + ", ".join(
                f"{name} {ms:.4f} ms (err {err:.2e})" for name, (ms, err) in r.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
