# -*- coding: utf-8 -*-
"""Where kernel A's time goes inside a block: SM clocks per phase of its conv chain, on the card.

Builds ``csrc/rdb_fwd.cu`` with ``-DCLIMSR_PHASE_CLOCKS`` into
``build/kernels/``: thread 0 of each block then writes ``clock64()`` at 8
points (entry; x and the first weight chunk landed; after each growth conv's
epilogue; after conv5's products; after its epilogue). :func:`phase_clocks`
runs that build of kernel A once at the inference path's shape (16 x 64 x 128
x 128 bf16, seeded weights), checks it against ``rdb_reference``, and returns
the mean clocks of each phase over the blocks, beside the time of a launch
with and without the clocks being written (CUDA events).

Usage: ``python -m climsr_tpu_torch.scripts.rdb_phase_clocks`` (one CUDA card).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict

import torch

from climsr_tpu_torch.ops import cuda_lib, rdb
from climsr_tpu_torch.scripts.bench_head_bwd_probe import cuda_ms

N, NF, H, W, GC = 16, 64, 128, 128, 16
PHASES = ("x and first chunk", "conv1", "conv2", "conv3", "conv4", "conv5 products", "conv5 epilogue")
TOL = 2e-2  # as chip_smoke.py's KERNEL_TOL for bf16


def _build() -> ctypes.CDLL:
    path = cuda_lib.BUILD_DIR / "librdb_phase_clocks.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-DCLIMSR_PHASE_CLOCKS", "-o", str(path),
           str(cuda_lib.CSRC / "rdb_fwd.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    lib.climsr_rdb_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.climsr_rdb_phase_clocks.argtypes = [ctypes.c_void_p]
    return lib


def phase_clocks(device: torch.device) -> Dict[str, float]:
    """Mean SM clocks per phase of a block of kernel A (and "total", "ms",
    "ms with clocks"); raises if the build disagrees with the plain version."""
    if device.type != "cuda":
        raise RuntimeError(f"phase clocks are read on a CUDA card, got {device}")
    lib = _build()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(N, NF, H, W, generator=gen).to(device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    weights = []
    for k in range(5):
        cin, cout = NF + k * GC, GC if k < 4 else NF
        bound = 1.0 / (9 * cin) ** 0.5
        weights.append((((torch.rand(cout, cin, 3, 3, generator=gen) * 2 - 1) * bound).to(device, torch.bfloat16),
                        ((torch.rand(cout, generator=gen) * 2 - 1) * bound).to(device, torch.bfloat16)))
    packed = rdb.pack_rdb_weights(weights, torch.bfloat16)
    th, tw = rdb._tile(NF, GC, torch.bfloat16)
    blocks = N * -(-H // th) * -(-W // tw)
    clocks = torch.zeros(blocks, 8, dtype=torch.int64, device=device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        err = lib.climsr_rdb_fwd(x.data_ptr(), None, out.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
                                 N, H, W, NF, GC, th, tw, 1, stream)
        if err != 0:
            raise RuntimeError(f"kernel A (phase-clock build) failed: CUDA error {err}")

    result = {}
    for key, ptr in (("ms", None), ("ms with clocks", clocks.data_ptr())):
        if lib.climsr_rdb_phase_clocks(ptr) != 0:
            raise RuntimeError("could not set the phase-clock buffer")
        result[key] = cuda_ms(launch)
    torch.cuda.synchronize()
    ref = rdb.rdb_reference(x, weights).float()
    rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
    if not (rel <= TOL):
        raise AssertionError(f"kernel A (phase-clock build) disagrees with rdb_reference ({rel:.3e})")
    t = clocks.cpu().double()
    result["total"] = (t[:, 7] - t[:, 0]).mean().item()
    for i, name in enumerate(PHASES):
        result[name] = (t[:, i + 1] - t[:, i]).mean().item()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("rdb_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    r = phase_clocks(torch.device("cuda"))
    print(f"# kernel A at {N}x{NF}x{H}x{W} bf16 ({card}): {r['ms']:.4f} ms a launch, "
          f"{r['ms with clocks']:.4f} ms writing the clocks; mean SM clocks per block {r['total']:.0f}")
    for name in PHASES:
        print(f"#   {name:18s} {r[name]:9.0f} clocks ({100 * r[name] / r['total']:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
