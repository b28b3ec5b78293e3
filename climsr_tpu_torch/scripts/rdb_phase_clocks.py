# -*- coding: utf-8 -*-
"""Where kernels A's and E's time goes inside a block: SM clocks per phase, on the card.

Builds ``csrc/rdb_fwd.cu`` and ``csrc/hr_tail.cu`` with
``-DCLIMSR_PHASE_CLOCKS`` into ``build/kernels/``.

- Kernel A: thread 0 of each block writes ``clock64()`` at 8 points (entry;
  x and the first weight chunk landed; after each growth conv's epilogue;
  after conv5's products; after its epilogue). :func:`phase_clocks` runs that
  build once at the inference path's shape (16 x 64 x 128 x 128 bf16, seeded
  weights), checks it against ``rdb_reference``, and returns the mean clocks
  of each phase over the blocks, beside the time of a launch with and without
  the clocks being written (CUDA events).
- Kernel E (bf16, persistent blocks): thread 0 of each block sums the clocks
  of each phase over the block's tiles (x landed and lrelu'd in place;
  HRconv's products; their epilogue; conv_last's projection; its
  shift-adds).
  :func:`hr_tail_phase_clocks` runs it at the training head's shape (192 x
  64 x 128 x 128), checks it against ``hr_tail_reference`` and returns the
  mean sums over the blocks.

Usage: ``python -m climsr_tpu_torch.scripts.rdb_phase_clocks`` (one CUDA card).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict

import torch

from climsr_tpu_torch.ops import cuda_lib, head, rdb
from climsr_tpu_torch.scripts.bench_head_bwd_probe import cuda_ms

N, NF, H, W, GC = 16, 64, 128, 128, 16
PHASES = ("x and first chunk", "conv1", "conv2", "conv3", "conv4", "conv5 products", "conv5 epilogue")
E_SHAPE = (192, NF, 128, 128)
E_PHASES = ("x landed, lrelu", "HRconv products", "HRconv epilogue", "conv_last projection",
            "conv_last shift-adds")
TOL = 2e-2  # as chip_smoke.py's KERNEL_TOL (and TAIL_TOL) for bf16


def _build(source: str, setter: str) -> ctypes.CDLL:
    path = cuda_lib.BUILD_DIR / f"lib{source.split('.')[0]}_phase_clocks.so"
    path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-DCLIMSR_PHASE_CLOCKS", "-o", str(path),
           str(cuda_lib.CSRC / source)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc -DCLIMSR_PHASE_CLOCKS {source} exited {built.returncode}:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(path))
    getattr(lib, setter).argtypes = [ctypes.c_void_p]
    return lib


def _timed(lib, setter: str, launch, clocks: torch.Tensor) -> Dict[str, float]:
    result = {}
    for key, ptr in (("ms", None), ("ms with clocks", clocks.data_ptr())):
        if getattr(lib, setter)(ptr) != 0:
            raise RuntimeError("could not set the phase-clock buffer")
        result[key] = cuda_ms(launch)
    torch.cuda.synchronize()
    return result


def _check(out: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    if not (rel <= TOL):
        raise AssertionError(f"{what} (phase-clock build) disagrees with its plain version ({rel:.3e})")


def phase_clocks(device: torch.device) -> Dict[str, float]:
    """Mean SM clocks per phase of a block of kernel A (and "total", "ms",
    "ms with clocks"); raises if the build disagrees with the plain version."""
    if device.type != "cuda":
        raise RuntimeError(f"phase clocks are read on a CUDA card, got {device}")
    lib = _build("rdb_fwd.cu", "climsr_rdb_phase_clocks")
    lib.climsr_rdb_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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

    result = _timed(lib, "climsr_rdb_phase_clocks", launch, clocks)
    _check(out, rdb.rdb_reference(x, weights), "kernel A")
    t = clocks.cpu().double()
    result["total"] = (t[:, 7] - t[:, 0]).mean().item()
    for i, name in enumerate(PHASES):
        result[name] = (t[:, i + 1] - t[:, i]).mean().item()
    return result


def hr_tail_phase_clocks(device: torch.device) -> Dict[str, float]:
    """Mean SM clocks per block spent in each phase of kernel E's bf16 tiles
    (and "total", "ms", "ms with clocks"); raises if the build disagrees with
    the plain version."""
    if device.type != "cuda":
        raise RuntimeError(f"phase clocks are read on a CUDA card, got {device}")
    lib = _build("hr_tail.cu", "climsr_hr_tail_phase_clocks")
    lib.climsr_hr_tail.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    n, c, h, w = E_SHAPE
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, c, h, w, generator=gen).to(device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bound = 1.0 / (9 * NF) ** 0.5
    weights = [((torch.rand(s, generator=gen) * 2 - 1) * bound).to(device)
               for s in ((NF, NF, 3, 3), (NF,), (1, NF, 3, 3), (1,))]
    wp, bh, wl, bl = head.pack_tail(*weights, torch.bfloat16)
    clocks = torch.zeros(torch.cuda.get_device_properties(device).multi_processor_count, 8, dtype=torch.int64,
                         device=device)
    out = torch.empty((n, 1, h, w), dtype=torch.bfloat16, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        err = lib.climsr_hr_tail(x.data_ptr(), out.data_ptr(), wp.data_ptr(), bh.data_ptr(), wl.data_ptr(),
                                 bl.data_ptr(), n, h, w, 1, stream)
        if err != 0:
            raise RuntimeError(f"kernel E (phase-clock build) failed: CUDA error {err}")

    result = _timed(lib, "climsr_hr_tail_phase_clocks", launch, clocks)
    _check(out, head.hr_tail_reference(x, weights), "kernel E")
    t = clocks.cpu().double()[:, :len(E_PHASES)]
    result["total"] = t.sum(1).mean().item()
    for i, name in enumerate(E_PHASES):
        result[name] = t[:, i].mean().item()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("rdb_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    r = phase_clocks(device)
    print(f"# kernel A at {N}x{NF}x{H}x{W} bf16 ({card}): {r['ms']:.4f} ms a launch, "
          f"{r['ms with clocks']:.4f} ms writing the clocks; mean SM clocks per block {r['total']:.0f}")
    for name in PHASES:
        print(f"#   {name:18s} {r[name]:9.0f} clocks ({100 * r[name] / r['total']:.1f}%)")
    r = hr_tail_phase_clocks(device)
    print(f"# kernel E at {'x'.join(map(str, E_SHAPE))} bf16 ({card}): {r['ms']:.4f} ms a launch, "
          f"{r['ms with clocks']:.4f} ms summing the clocks; mean SM clocks per block {r['total']:.0f}")
    for name in E_PHASES:
        print(f"#   {name:18s} {r[name]:9.0f} clocks ({100 * r[name] / r['total']:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
