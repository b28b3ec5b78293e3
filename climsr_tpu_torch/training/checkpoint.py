# -*- coding: utf-8 -*-
"""Checkpointing: reference-style PyTorch-Lightning ``.ckpt`` files with top-k
tracking by ``hp_metric``. The port of ``climsr_tpu.training.checkpoint``.

Parity: the reference's ModelCheckpoint callback (monitor hp_metric, mode=min,
save_top_k, ``conf/callbacks/model_checkpoint.yaml``), resume
(``cli/train.py:91-93``) and the generator-only fine-tune restore
(``cli/train.py:112-121``).

Each save writes ``epoch={epoch}-step={step}.ckpt`` with ``torch.save``, in
the layout of a reference PL checkpoint:

- ``state_dict``: the generator's tensors under ``generator.`` and, for the
  GAN task, the discriminator's under ``discriminator.`` (what
  ``interop/params.py`` reads back);
- ``optimizer_states`` (generator first) and ``lr_schedulers`` (each
  schedule's position);
- ``global_step`` (micro-batches, as the JAX state's step) and ``epoch``;
- ``hyper_parameters``: the composed config as a plain dict.

Only tensors, numbers, strings and containers go in, so the files load with
``torch.load(weights_only=True)``. ``config.json`` (the composed config) and
``index.json`` (step -> file, hp_metric) sit beside them. ``save_top_k`` > 0
keeps the k best by hp_metric (mode min); 0 saves nothing unless forced (the
preemption save); -1 keeps everything. A checkpoint saved without a metric is
never evicted.

The JAX package's orbax checkpoints are read too (``interop/orbax.py``,
without orbax, tensorstore or JAX): :func:`restore_pytree` and
:func:`extract_generator_params` are the JAX module's, and
:func:`load_checkpoint` turns an orbax directory into the dict above
(``interop.params.payload_from_jax_state``), so a run trained on the TPU
resumes, fine-tunes and sweeps here through the same callers.
"""
from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from climsr_tpu_torch.interop import orbax
from climsr_tpu_torch.interop.orbax import restore_pytree  # noqa: F401  (the JAX module's name)
from climsr_tpu_torch.interop.params import load_generator_checkpoint, payload_from_jax_state

logger = logging.getLogger(__name__)

CKPT_SUFFIX = ".ckpt"


class CheckpointManager:
    def __init__(self, directory, save_top_k: int = 100, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.save_top_k = int(save_top_k)
        self.mode = mode
        self._index_path = self.directory / "index.json"
        # step -> {"file": name, "hp_metric": float or None}
        self._index: Dict[int, Dict[str, Any]] = {}
        if self._index_path.exists():
            self._index = {int(k): v for k, v in json.loads(self._index_path.read_text()).items()}

    def save(self, step: int, payload: Dict[str, Any], hp_metric: Optional[float] = None,
             config: Optional[Dict] = None, force: bool = False) -> Optional[Path]:
        """Write ``payload`` (a PL-style checkpoint dict) for ``step``; returns its path."""
        if self.save_top_k == 0 and not force:
            return None
        name = f"epoch={int(payload.get('epoch', 0))}-step={int(step)}{CKPT_SUFFIX}"
        path = self.directory / name
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        metric = None if hp_metric is None or not math.isfinite(float(hp_metric)) else float(hp_metric)
        old = self._index.get(int(step))
        if old is not None and old["file"] != name:
            (self.directory / old["file"]).unlink(missing_ok=True)
        self._index[int(step)] = {"file": name, "hp_metric": metric}
        self._evict()
        self._index_path.write_text(json.dumps({str(k): v for k, v in sorted(self._index.items())}, indent=2))
        if config is not None:
            cfg_path = self.directory / "config.json"
            if not cfg_path.exists():
                cfg_path.write_text(json.dumps(config, indent=2, default=str))
        return path

    def _ranked(self):
        """Steps with a metric, best first (ties: the later step first)."""
        scored = [(v["hp_metric"], s) for s, v in self._index.items() if v["hp_metric"] is not None]
        sign = 1.0 if self.mode == "min" else -1.0
        return [s for _, s in sorted(scored, key=lambda t: (sign * t[0], -t[1]))]

    def _evict(self) -> None:
        if self.save_top_k <= 0:
            return
        for step in self._ranked()[self.save_top_k:]:
            (self.directory / self._index.pop(step)["file"]).unlink(missing_ok=True)

    @property
    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._index) if self._index else None

    def path(self, step: Optional[int] = None) -> Path:
        """The file of ``step`` (default: the latest)."""
        step = step if step is not None else self.latest_step
        if step is None or step not in self._index:
            raise FileNotFoundError(f"No checkpoint{'' if step is None else f' at step {step}'} in {self.directory}")
        return self.directory / self._index[step]["file"]

    def restore(self, step: Optional[int] = None, map_location: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
        """The checkpoint dict of ``step`` (default: the latest)."""
        return load_checkpoint(self.path(step), map_location)



def checkpoint_file(path) -> Path:
    """``path`` if it is a file, else the latest ``.ckpt`` of the port's
    checkpoint directory, else the item directory of a JAX orbax checkpoint
    (a manager root, a step directory or its ``default/``). A directory of
    neither format raises ``FileNotFoundError`` naming both."""
    p = Path(path)
    if not p.is_dir():
        return p
    if (p / "index.json").exists():
        return CheckpointManager(p, save_top_k=-1).path()
    return orbax.item_directory(p)


def load_checkpoint(path, map_location: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """A ``.ckpt`` file, a checkpoint directory's latest one, or a JAX orbax
    checkpoint as the same dict."""
    f = checkpoint_file(path)
    if f.is_dir():
        payload = payload_from_jax_state(orbax.restore_pytree(f))
        return _to(payload, torch.device(map_location))
    return torch.load(f, map_location=map_location, weights_only=True)


def _to(obj, device: torch.device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to(v, device) for v in obj]
    return obj


def extract_generator_params(restored: Any) -> Any:
    """The generator's param tree of a restored JAX state
    (``climsr_tpu/training/checkpoint.py:97-114``): ``params`` of a
    ``TrainState``, else ``g_params`` of a ``GANTrainState``, else the tree
    itself. Key presence, not truthiness: an empty ``params`` is returned as
    it is."""
    if isinstance(restored, dict):
        if "params" in restored:
            return restored["params"]
        if "g_params" in restored:
            return restored["g_params"]
    return restored


def restore_generator_params(path, model: torch.nn.Module) -> Tuple[int, int]:
    """Generator-only restore for fine-tuning (``cli/train.py:112-121``): copy
    into ``model`` every tensor of the checkpoint's generator whose name and
    shape match, keep the fresh initialization for the rest (rcan.py:195-219's
    lenient tail handling). ``path``: a ``.ckpt`` (the port's or the
    reference's), a plain ``state_dict`` file, a checkpoint directory or a
    JAX orbax checkpoint (its generator's subtree alone is read).
    Returns (tensors copied, tensors of ``model``'s ``state_dict``)."""
    source = load_generator_checkpoint(checkpoint_file(path))
    own = model.state_dict()
    copied = {k: v for k, v in source.items() if k in own and own[k].shape == v.shape}
    with torch.no_grad():
        for k, v in copied.items():
            own[k].copy_(v)
    logger.info("Generator restore: %d tensors copied, %d kept fresh", len(copied), len(own) - len(copied))
    return len(copied), len(own)
