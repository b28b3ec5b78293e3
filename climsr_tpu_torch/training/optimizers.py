# -*- coding: utf-8 -*-
"""Optimizer factory: the port of ``climsr_tpu.training.optimizers`` (optax chains).

:func:`build_optimizer` takes the same arguments as the JAX one and returns an
:class:`OptimizerSpec`; calling it on a module's parameters gives a
:class:`ScheduledOptimizer` whose ``step()`` applies, to the parameters'
``.grad``, what the optax chain applies to the gradients:

- ``accumulate_grad_batches > 1``: ``optax.MultiSteps`` — the running mean of
  k micro-batch gradients, one inner update every k-th call, none between;
- ``gradient_clip_val > 0``: ``optax.clip_by_global_norm``;
- the update: ``torch.optim`` where its update is the optax one (adam and its
  config aliases with coupled L2, adamw with decoupled decay, adamax,
  adadelta, sgd/asgd; Adam and AdamW through torch's fused kernel), written
  out where torch differs (adagrad: optax's ``scale_by_rss`` puts eps inside
  the square root and gives 0 where the sum is 0; rmsprop: ``scale_by_rms``
  puts eps inside the root, then an optional momentum trace) or has no
  counterpart (rprop, as the JAX package's own);
- the lr ``schedule(i)`` at inner update i (0 first), and, with
  ``b1_schedule``, Adam's beta1 (or the sgd/rmsprop momentum) from it at the
  same count, as ``optax.inject_hyperparams`` re-reads it every update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch

from climsr_tpu_torch.config.schemas import OptimizerConfig
from climsr_tpu_torch.device import DeviceLike, resolve_device
from climsr_tpu_torch.training.schedules import Schedule
from climsr_tpu_torch.utils.profiling import count

_ADAM_ALIASES = ("adam", "fusedadam", "cpuadam", "onebitadam")
_NAMES = _ADAM_ALIASES + ("adamw", "adamax", "adadelta", "adagrad", "rmsprop", "sgd", "asgd", "rprop")
# how a torch optimizer runs, not what it computes: a loaded state keeps this run's
_IMPLEMENTATION = ("fused", "foreach", "capturable", "differentiable")


def global_norm(grads: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """The f32 L2 norm of the gradients taken together (``None`` skipped), as
    optax's ``global_norm``: each leaf's norm in one multi-tensor
    ``torch._foreach_norm``, then the norm of those norms, a handful of
    launches whatever the number of leaves."""
    grads = [g for g in grads if g is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)))


def _laid_out_as(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` in ``p``'s memory layout. The fused Adam kernel walks a parameter,
    its gradient and its moments in memory order, so they must share strides;
    the models' convolutions are ``channels_last`` (``models/__init__.py``),
    while an orbax checkpoint's moments, a ZeRO shard's gradient and a
    gradient set by hand come in plain OIHW order."""
    return t if t.stride() == p.stride() else torch.empty_like(p).copy_(t)


class _WrittenOut(torch.optim.Optimizer):
    """The optax updates torch does not have: ``adagrad`` (``scale_by_rss``
    with initial accumulator 0), ``rmsprop`` (``scale_by_rms(decay=0.99)`` and
    an optional ``trace``) and ``rprop`` (``climsr_tpu/training/optimizers.py:34-67``).
    Coupled L2 (``weight_decay``) is added to the gradient first."""

    def __init__(self, params, kind: str, lr: float, eps: float, weight_decay: float, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay, momentum=momentum))
        self.kind = kind

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if self.kind == "adagrad":
                    acc = state.setdefault("sum_of_squares", torch.zeros_like(p))
                    acc += g * g
                    u = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc)) * g
                    p -= group["lr"] * u
                elif self.kind == "rmsprop":
                    nu = state.setdefault("nu", torch.zeros_like(p))
                    nu.mul_(0.99).add_(0.01 * g * g)
                    u = g * torch.rsqrt(nu + group["eps"])
                    if group["momentum"]:
                        trace = state.setdefault("trace", torch.zeros_like(p))
                        u = trace.mul_(group["momentum"]).add_(u)
                    p -= group["lr"] * u
                else:  # rprop: sign-based, its own per-weight step sizes (no schedule)
                    steps = state.setdefault("step_sizes", torch.full_like(p, group["lr"]))
                    prev = state.setdefault("prev_grads", torch.zeros_like(p))
                    sign = g * prev
                    steps.copy_(torch.where(sign > 0, torch.clamp(steps * 1.2, max=50.0),
                                            torch.where(sign < 0, torch.clamp(steps * 0.5, min=1e-6), steps)))
                    g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
                    p -= torch.sign(g_eff) * steps
                    prev.copy_(g_eff)


@dataclass
class OptimizerSpec:
    """What :func:`build_optimizer` returns; ``spec(params)`` makes the optimizer."""

    cfg: OptimizerConfig
    schedule: Schedule
    gradient_clip_val: float = 0.0
    accumulate_grad_batches: int = 1
    b1_schedule: Optional[Schedule] = None
    device: torch.device = torch.device("cuda")

    def __call__(self, params: Iterable[torch.nn.Parameter]) -> "ScheduledOptimizer":
        params = list(params)
        for p in params:
            if p.device.type != self.device.type:
                raise ValueError(f"a parameter is on {p.device}, the optimizer was built for {self.device}")
        return ScheduledOptimizer(params, self)


class ScheduledOptimizer:
    """The optax chain of :class:`OptimizerSpec` over a list of parameters."""

    def __init__(self, params: List[torch.nn.Parameter], spec: OptimizerSpec):
        self.params, self.spec = params, spec
        cfg = spec.cfg
        self.name = cfg.name.lower()
        wd = cfg.weight_decay or 0.0
        betas = tuple(cfg.betas)
        # one multi-tensor kernel for the whole update; it leaves the parameters'
        # version counters alone, so step() advances them (see there)
        self.fused = self.name in _ADAM_ALIASES + ("adamw",)
        if self.name in _ADAM_ALIASES:
            self.inner = torch.optim.Adam(params, lr=cfg.lr, betas=betas, eps=cfg.eps, weight_decay=wd, fused=True)
        elif self.name == "adamw":
            self.inner = torch.optim.AdamW(params, lr=cfg.lr, betas=betas, eps=cfg.eps, weight_decay=wd, fused=True)
        elif self.name == "adamax":
            self.inner = torch.optim.Adamax(params, lr=cfg.lr, betas=betas, eps=cfg.eps, weight_decay=wd)
        elif self.name == "adadelta":
            self.inner = torch.optim.Adadelta(params, lr=cfg.lr, rho=0.9, eps=cfg.eps, weight_decay=wd)
        elif self.name in ("sgd", "asgd"):
            self.inner = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum, weight_decay=wd)
        elif self.name in ("adagrad", "rmsprop", "rprop"):
            self.inner = _WrittenOut(params, self.name, cfg.lr, cfg.eps, wd, cfg.momentum)
        else:
            raise KeyError(f"Unknown optimizer '{cfg.name}'")
        self.updates = 0  # inner updates so far: the schedules' step
        # the clip's global norm of the gradients; across ranks the state's
        # ZeroPartition.grad_norm (each element counted once over the shards)
        self.norm_fn = None
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """Apply the chain to the parameters' ``.grad`` (between accumulation
        steps only the running mean moves)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        k = self.spec.accumulate_grad_batches
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a += (g - a) / (self.mini_step + 1)
            self.mini_step += 1
            if self.mini_step < k:
                return
            grads, self.acc, self.mini_step = self.acc, None, 0
        clip = self.spec.gradient_clip_val
        if clip and clip > 0:
            norm = float((self.norm_fn or global_norm)(grads))
            if not norm < clip:
                grads = torch._foreach_mul(grads, clip / norm)
        for p, g in zip(self.params, grads):
            p.grad = _laid_out_as(p, g) if self.fused else g
        self._set_hyperparameters()
        self.inner.step()
        if self.fused:
            # the fused kernel writes the parameters without advancing their
            # versions; caches keyed on (data_ptr, _version), as the RDBs'
            # packed kernel weights are, must see the update as in-place
            torch.autograd.graph.increment_version(self.params)
            count("climsr.optim.fused_updates")
        self.updates += 1

    def state_dict(self) -> dict:
        """The inner torch optimizer's state dict, with the chain's counters
        (updates, accumulation step and running mean) under ``"chain"``."""
        out = self.inner.state_dict()
        out["chain"] = {"updates": self.updates, "mini_step": self.mini_step, "acc": self.acc}
        return out

    def load_state_dict(self, state: dict) -> None:
        """A state from :meth:`state_dict`, or one made from a JAX optax
        state (``interop.params.payload_from_jax_state``: its chain says
        ``from_jax``, and its groups hold only their parameters, so this
        optimizer's settings fill the rest)."""
        state = dict(state)
        chain = dict(state.pop("chain"))
        kind = chain.pop("from_jax", None)
        if kind is not None:
            state = self._from_jax(state, kind)
        own = self.inner.state_dict()["param_groups"]
        if len(own) == len(state["param_groups"]):
            state["param_groups"] = [{**o, **g, **{k: o[k] for k in _IMPLEMENTATION if k in o}}
                                     for o, g in zip(own, state["param_groups"])]
        self.inner.load_state_dict(state)
        if self.fused:
            for p in self.params:
                st = self.inner.state.get(p, {})
                st.update({k: _laid_out_as(p, v) for k, v in st.items() if torch.is_tensor(v) and v.shape == p.shape})
        self.updates, self.mini_step = int(chain["updates"]), int(chain["mini_step"])
        acc = chain["acc"]
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]

    def _from_jax(self, state: dict, kind: str) -> dict:
        """optax's state of ``kind`` -> this torch optimizer's names: adamax
        keeps ``nu + eps`` (torch adds eps inside its infinity norm)."""
        family = {"adam": _ADAM_ALIASES + ("adamw", "adamax"), "adadelta": ("adadelta",), "adagrad": ("adagrad",),
                  "rmsprop": ("rmsprop",), "sgd": ("sgd", "asgd"), "rprop": ("rprop",)}
        if self.name not in family[kind]:
            raise ValueError(f"the checkpoint holds optax's {kind} state; this run's optimizer is {self.name}")
        if self.name == "adamax":
            eps = self.spec.cfg.eps
            state = dict(state, state={i: {"step": s["step"], "exp_avg": s["exp_avg"], "exp_inf": s["exp_avg_sq"] + eps}
                                       for i, s in state["state"].items()})
        return state

    def _set_hyperparameters(self) -> None:
        i, spec = self.updates, self.spec
        for group in self.inner.param_groups:
            if self.name != "rprop":
                group["lr"] = spec.schedule(i)
            if spec.b1_schedule is None:
                continue
            if self.name in _ADAM_ALIASES + ("adamw",):
                group["betas"] = (spec.b1_schedule(i), group["betas"][1])
            elif self.name in ("sgd", "asgd", "rmsprop") and spec.cfg.momentum:
                group["momentum"] = spec.b1_schedule(i)


def build_optimizer(
    cfg: OptimizerConfig,
    schedule: Schedule,
    gradient_clip_val: float = 0.0,
    accumulate_grad_batches: int = 1,
    b1_schedule: Optional[Schedule] = None,
    device: DeviceLike = None,
) -> OptimizerSpec:
    """The counterpart of ``climsr_tpu/training/optimizers.py:70-143``; see the
    module docstring. ``device`` (``None`` means ``cuda``) is where the
    parameters it is given must be."""
    if cfg.name.lower() not in _NAMES:
        raise KeyError(f"Unknown optimizer '{cfg.name}'")
    return OptimizerSpec(cfg, schedule, gradient_clip_val, accumulate_grad_batches, b1_schedule,
                         resolve_device(device))
