"""DeepSpeedEngine: the training engine on one device.

Port of ``deepspeed_tpu/runtime/engine.py``. The JAX engine compiles the
whole step (forward, backward, gradient accumulation, overflow check, clip,
optimizer update, lr schedule) into one program, ``train_batch()``. Here
the same step runs eagerly in PyTorch: autograd differentiates the loss,
the optimizer updates the master parameters in place, and the step
counters and the loss-scale state live on the host. Nothing synchronises
with the device unless fp16 is on (its overflow flag decides whether the
step is applied, as in the JAX engine).

What a step keeps: master parameters in fp32, or in bf16 with
stochastic-rounding updates and bf16 Adam moments when
``bf16.memory_efficient`` (the Adam family only; LAMB keeps fp32 masters
and moments); a compute-dtype copy of them per microbatch; the gradient
accumulator in fp32 (bf16 in the memory-efficient mode).
"""

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.adam import FusedAdam, fused_adam
from deepspeed_tpu_torch.ops.lamb import FusedLamb, fused_lamb
from deepspeed_tpu_torch.runtime import loss_scaler as ls
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from deepspeed_tpu_torch.runtime.utils import (clip_by_global_norm,
                                               count_parameters, global_norm)

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")
LAMB_FAMILY = ("lamb", "fusedlamb")
LATER_OPTIMIZERS = ("sgd", "adagrad", "onebitadam", "zerooneadam",
                    "onebitlamb")
LossFn = Callable[..., Any]  # (params, batch, rng) -> loss  or (loss, aux)


def _cast_floats(tree, dtype: torch.dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


class DeepSpeedEngine:
    """Training engine over one device.

    loss_fn: ``callable(params, batch, rng) -> loss | (loss, aux)``; params
    arrive cast to the compute dtype, rng is the engine's
    ``torch.Generator`` (dropout). params: nested dict of tensors (the
    master weights; copied to the device in the master dtype). config:
    ``DeepSpeedConfig``. lr_schedule: optional ``callable(step) -> lr``
    overriding the config's. device: None means the CUDA card."""

    def __init__(self, loss_fn: LossFn, params: Dict, config: DeepSpeedConfig,
                 optimizer=None, lr_schedule: Optional[Callable] = None,
                 has_aux: bool = False, device=None):
        if optimizer is not None:
            raise NotImplementedError(
                "a client optimizer waits for a later slice of the training "
                "engine; configure the Adam family in the config")
        self.config = config
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.device = resolve_device(device)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0

        self.compute_dtype = config.compute_dtype
        self.fp16_enabled = config.fp16.enabled
        self.bf16_enabled = config.bf16.enabled
        self.dynamic_loss_scale = config.fp16.dynamic_loss_scale
        if config.bf16.memory_efficient and not config.bf16.enabled:
            raise ValueError("bf16.memory_efficient requires bf16.enabled")
        self.memory_efficient_bf16 = (config.bf16.enabled
                                      and config.bf16.memory_efficient)
        self.master_dtype = (torch.bfloat16 if self.memory_efficient_bf16
                             else torch.float32)

        self.lr_schedule = lr_schedule if lr_schedule is not None else \
            get_lr_schedule(config.scheduler.type, config.scheduler.params,
                            base_lr=(config.optimizer.params or {})
                            .get("lr", 1e-3))
        self.optimizer = self._configure_basic_optimizer()
        self._params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                device=self.device, dtype=self.master_dtype, copy=True),
            params)
        self.opt_state = self.optimizer.init(self._params)
        self.step_count = 0          # applied optimizer steps
        self.scale_state = ls.init_state(
            static_scale=config.fp16.loss_scale,
            initial_scale_power=config.fp16.initial_scale_power,
            hysteresis=config.fp16.hysteresis) if self.fp16_enabled \
            else ls.init_state(static_scale=1.0)
        self.rng = torch.Generator(device=self.device).manual_seed(
            int(config.seed))
        self._last_grad_norm = None
        self.num_parameters = count_parameters(self._params)

    def _configure_basic_optimizer(self) -> Union[FusedAdam, FusedLamb]:
        """Config name -> optimizer: the Adam family and LAMB; the others
        wait."""
        ocfg = self.config.optimizer
        name = (ocfg.type or "adamw").lower()
        p = dict(ocfg.params or {})
        betas = p.get("betas", (0.9, 0.999))
        wd = p.get("weight_decay", 0.0)
        if name in ADAM_FAMILY:
            adam_w_mode = p.get("adam_w_mode", name != "adam" or wd == 0.0)
            if name == "adamw":
                adam_w_mode = True
            return fused_adam(
                self.lr_schedule, b1=betas[0], b2=betas[1],
                eps=p.get("eps", 1e-8), weight_decay=wd,
                adam_w_mode=adam_w_mode,
                state_dtype=torch.bfloat16 if self.memory_efficient_bf16
                else None)
        if self.memory_efficient_bf16:
            raise ValueError(
                "bf16.memory_efficient supports the Adam family only "
                f"(got optimizer {name!r})")
        if name in LAMB_FAMILY:
            return fused_lamb(
                self.lr_schedule, b1=betas[0], b2=betas[1],
                eps=p.get("eps", 1e-6), weight_decay=wd,
                max_coeff=p.get("max_coeff", 10.0),
                min_coeff=p.get("min_coeff", 0.01))
        if name in LATER_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {name!r} waits for a later slice of the "
                f"training engine (ported: {ADAM_FAMILY + LAMB_FAMILY})")
        raise ValueError(f"unknown optimizer {name}")

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _to_device(self, batch):
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)

    def _micro_grads(self, micro_batch):
        """(gradients of the scaled loss, unscaled loss) of one microbatch
        with respect to a compute-dtype copy of the master parameters."""
        cparams = tree_map(
            lambda t: t.detach().to(self.compute_dtype).requires_grad_(),
            self._params)
        micro_batch = _cast_floats(micro_batch, self.compute_dtype)
        out = self.loss_fn(cparams, micro_batch, self.rng)
        loss = out[0] if self.has_aux else out
        scaled = loss.float()
        if self.fp16_enabled:
            scaled = ls.scale_loss(scaled, self.scale_state)
        leaves = list(tree_leaves(cparams))
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        return tree_unflatten(cparams, grads), loss.detach().float()

    def _accum_grads(self, batch):
        """Gradient accumulation over ``gas`` microbatches: the sum of the
        microbatch gradients in the accumulator dtype, divided by ``gas``,
        and the mean loss."""
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        acc_dtype = (torch.bfloat16 if self.memory_efficient_bf16
                     else torch.float32)
        acc, loss_sum = None, 0.0
        for i in range(gas):
            micro = batch if gas == 1 else tree_map(
                lambda x: x.reshape((gas, x.shape[0] // gas) + x.shape[1:])[i],
                batch)
            g, loss = self._micro_grads(micro)
            if cfg.prescale_gradients and cfg.gradient_predivide_factor != 1.0:
                g = tree_map(lambda x: x / cfg.gradient_predivide_factor, g)
            if acc is None:
                acc = tree_map(lambda x: x.to(acc_dtype), g)
            else:
                for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(x.to(acc_dtype))
            loss_sum = loss_sum + loss
            del g
        if gas > 1:
            for a in tree_leaves(acc):
                a.div_(gas)
        return acc, loss_sum / gas

    def train_batch(self, batch) -> Dict[str, Any]:
        """One full optimizer step over a global batch (leading dimension
        ``train_batch_size``). Returns the metrics dict: ``loss``,
        ``grad_norm`` (0-dim tensors on the device), ``lr``,
        ``loss_scale``, ``overflow``."""
        cfg = self.config
        batch = self._to_device(batch)
        grads, mean_loss = self._accum_grads(batch)
        overflow = False
        if self.fp16_enabled:
            grads = ls.unscale_grads(grads, self.scale_state)
            # the one host synchronisation of the step, fp16 only: the
            # flag decides whether the update is applied
            overflow = bool(ls.has_overflow(grads))
        gnorm = global_norm(grads)
        if cfg.gradient_clipping > 0.0:
            clip_by_global_norm(grads, cfg.gradient_clipping, norm=gnorm)
        lr = float(self.lr_schedule(self.step_count))
        if not overflow:
            self.optimizer.step(
                self._params, grads, self.opt_state,
                sr_gen=self.rng if self.memory_efficient_bf16 else None)
            self.step_count += 1
        self.scale_state = ls.update(
            self.scale_state, overflow,
            dynamic=self.dynamic_loss_scale and self.fp16_enabled,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            max_hysteresis=cfg.fp16.hysteresis)
        self._last_grad_norm = gnorm
        self.global_steps += 1
        self.micro_steps += cfg.gradient_accumulation_steps
        self.global_samples += cfg.train_batch_size
        if overflow:
            self.skipped_steps += 1
        return {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": self.scale_state.loss_scale,
                "overflow": overflow}

    @torch.no_grad()
    def eval_batch(self, batch):
        """``(loss, aux)`` of a batch under the current parameters, no
        update."""
        cparams = _cast_floats(self._params, self.compute_dtype)
        out = self.loss_fn(cparams, self._to_device(batch), self.rng)
        return out if self.has_aux else (out, {})

    def forward(self, batch):
        """Evaluation forward: the loss only."""
        return self.eval_batch(batch)[0]

    __call__ = forward

    def backward(self, loss):
        raise RuntimeError(
            "the forward/backward/step triple is fused into "
            "engine.train_batch(batch); call that instead")

    def step(self):
        raise RuntimeError("see DeepSpeedEngine.backward: use train_batch()")

    # ------------------------------------------------------------------
    @property
    def params(self) -> Dict:
        """The master parameters (updated in place by every step)."""
        return self._params

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    @property
    def zero_optimization_stage(self):
        return self.config.zero.stage

    def get_global_grad_norm(self):
        """The last step's gradient norm before clipping (None before the
        first step)."""
        return None if self._last_grad_norm is None \
            else float(self._last_grad_norm)

    def get_lr(self):
        return [float(self.lr_schedule(self.step_count))]

    def get_loss_scale(self):
        return float(self.scale_state.loss_scale)

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpoint save/load waits for a later slice of the training "
            "engine")

    load_checkpoint = save_checkpoint
