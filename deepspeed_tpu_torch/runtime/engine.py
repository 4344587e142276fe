"""DeepSpeedEngine: the training engine, on one device or across
data-parallel ranks.

Port of ``deepspeed_tpu/runtime/engine.py``. The JAX engine compiles the
whole step (forward, backward, gradient accumulation, overflow check, clip,
optimizer update, lr schedule) into one program, ``train_batch()``. Here
the same step runs eagerly in PyTorch: autograd differentiates the loss,
the optimizer updates the master parameters in place, and the step
counters and the loss-scale state live on the host. Nothing synchronises
with the device unless fp16 is on (its overflow flag decides whether the
step is applied, as in the JAX engine), the model draws its dropout seeds
or layer-drop decisions on the card, or a ``steps_per_print`` boundary
reports the loss and the throughput.

What a step keeps: master parameters in fp32, or in bf16 with
stochastic-rounding updates and bf16 Adam moments when
``bf16.memory_efficient`` (the Adam family only; LAMB, SGD and Adagrad
keep fp32 masters and state); a compute-dtype copy of them per
microbatch; the gradient accumulator in fp32 (bf16 in the memory-efficient
mode).

Across ranks (a mesh over a ``torch.distributed`` process group,
``parallel/mesh.py``): every rank passes the same global batch, as in the
JAX engine's multi-process contract, and computes the gradient of its
rows of each micro batch (micro batch ``i`` is global rows ``[i*B/gas,
(i+1)*B/gas)``, split over the dp ranks); the ZeRO stage decides what
each rank keeps and how the gradients are reduced
(``runtime/zero/partition.py``); the loss, the overflow flag and the
gradient norm are the whole global batch's. A loss function with a
``normalizers(batch)`` attribute (``models.gpt``'s, ``models.bert``'s)
gets the global micro batch's normalisers in its micro batch
(``parallel.mesh.DataParallelContext`` under ``DP_CONTEXT_KEY``) and
returns its rows' share of the global mean; any other loss function is
taken to return the plain mean over its rows, weighted by one over the
dp degree (exact when every rank's normaliser is its row count). The
engine's generator is seeded alike on every rank, so that layer-drop
decisions and stochastic-rounding noise agree on replicated state; the
port's models mix the dp rank into their dropout seeds, so that masks
differ between ranks.

Sequence parallelism (a mesh ``sequence`` axis above 1): the ranks of a
sequence group take the same rows and the loss function cuts each one's
token columns (``models.gpt``'s); the parameters are replicated over the
axis, so the gradients are summed over the sequence ranks as well as the
dp ranks (``parallel.mesh.GRAD_AXES``), and the step's one all-reduce of
loss, squares and overflow spans both. A loss function without
``normalizers`` is weighted one over dp x sequence ranks. The dropout
mix is the rank's index over dp x sequence.

Tensor parallelism (a mesh ``model`` axis above 1, with partition
rules): the ranks of a model group take the same rows. A loss function
with a ``tp_columns`` attribute (``models.gpt``'s and ``models.bert``'s)
is given this rank's model pieces and runs Megatron's layers
(``parallel/tensor.py``); any other gets every leaf whole, gathered over
the axis before the call (its gradient then identical on every model
rank, of which each keeps its pieces). The step's one all-reduce of loss,
squares and overflow spans the model ranks too. ``model`` x
``sequence`` raises.

Pipeline parallelism (a mesh ``pipe`` axis above 1, with
``models.gpt.gpt_pipeline_partition_rules``): the ranks of a pipe group
take the same rows. A loss function with a ``pipe_stages`` attribute
(``models.gpt.make_pipeline_loss_fn``, ``runtime/pipe/engine.py``) is
given this stage's rows of the stacked leaves and runs the schedule over
the group, returning the same loss and the same gradients of the
replicated leaves on every stage; any other gets every leaf whole,
gathered over the axis. The step's one all-reduce spans the pipe ranks
too, and ``eval_batch`` runs the loss's ``eval_fn`` where it has one.
``pipe`` x ``sequence`` raises.

Around the step, as in the JAX engine: the seqlen curriculum truncates
the batch, progressive layer drop puts its keep probability into each
micro batch, the monitor buffers the scalars and writes them every
``steps_per_print`` steps, the timers time ``train_batch``, and the flops
profiler reports the ``profile_step``-th step, and each step runs under
the trace range ``ds.train_batch`` (``utils/trace.py``), which
``start_trace`` captures for the next steps. ``save_checkpoint`` and
``load_checkpoint`` are ``runtime/checkpointing.py``'s.
"""

import atexit
import time
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.parallel.tensor import same_columns
from deepspeed_tpu_torch.ops.adam import adagrad, fused_adam
from deepspeed_tpu_torch.ops.lamb import FusedLamb, fused_lamb
from deepspeed_tpu_torch.ops.sgd import sgd
from deepspeed_tpu_torch.runtime import loss_scaler as ls
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.lora import LORA_TRAINING, has_lora
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    PLD_THETA_KEY, ProgressiveLayerDrop, theta_schedule)
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
from deepspeed_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from deepspeed_tpu_torch.runtime.utils import (clip_by_global_norm,
                                               count_parameters)
from deepspeed_tpu_torch.utils import groups as groups_lib
from deepspeed_tpu_torch.utils import trace
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.monitor import Monitor, NoopMonitor
from deepspeed_tpu_torch.utils.timer import (TRAIN_BATCH_TIMER, NoopTimer,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer, device_sync)

ADAM_FAMILY = ("adam", "adamw", "fusedadam", "cpuadam")
LAMB_FAMILY = ("lamb", "fusedlamb")
LATER_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")
LossFn = Callable[..., Any]  # (params, batch, rng) -> loss  or (loss, aux)


def _is_optimizer(obj) -> bool:
    """The port's optimizer protocol: ``init(params) -> state`` and
    ``step(params, grads, state, sr_gen=None)`` updating both in place."""
    return callable(getattr(obj, "init", None)) \
        and callable(getattr(obj, "step", None))


def _flush_at_exit(ref) -> None:
    engine = ref()
    if engine is not None:
        engine.destroy()


def _cast_floats(tree, dtype: torch.dtype):
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


class DeepSpeedEngine:
    """Training engine over one device or a mesh of data-parallel ranks.

    loss_fn: ``callable(params, batch, rng) -> loss | (loss, aux)``; params
    arrive cast to the compute dtype, rng is the engine's
    ``torch.Generator`` (dropout, layer drop). params: nested dict of
    tensors (the master weights; copied to the device in the master
    dtype). config: ``DeepSpeedConfig``. optimizer: a client optimizer
    overriding the config's, any object with the port's protocol
    (``init(params) -> state``, ``step(params, grads, state, sr_gen)``
    updating both in place, as ``ops.adam.FusedAdam``); its state must be
    nested dicts of tensors and numbers to go through checkpoints.
    lr_schedule: optional ``callable(step) -> lr`` overriding the
    config's. mesh: a ``parallel.mesh.Mesh`` (default
    ``mesh_from_config``: over the process group when there is one, else
    one rank); partition_rules: ``parallel.sharding.PartitionRule``s.
    Across ranks whose optimizer state is split (ZeRO >= 1) a client
    optimizer must update element by element. params may be
    ``zero.Init``'s sharded tree, taken as it is. device: None means the
    CUDA card (``cuda:{local_rank}`` under ranks)."""

    def __init__(self, loss_fn: LossFn, params: Dict, config: DeepSpeedConfig,
                 mesh=None, partition_rules=None, optimizer=None,
                 lr_schedule: Optional[Callable] = None,
                 has_aux: bool = False, device=None):
        if optimizer is not None and not _is_optimizer(optimizer):
            raise TypeError(
                f"a client optimizer needs the port's protocol, "
                f"init(params) -> state and step(params, grads, state, "
                f"sr_gen=None); got {type(optimizer).__name__}")
        self.config = config
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None \
            else mesh_lib.mesh_from_config(config)
        self.dp_world_size = mesh_lib.dp_world_size(self.mesh)
        self.mp_world_size = mesh_lib.axis_size(self.mesh, "model")
        self.sp_world_size = mesh_lib.axis_size(self.mesh, "sequence")
        self.pp_world_size = mesh_lib.axis_size(self.mesh, "pipe")
        if self.pp_world_size > 1 and self.sp_world_size > 1:
            raise NotImplementedError(
                "a mesh with 'pipe' and 'sequence' axes above 1 waits for "
                "ROADMAP §1.3.4a (pipeline x sequence parallelism)")
        if self.mp_world_size > 1 and self.sp_world_size > 1:
            from deepspeed_tpu_torch.parallel.tensor import TP_WITH_SEQUENCE
            raise NotImplementedError(
                f"a mesh with 'model' and 'sequence' axes above 1 waits for "
                f"{TP_WITH_SEQUENCE}")
        if self.dp_world_size * self.sp_world_size * self.mp_world_size \
                * self.pp_world_size > 1 and not self.mesh.ranked:
            raise ValueError(
                f"a mesh of {self.dp_world_size} data-parallel x "
                f"{self.sp_world_size} sequence x {self.mp_world_size} "
                f"model x {self.pp_world_size} pipe ranks needs a process "
                f"group: call deepspeed_tpu_torch.init_distributed on every "
                f"rank first")
        if self.mesh.ranked and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        groups_lib.set_mesh(self.mesh)
        self.partition_rules = list(partition_rules or [])
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        # start_trace's open window, the steps left in it, and the path of
        # the last trace written
        self._trace: Optional[trace.Capture] = None
        self._trace_steps_left = 0
        self.last_trace: Optional[str] = None

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
        self.optimizer = optimizer if optimizer is not None \
            else self._configure_basic_optimizer()
        # the ZeRO layouts over the mesh and this rank's store boxes of the
        # master parameters (runtime/zero/partition.py); on a mesh without
        # a process group each collective is a no-op or a copy
        zc = config.zero
        shapes = getattr(params, "shapes", params)
        # a loss that runs Megatron's layers takes the model pieces, its
        # fused qkv columns head-aligned; any other gets whole leaves
        tp_columns = getattr(loss_fn, "tp_columns", None)
        model_pieces = self.mp_world_size > 1 and tp_columns is not None
        # a pipeline loss takes its stage's rows, any other whole leaves
        pipe_pieces = self.pp_world_size > 1 \
            and getattr(loss_fn, "pipe_stages", None) is not None
        self._zero = ZeroPartition(
            shapes, self.mesh, zc.stage, self.partition_rules,
            zc.stage3_min_shard_size,
            columns=tp_columns(self.mp_world_size) if model_pieces else None,
            model_pieces=model_pieces, pipe_pieces=pipe_pieces)
        self.param_pspecs = self._zero.param_specs
        if config.train_batch_size % (config.gradient_accumulation_steps
                                      * self.dp_world_size):
            raise ValueError(
                f"train_batch_size {config.train_batch_size} does not split "
                f"into {config.gradient_accumulation_steps} micro batches "
                f"over {self.dp_world_size} data-parallel ranks")
        self._params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                device=self.device, dtype=self.master_dtype, copy=True),
            self._store_of(params))
        self.opt_state = self.optimizer.init(
            self._zero.update_slices(self._params))
        # a runtime/lora.py tree trains only with the adapter mask and a
        # tape that differentiates the LoRA terms: its steps raise
        self._lora_tree = has_lora(self._params)
        self.step_count = 0          # applied optimizer steps
        self.scale_state = ls.init_state(
            static_scale=config.fp16.loss_scale,
            initial_scale_power=config.fp16.initial_scale_power,
            hysteresis=config.fp16.hysteresis) if self.fp16_enabled \
            else ls.init_state(static_scale=1.0)
        self.rng = torch.Generator(device=self.device).manual_seed(
            int(config.seed))
        self._last_grad_norm = None
        self.num_parameters = count_parameters(shapes)

        # the metrics monitor: scalars buffered between steps_per_print
        # boundaries (a float() per step would wait for the device)
        self.monitor = Monitor.from_config(config.tensorboard) \
            if config.tensorboard.enabled else NoopMonitor()
        self._monitor_buffer = []
        if config.tensorboard.enabled:
            atexit.register(_flush_at_exit, weakref.ref(self))
        self.wall_clock_breakdown = config.wall_clock_breakdown
        self.timers = SynchronizedWallClockTimer(self.device) \
            if self.wall_clock_breakdown else NoopTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print, device=self.device)
        self._flops_per_batch = None
        self._last_step_duration = 0.0
        fp = config.flops_profiler
        if fp.enabled and (fp.module_depth != -1 or fp.top_modules != 1):
            raise NotImplementedError(
                "flops_profiler.module_depth and top_modules need a "
                "per-module profile; the engine's profile covers the whole "
                "step (leave them at -1 and 1)")

        if config.curriculum.enabled:
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                CurriculumScheduler)
            cc = config.curriculum
            self.curriculum_scheduler = CurriculumScheduler({
                "curriculum_type": cc.curriculum_type,
                "min_difficulty": cc.min_difficulty,
                "max_difficulty": cc.max_difficulty,
                "schedule_type": cc.schedule_type,
                "schedule_config": cc.schedule_config})
        else:
            self.curriculum_scheduler = None
        self._curriculum_transform = None
        self.progressive_layer_drop = ProgressiveLayerDrop(
            theta=config.pld.theta, gamma=config.pld.gamma) \
            if config.pld.enabled else None

    def reseed_rng(self) -> int:
        """Reseed the generator from ``(config seed, global_steps)``;
        returns the seed."""
        seed = int(np.random.SeedSequence(
            [int(self.config.seed), int(self.global_steps)])
            .generate_state(1)[0])
        self.rng.manual_seed(seed)
        return seed

    def _configure_basic_optimizer(self):
        """Config name -> optimizer: the Adam family, LAMB, SGD and
        Adagrad; the 1-bit ones wait."""
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
        if name == "sgd":
            return sgd(self.lr_schedule, momentum=p.get("momentum", 0.0),
                       nesterov=p.get("nesterov", False))
        if name == "adagrad":
            return adagrad(self.lr_schedule, eps=p.get("eps", 1e-8),
                           weight_decay=wd)
        if name in LATER_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {name!r} waits for a later slice of the "
                f"training engine (ported: "
                f"{ADAM_FAMILY + LAMB_FAMILY + ('sgd', 'adagrad')})")
        raise ValueError(f"unknown optimizer {name}")

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _to_device(self, batch):
        """The batch on the engine's device; tensors already there (a
        ``PrefetchLoader``'s) pass through untouched."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)

    def _store_of(self, params) -> Dict:
        """The master parameters this rank keeps: each leaf's store box
        (the whole leaf but at ZeRO 3 across ranks), cut before the copy
        to the engine's device; ``zero.Init``'s shards as they are when
        their layout is the engine's (else gathered whole and cut
        again, a leaf at a time where only the column order differs)."""
        source = getattr(params, "partition", None)
        if source is None:
            return tree_map(lambda t, lay: t if lay.store_is_full
                            else self._zero.cut(torch.as_tensor(t), lay),
                            params, self._zero.layouts)
        if source.param_specs != self._zero.param_specs:
            return self._zero.shard(source.full(params))
        # the same boxes: a leaf cut in another column order (zero.Init's
        # contiguous qkv under a loss that takes head-aligned pieces) is
        # gathered whole and cut again, every other one taken as it is
        src = {lay.path: lay for lay in source.flat}

        def take(t, lay):
            if same_columns(src[lay.path].stored_columns,
                            lay.stored_columns):
                return t
            return self._zero.cut(source.whole_leaf(t, src[lay.path]), lay)
        return tree_map(take, dict(params), self._zero.layouts)

    def _rank_rows(self, micro):
        """(this rank's rows of a global micro batch, its
        DataParallelContext or None, the weight of its loss): the context
        (and weight 1) for a loss with ``normalizers``, else weight one
        over the dp degree (the plain mean of the per-rank means; over dp x
        sequence ranks under sequence parallelism, where every sequence
        rank of a row computes its whole loss). One rank takes the micro
        batch as it is. The sequence ranks of a dp rank take the same
        rows: the loss function cuts their columns."""
        ranks = self.dp_world_size * self.sp_world_size
        if ranks == 1:
            return micro, None, 1.0
        rows = mesh_lib.batch_rows(
            self.mesh, next(iter(tree_leaves(micro))).shape[0])
        local = tree_map(lambda x: x[rows], micro)
        norms = getattr(self.loss_fn, "normalizers", None)
        if norms is None:
            return local, None, 1.0 / ranks
        if not isinstance(micro, dict):
            raise TypeError("a loss function with normalizers takes a dict "
                            "batch")
        return local, mesh_lib.DataParallelContext(
            rank=self.mesh.axis_index(mesh_lib.GRAD_AXES),
            normalizers=norms(micro)), 1.0

    def _compute_source(self):
        """The master tree the compute copy is cast from: this rank's
        store, or (ZeRO 3 across ranks; a loss without ``tp_columns`` over
        a ``model`` axis, or without ``pipe_stages`` over a ``pipe`` axis)
        every leaf's compute box gathered in the compute dtype, once per
        step."""
        if self._zero.store_is_compute:
            return self._params
        return self._zero.compute(self._params, dtype=self.compute_dtype)

    def _micro_grads(self, micro_batch, source, ctx=None, weight=1.0):
        """(gradients of the scaled loss, unscaled loss) of one microbatch
        with respect to a compute-dtype copy of ``source`` (the master
        tree, :meth:`_compute_source`). ctx: the DataParallelContext put
        into the micro batch; weight: the factor of the loss (across
        ranks)."""
        cparams = tree_map(
            lambda t: t.detach().to(self.compute_dtype).requires_grad_(),
            source)
        micro_batch = _cast_floats(micro_batch, self.compute_dtype)
        if self.progressive_layer_drop is not None \
                and isinstance(micro_batch, dict):
            # the keep probability is a function of the applied steps, as
            # in the JAX engine's step (skipped fp16 steps do not count)
            pld = self.config.pld
            micro_batch = dict(micro_batch)
            micro_batch[PLD_THETA_KEY] = theta_schedule(
                self.step_count, pld.theta, pld.gamma)
        if ctx is not None:
            micro_batch = dict(micro_batch)
            micro_batch[mesh_lib.DP_CONTEXT_KEY] = ctx
        out = self.loss_fn(cparams, micro_batch, self.rng)
        loss = out[0] if self.has_aux else out
        if weight != 1.0:
            loss = loss * weight
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
        and the mean loss. Across ranks micro batch ``i`` is global rows
        ``[i*B/gas, (i+1)*B/gas)``, of which this rank takes its own."""
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        acc_dtype = (torch.bfloat16 if self.memory_efficient_bf16
                     else torch.float32)
        source = self._compute_source()
        acc, loss_sum = None, 0.0
        for i in range(gas):
            micro = batch if gas == 1 else tree_map(
                lambda x: x.reshape((gas, x.shape[0] // gas) + x.shape[1:])[i],
                batch)
            micro, ctx, weight = self._rank_rows(micro)
            g, loss = self._micro_grads(micro, source, ctx, weight)
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
        ``loss_scale``, ``overflow``. A tree with LoRA adapters
        (``lora_a`` leaves) raises ``NotImplementedError``: adapter
        training waits for the LoRA-training slice."""
        if self._lora_tree:
            raise NotImplementedError(
                f"a training step over LoRA adapters (lora_a leaves) waits "
                f"for the {LORA_TRAINING} slice of the port; serve them "
                f"(init_inference) or merge them (runtime.lora.merge_lora)")
        cfg = self.config
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        if self.curriculum_scheduler is not None:
            difficulty = self.curriculum_scheduler.update_difficulty(
                self.global_steps + 1)
            batch = self._apply_curriculum(batch, difficulty)
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(
                self.global_steps - self.skipped_steps)
        batch = self._to_device(batch)
        # the mesh whose groups the model's collectives take (another
        # engine may have registered its own since)
        groups_lib.set_mesh(self.mesh)
        if self.dp_world_size * self.sp_world_size > 1:
            rows = next(iter(tree_leaves(batch))).shape[0]
            if rows != cfg.train_batch_size:
                raise ValueError(
                    f"every rank passes the same global batch of "
                    f"train_batch_size={cfg.train_batch_size} rows (got "
                    f"{rows}); the engine takes this rank's rows itself")
        profiling_now = (cfg.flops_profiler.enabled
                         and self.global_steps + 1
                         == cfg.flops_profiler.profile_step)
        counting = profiling_now and self._flops_source(batch)[0] is None
        # a loss that records the layers it computes (models.gpt's) does
        # so for the profiled step, whose analytic count then has only
        # the layers that ran
        layers_run = [] if profiling_now \
            and hasattr(self.loss_fn, "layers_run") else None
        if profiling_now:
            # time exactly this step: wait for the queued earlier ones
            device_sync(self.device)
        t0 = time.perf_counter()
        if layers_run is not None:
            self.loss_fn.layers_run = layers_run
        try:
            with trace.annotation("ds.train_batch"):
                if counting:
                    from deepspeed_tpu_torch.profiling.flops_profiler \
                        .profiler import count_flops
                    counted, metrics = count_flops(self._step, batch)
                else:
                    counted, metrics = None, self._step(batch)
        finally:
            if layers_run is not None:
                self.loss_fn.layers_run = None
        if self._trace is not None:
            self._trace_steps_left -= 1
            if self._trace_steps_left == 0:
                # the window closes on the step's finished work
                device_sync(self.device)
                self.last_trace = self._trace.stop()
                self._trace = None
        if profiling_now:
            device_sync(self.device)
        self._last_step_duration = time.perf_counter() - t0
        if profiling_now:
            self._run_flops_profile(batch, counted, layers_run)
        self.timers(TRAIN_BATCH_TIMER).stop()
        self.tput_timer.stop(global_step=True)
        self.global_steps += 1
        self.micro_steps += cfg.gradient_accumulation_steps
        self.global_samples += cfg.train_batch_size
        if metrics["overflow"]:
            self.skipped_steps += 1
        if self.monitor.enabled:
            self._monitor_buffer.append(
                (self.global_samples, metrics["loss"], metrics["lr"],
                 metrics["loss_scale"]))
            if (self.global_steps % cfg.steps_per_print == 0
                    or len(self._monitor_buffer) >= 64):
                self._flush_monitor_buffer()
        if self.global_steps % cfg.steps_per_print == 0:
            self._report_progress(metrics)
        return metrics

    def _step(self, batch) -> Dict[str, Any]:
        """Gradients, the overflow check, clipping and the update of one
        step over a batch on the device. The gradients are reduced by
        stage into this rank's update slices, and the loss, the norm and
        the overflow flag come from one all-reduce: an overflow on any
        rank skips the step on every rank."""
        cfg = self.config
        grads, mean_loss = self._accum_grads(batch)
        grads = self._zero.reduce_grads(grads)
        if self.fp16_enabled:
            grads = ls.unscale_grads(grads, self.scale_state)
        mean_loss, gnorm, flag = self._zero.step_metrics(
            grads, mean_loss, check_overflow=self.fp16_enabled)
        # the one host synchronisation of the step, fp16 only: the flag
        # decides whether the update is applied
        overflow = self.fp16_enabled and bool(flag)
        if cfg.gradient_clipping > 0.0:
            clip_by_global_norm(grads, cfg.gradient_clipping, norm=gnorm)
        lr = float(self.lr_schedule(self.step_count))
        if not overflow:
            sr_gen = self.rng if self.memory_efficient_bf16 else None
            slices = self._zero.update_slices(self._params)
            kw = {"shard_sums": self._zero.leaf_norm_sums()} \
                if isinstance(self.optimizer, FusedLamb) else {}
            self.optimizer.step(slices, grads, self.opt_state,
                                sr_gen=sr_gen, **kw)
            self._zero.write_back(self._params, slices)
            self.step_count += 1
        self.scale_state = ls.update(
            self.scale_state, overflow,
            dynamic=self.dynamic_loss_scale and self.fp16_enabled,
            scale_window=cfg.fp16.loss_scale_window,
            min_scale=cfg.fp16.min_loss_scale,
            max_hysteresis=cfg.fp16.hysteresis)
        self._last_grad_norm = gnorm
        return {"loss": mean_loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": self.scale_state.loss_scale,
                "overflow": overflow}

    def _flush_monitor_buffer(self):
        buffered, self._monitor_buffer = self._monitor_buffer, []
        if not buffered:
            return
        # one transfer for the whole buffer
        losses = torch.stack([loss for _, loss, _, _ in buffered]).tolist()
        events = []
        for (samples, _, lr, scale), loss in zip(buffered, losses):
            events.extend([
                ("Train/Samples/train_loss", float(loss), samples),
                ("Train/Samples/lr", float(lr), samples),
                ("Train/Samples/loss_scale", float(scale), samples),
            ])
        self.monitor.write_scalars(events)

    def _report_progress(self, metrics):
        logger.info(
            f"step={self.global_steps}, skipped={self.skipped_steps}, "
            f"lr={float(metrics['lr']):.3e}, "
            f"loss={float(metrics['loss']):.4f}, "
            f"loss_scale={float(metrics['loss_scale']):.1f}")

    # ------------------------------------------------------------------
    # the flops profiler
    # ------------------------------------------------------------------
    def set_flops_per_batch(self, flops: float) -> None:
        """The FLOPs of one batch for the profiler, overriding its own
        count (for example ``gpt.train_flops_per_token(cfg, S) *
        tokens``)."""
        self._flops_per_batch = flops

    def _flops_source(self, batch, layers_run=None):
        """(FLOPs of the batch, where the count comes from), or (None,
        ...) when the step must be counted by ``FlopCounterMode``.
        layers_run: the layers each micro step computed, as a loss with a
        ``layers_run`` attribute recorded them."""
        if self._flops_per_batch:
            return float(self._flops_per_batch), "set_flops_per_batch"
        analytic = getattr(self.loss_fn, "flops_per_batch", None)
        if analytic is not None and layers_run:
            return float(analytic(batch, layers_run)), \
                f"analytic (the loss function's flops_per_batch over the " \
                f"layers each micro step ran: {layers_run})"
        if analytic is not None:
            return float(analytic(batch)), "analytic (the loss function's " \
                "flops_per_batch; every layer counted)"
        return None, "FlopCounterMode (PyTorch operators; the port's CUDA " \
            "kernels are not seen)"

    def _run_flops_profile(self, batch, counted: Optional[float],
                           layers_run=None) -> None:
        """The profile of one step: FLOPs (the caller's, the loss
        function's analytic count, or counted while the step ran) over
        the step's measured time, against the card's peak."""
        from deepspeed_tpu_torch.telemetry.costs import device_peak_flops
        flops, source = self._flops_source(batch, layers_run)
        if flops is None:
            flops = counted
        dur = max(self._last_step_duration, 1e-9)
        achieved = flops / dur
        peak = device_peak_flops(self.device)
        lines = [
            "", "-" * 64, "DeepSpeed-TPU-torch Flops Profiler (train step)",
            "-" * 64,
            f"profile step:        {self.global_steps + 1}",
            f"params:              {self.num_parameters / 1e6:.2f} M",
            f"step flops:          {flops / 1e12:.3f} TF ({flops:.0f})",
            f"flops count:         {source}",
            f"step latency:        {dur * 1e3:.2f} ms",
            f"achieved throughput: {achieved / 1e12:.2f} TFLOPS",
            f"samples/sec:         {self.config.train_batch_size / dur:.1f}",
        ]
        if peak:
            lines.append(f"MFU:                 {achieved / peak * 100:.1f}%")
        lines.append("-" * 64)
        logger.info("\n".join(lines))
        out = self.config.flops_profiler.output_file
        if out:
            with open(out, "w") as f:
                f.write("\n".join(lines) + "\n")

    # ------------------------------------------------------------------
    # the seqlen curriculum
    # ------------------------------------------------------------------
    # keys of a dict batch whose axis 1 is the sequence: the JAX engine's,
    # and the segment ids and positions of packed rows
    CURRICULUM_SEQ_KEYS = ("tokens", "input_ids", "targets", "labels",
                           "loss_mask", "attention_mask", "position_ids",
                           "segment_ids", "positions")

    def set_curriculum_transform(self, fn) -> None:
        """Replace the seqlen truncation by ``fn(batch, difficulty) ->
        batch`` (for batches that are not dicts, or whose sequence axis is
        not axis 1)."""
        self._curriculum_transform = fn

    def _apply_curriculum(self, batch, difficulty: int):
        """Truncate the sequence axis (axis 1) of the sequence keys of a
        dict batch to ``difficulty``. A ``loss_mask`` one shorter than
        ``tokens`` in a batch without ``targets`` (``pack_documents``'s,
        aligned with the next-token targets) is cut to ``difficulty -
        1``, so that it stays aligned."""
        if self._curriculum_transform is not None:
            return self._curriculum_transform(batch, difficulty)
        if self.config.curriculum.curriculum_type != "seqlen":
            return batch
        if not isinstance(batch, dict):
            raise TypeError(
                "seqlen curriculum needs a dict batch with token keys "
                f"{self.CURRICULUM_SEQ_KEYS}; for other batch layouts "
                "call engine.set_curriculum_transform(fn)")
        tokens = batch.get("tokens")
        shifted = tokens is not None and "targets" not in batch \
            and "loss_mask" in batch \
            and batch["loss_mask"].shape[1] == tokens.shape[1] - 1

        def trunc(key, x):
            n = difficulty - 1 if key == "loss_mask" and shifted \
                else difficulty
            if getattr(x, "ndim", 0) >= 2 and x.shape[1] > n:
                return x[:, :n]
            return x

        return {k: (trunc(k, v) if k in self.CURRICULUM_SEQ_KEYS else v)
                for k, v in batch.items()}

    @torch.no_grad()
    def start_trace(self, log_dir: str, steps: int = 1) -> None:
        """Trace the next ``steps`` ``train_batch`` calls into a Chrome
        trace in ``log_dir`` (``utils/trace.py``: the host's operations
        and, on the card, its kernels), each step a ``ds.train_batch``
        range; the JAX engine's ``start_trace``. The window opens and
        closes on a device with no queued work, so it holds exactly those
        steps; ``last_trace`` is the file's path once it closes."""
        if self._trace is not None:
            raise RuntimeError("a trace window is already open "
                               f"({self._trace_steps_left} steps left)")
        device_sync(self.device)
        self._trace = trace.Capture(log_dir).start()
        self._trace_steps_left = max(1, int(steps))

    def eval_batch(self, batch):
        """``(loss, aux)`` of a batch under the current parameters, no
        update, through the loss function's ``eval_fn`` where it has one
        (a pipelined loss's forward-only GPipe, as the JAX engine's
        ``_build_eval_step`` takes it). Across ranks the batch is the
        global one, each rank runs its rows, and the loss is the global
        batch's (all-reduced; aux is this rank's)."""
        groups_lib.set_mesh(self.mesh)
        cparams = _cast_floats(self._compute_source(), self.compute_dtype)
        batch = self._to_device(batch)
        local, ctx, weight = self._rank_rows(batch)
        if ctx is not None:
            local = dict(local)
            local[mesh_lib.DP_CONTEXT_KEY] = ctx
        loss_fn = getattr(self.loss_fn, "eval_fn", None) or self.loss_fn
        out = loss_fn(cparams, local, self.rng)
        loss, aux = out if self.has_aux else (out, {})
        total = (loss.detach().to(torch.float64) * weight).reshape(1)
        comm.all_reduce(total, self._zero.grad_group)
        return total[0].to(loss.dtype), aux

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
        """The master parameters this rank keeps (updated in place by
        every step): the whole tree, or this rank's shards at ZeRO 3
        across ranks (:meth:`gather_params` gives them whole)."""
        return self._params

    def gather_params(self, dtype: Optional[torch.dtype] = None) -> Dict:
        """Every master leaf whole on this rank's device (in ``dtype``, or
        the master dtype); across ranks a collective every rank calls."""
        return self._zero.full(self._params, dtype=dtype)

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

    def zero_optimization(self):
        """Whether a ZeRO stage above 0 is configured."""
        return self.config.zero.enabled

    def get_global_grad_norm(self):
        """The last step's gradient norm before clipping (None before the
        first step)."""
        return None if self._last_grad_norm is None \
            else float(self._last_grad_norm)

    def get_lr(self):
        return [float(self.lr_schedule(self.step_count))]

    def get_loss_scale(self):
        return float(self.scale_state.loss_scale)

    def destroy(self) -> None:
        """Flush the monitor's buffered scalars and close its writers."""
        self._flush_monitor_buffer()
        self.monitor.close()

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> bool:
        """Write a crash-safe checkpoint under ``save_dir/<tag>``
        (``runtime/checkpointing.py``); ``client_state`` comes back from
        ``load_checkpoint``."""
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint
        return save_checkpoint(self, save_dir, tag=tag,
                               client_state=client_state or {},
                               save_latest=save_latest)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        strict: bool = False):
        """Restore a checkpoint; returns ``(path, client_state)`` or
        ``(None, {})``. The lr schedule is a function of the restored
        step counter, so ``load_lr_scheduler_states`` (taken for the JAX
        engine's API, which ignores it too) changes nothing."""
        del load_lr_scheduler_states
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint
        return load_checkpoint(self, load_dir, tag=tag,
                               load_optimizer_states=load_optimizer_states,
                               strict=strict)

    def consolidated_16bit_state_dict(self) -> Dict:
        """The parameters in the compute dtype, whole, on the host (across
        ranks a collective every rank calls)."""
        return tree_map(lambda t: t.detach().cpu(),
                        self.gather_params(self.compute_dtype))

    def module_state_dict(self) -> Dict:
        """The master parameter tree, whole (across ranks a collective
        every rank calls)."""
        return self.gather_params()

    def save_16bit_model(self, save_dir: str,
                         save_filename: str = "model_weights.npz") -> bool:
        """One flat compute-dtype npz in the JAX package's format
        (``runtime.checkpointing.write_16bit_model``), written by rank 0;
        read it with ``load_16bit_model`` of either package."""
        from deepspeed_tpu_torch.runtime.checkpointing import (
            write_16bit_model)
        sd = self.consolidated_16bit_state_dict()
        if self.mesh.rank == 0:
            write_16bit_model(sd, save_dir, save_filename)
        return True
