r"""Curriculum trainer (PyTorch port of ``training/trainer.py``).

The JAX trainer jits one step (forward, disorder draw, propagation,
fidelity, loss, grad, clip, Adam); here the step runs eagerly on the device
and the propagation goes through kernel B1, whose backward is B3 + B2
(``backend="pallas"``).  What carries over unchanged:

* the curriculum walks disorder bands small → large, tracks the best model
  by eval fidelity per band, reloads it before escalating, checkpoints it
  per band and exports its pulses on the train set;
* the optimizer is ``optax.chain(clip_by_global_norm(c), adam(lr))``:
  gradients are scaled by ``c/‖g‖`` only where ``‖g‖ ≥ c`` (no 1e-6 added
  to the norm, unlike ``torch.nn.utils.clip_grad_norm_``; the norm summed
  in float64 and the division applied in place, one multi-tensor pass each
  over all leaves), then Adam with ε = 1e-8; ``lr_schedule="cosine"``
  reproduces ``optax.warmup_cosine_decay_schedule`` step for step;
* ``reset_optimizer_per_band``, ``recover_collapse``, ``tail_focus`` (CVaR)
  and ``shuffle`` with the same permutation seeds;
* "epoch" means a full pass over the training set.

Randomness: one ``torch.Generator`` on the device, seeded with
``seed + 1`` at the start of :meth:`Trainer.train`, draws the disorder and
the dropout masks, so a run is reproducible from its seed (the draws
differ from JAX's).  :meth:`Trainer.objective` and
:meth:`Trainer.train_step` take explicit disorder and run the model
without dropout unless asked, as JAX's ``_objective(..., dropout_key=None)``.

``fused_epoch=True`` is the counterpart of the on-device epoch scan: no host
sync inside an epoch, losses stay on the device and are read once per
epoch.  ``False`` reads each step's loss.

The counterpart of the jitted step is one CUDA graph a step
(:meth:`Trainer.train_step`, through :class:`..ops.graphs.GraphCache`):
forward, backward, clip and Adam captured once and replayed, so the host
issues one launch where the eager step issues some two thousand.  It
engages wherever capture is safe: on a card, on one process (gloo's
all-reduce cannot be captured) and outside anomaly mode; elsewhere the
step runs eagerly, with the Adam it always had.  A graphed step's Adam is
PyTorch's fused one, ``capturable``, its learning rate a device scalar
that the host writes before each step (the schedule stays on the host).

On a ``(data, mc)`` mesh (:mod:`..parallel.mesh`) every rank runs the same
loop on the same global batches and gives the unsharded run's numbers:

* each rank draws the disorder of the whole ``(B, M)`` batch from the
  trainer's generator and keeps its block (rows over ``data``, samples over
  ``mc``), as the JAX trainer draws globally and then shards;
* each rank runs the model on its rows of the batch, with the dropout
  masks the unsharded run draws for those rows (each mask is drawn for the
  whole batch and cut to the rows: :class:`..models.universal_transformer.RowDraws`), and the
  objective on its block;
* after the backward the parameters' gradients, each that of the rank's
  block, are summed over all ranks in one all-reduce and scaled by the
  objective's ``grad_scale`` (1/(data·mc) for the batch mean, 1/mc for the
  per-target CVaR loss, each target's mean being over its mc row), so they
  are the unsharded gradient before the clip, which reads its global norm;
* the parameters are broadcast from rank 0 at the start of each band and
  after a collapse recovery; B must divide by ``data`` and M by ``mc``;
* only rank 0 writes checkpoints, resume states, pulses and metrics.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core import objectives
from ..models.universal_transformer import RowDraws
from ..ops.graphs import GraphCache
from ..parallel.mesh import DATA_AXIS, MC_AXIS, Mesh, shard_spec
from ..utils.device import resolve_device
from ..utils.tracing import span
from .checkpoint import save_checkpoint
from .metrics import MetricsLogger
from .resume import TrainState, latest_step, restore_train_state, save_train_state
from .systems import SU2System, make_objective, make_per_target_objective

__all__ = ["TrainConfig", "CurriculumBand", "Trainer", "default_curriculum",
           "learning_rate_at"]

LOSSES: Dict[str, Callable] = {
    "sharp": objectives.sharp_loss,
    "neg_log": objectives.negative_log_loss,
    "infidelity": objectives.infidelity_loss,
}

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CurriculumBand:
    """One disorder band (reference δ_std ∈ {0.4, 0.7, 1.0}, ε_std = 0.05)."""

    delta_std: float
    epsilon_std: float = 0.05


def default_curriculum() -> List[CurriculumBand]:
    return [CurriculumBand(d) for d in (0.4, 0.7, 1.0)]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``, field for field and default for default
    (``backend`` "xla" is the eager plain path, "pallas" the CUDA kernels;
    ``profile_dir`` traces with ``torch.profiler``, the program's spans
    (:mod:`..utils.tracing`) beside the kernels; ``debug_nans`` turns on
    ``torch.autograd.set_detect_anomaly``)."""

    monte_carlo: int = 1000
    batch_size: int = 200
    epochs: int = 100
    learning_rate: float = 3e-5
    lr_schedule: str = "constant"     # "constant" | "cosine"
    lr_schedule_steps: int = 0
    grad_clip: float = 1.0
    loss: str = "sharp"
    loss_tau_bar: float = 0.99
    loss_k: float = 100.0
    backend: str = "xla"              # "xla" | "pallas"
    seed: int = 0
    profile_dir: Optional[str] = None
    profile_steps: int = 3
    state_every: int = 0              # save the full resume state every N epochs
    debug_nans: bool = False
    fused_epoch: bool = True          # no host sync inside an epoch
    reset_optimizer_per_band: bool = False
    shuffle: bool = False
    recover_collapse: float = 0.0
    recover_patience: int = 3
    tail_focus: float = 0.0
    tail_weight: float = 1.0


def learning_rate_at(config: TrainConfig, step: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based), as optax's
    schedule gives it: constant, or ``warmup_cosine_decay_schedule`` from
    0.05·lr to lr over ``total // 20`` steps, then cosine to 0.1·lr at
    ``total = lr_schedule_steps``."""
    lr = config.learning_rate
    if config.lr_schedule == "constant":
        return lr
    if config.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule: {config.lr_schedule}")
    total = max(config.lr_schedule_steps, 1)
    warmup = max(total // 20, 1)
    decay_steps = total - warmup
    if not decay_steps > 0:
        raise ValueError(
            f"the cosine schedule needs lr_schedule_steps > its warmup, got "
            f"{config.lr_schedule_steps}")
    init, end = 0.05 * lr, 0.1 * lr
    if step < warmup:
        frac = 1.0 - step / warmup
        return (init - lr) * frac + lr
    count = min(step - warmup, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    alpha = end / lr
    return lr * ((1.0 - alpha) * cosine + alpha)


def _snapshot(model: torch.nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class Trainer:
    """Curriculum trainer over disorder bands.

    Args:
      model: an ``nn.Module`` mapping rotation vectors to pulses; it is
        moved to ``device``.
      config: hyperparameters.
      mesh: optional ``(data, mc)`` mesh, one rank per cell; every rank
        constructs its trainer with the same arguments.
      base_pulse: finetune base pulse forwarded to a ``finetune`` model.
      system: quantum system; defaults to :class:`SU2System` with the
        configured backend.
      device: ``None`` → CUDA (raising where there is none); ``"cpu"`` runs
        the plain versions.

    ``graphs.captures`` and ``graphs.replays`` count the steps that
    captured a CUDA graph and the steps that replayed one captured at an
    earlier step (both stay 0 where the step runs eagerly).
    """

    def __init__(self, model: torch.nn.Module, config: TrainConfig = TrainConfig(),
                 mesh: Optional[Mesh] = None,
                 base_pulse: Optional[torch.Tensor] = None,
                 system: Any = None, device=None) -> None:
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0
        if mesh is not None:
            mesh.block(config.monte_carlo, MC_AXIS)  # raises on uneven shards
        self.base_pulse = (None if base_pulse is None else
                           torch.as_tensor(base_pulse, dtype=torch.float32,
                                           device=self.device))
        self.system = system if system is not None else SU2System(config.backend)
        if not 0.0 <= config.tail_weight <= 1.0:
            raise ValueError(
                f"tail_weight must be in [0, 1], got {config.tail_weight}")
        learning_rate_at(config, 0)  # rejects an unknown schedule up front

        base_loss = LOSSES[config.loss]
        if config.loss == "sharp":
            self._loss_of_mean_fid = lambda f: base_loss(
                f, config.loss_tau_bar, config.loss_k)
        else:
            self._loss_of_mean_fid = base_loss
        self._mean_fid = make_objective(mesh, self.system.local_mean_fidelity)
        self._per_target_fid = (
            make_per_target_objective(mesh, self.system.local_mean_fidelity)
            if config.tail_focus > 0 else None)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        # a step is one CUDA graph where capture is safe: on a card, on one
        # process, outside anomaly mode
        self._graphed = self.device.type == "cuda" and mesh is None and not config.debug_nans
        self.graphs = GraphCache("trainer.graph_replay")
        self.reset_optimizer()

    # ------------------------------------------------------------------
    # Optimizer: clip by global norm, then Adam
    # ------------------------------------------------------------------

    def reset_optimizer(self) -> None:
        """Fresh Adam moments and schedule step (``optimizer.init``).  It
        drops the step graphs, which hold the old moments; loading weights
        with ``model.load_state_dict`` copies into the same parameters and
        keeps them.  A graphed step's Adam is fused and capturable, its
        learning rate a device scalar; elsewhere Adam is PyTorch's default."""
        lr = learning_rate_at(self.config, 0)
        if self._graphed:
            lr = torch.tensor(lr, dtype=torch.float32, device=self.device)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=self._graphed, fused=self._graphed or None)
        self.step_count = 0
        self.graphs.clear()

    def optimizer_state(self) -> Dict[str, Any]:
        return {"adam": self.optimizer.state_dict(), "step": self.step_count}

    def load_optimizer_state(self, state: Mapping[str, Any]) -> None:
        """Adam's moments and step counters and the schedule's step, from
        :meth:`optimizer_state`.  The groups keep this trainer's settings
        and learning rate, and the step counters move where its own Adam
        keeps them, so a state saved on the CPU resumes graphed on a card
        and one saved there resumes on the CPU or a mesh."""
        self.reset_optimizer()
        own = [{k: v for k, v in g.items() if k != "params"}
               for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["adam"])
        for group, settings in zip(self.optimizer.param_groups, own):
            group.update(settings)
        for p, st in self.optimizer.state.items():
            st["step"] = st["step"].to(p.device if self._graphed else "cpu", torch.float32)
        self.step_count = int(state["step"])

    def _clip_grads(self) -> torch.Tensor:
        """``optax.clip_by_global_norm``: ``g ← (g/‖g‖)·c`` where ``‖g‖ ≥ c``.

        Two multi-tensor passes over all leaves, whatever their number: one
        reduction for the global norm, one in-place division by
        max(1, ‖g‖/c), which leaves the gradients' bits as they are where
        ‖g‖ < c.  Returns ‖g‖ as a device scalar; nothing is read to the
        host."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        # each leaf's norm accumulated in float64: torch's f32 norm of the
        # flagship's 25 M entries is ~1e-5 off on the CPU
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float64)))
        divisor = (norm / self.config.grad_clip).clamp(min=1.0)
        # in place: a copy would be a memcpy node in a CUDA graph
        torch._foreach_div_(grads, divisor.to(grads[0].dtype))
        return norm

    def _schedule_learning_rate(self) -> None:
        """Adam's learning rate for the next step, from the schedule; into
        the device scalar that a captured step reads, where Adam has one."""
        lr = learning_rate_at(self.config, self.step_count)
        for group in self.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    @span("trainer.optimizer")
    def apply_gradients(self) -> None:
        """Clip the gradients held in ``.grad``, then one Adam step at the
        schedule's current learning rate."""
        self._clip_grads()
        self._schedule_learning_rate()
        self.optimizer.step()
        self.step_count += 1

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _apply_model(self, rv: torch.Tensor, generator=None,
                     params: Optional[StateDict] = None) -> torch.Tensor:
        kwargs: Dict[str, Any] = {"generator": generator}
        if getattr(self.model, "finetune", False):
            kwargs["base_pulse"] = self.base_pulse
        if params is not None:
            return torch.func.functional_call(self.model, params, (rv,), kwargs)
        return self.model(rv, **kwargs)

    def _pulses(self, rv: torch.Tensor, dropout: bool,
                params: Optional[StateDict] = None) -> Tuple[torch.Tensor, slice]:
        """The model's pulses for the rank's rows of the batch ``rv`` (all
        rows without a mesh) and those rows; dropout, from the trainer's
        generator, only when asked, with the whole batch's masks."""
        self.model.train(dropout)
        rows = self._rows(rv.shape[0])
        generator = None
        if dropout:
            generator = (self.generator if self.mesh is None else
                         RowDraws(self.generator, rv.shape[0], rows))
        return self._apply_model(rv[rows], generator, params), rows

    def sample_errors(self, batch: int, band: CurriculumBand):
        """The disorder of a whole ``(batch, M)`` batch (on a mesh too)."""
        return self.system.sample_errors(
            self.generator, (batch, self.config.monte_carlo), band.delta_std,
            band.epsilon_std)

    # ------------------------------------------------------------------
    # Data placement on a mesh
    # ------------------------------------------------------------------

    def _place_params(self) -> None:
        """Rank 0's parameters on every rank (once a band, not a step)."""
        if self.mesh is not None:
            self.mesh.broadcast_(list(self.model.parameters()))

    def _rows(self, n: int) -> slice:
        """The rank's rows of a batch of ``n`` targets."""
        return slice(None) if self.mesh is None else self.mesh.block(n, DATA_AXIS)

    def _place_errors(self, errors):
        if self.mesh is None:
            return errors
        block = shard_spec(self.mesh, DATA_AXIS, MC_AXIS)
        return tuple(block(e) for e in errors)

    def objective(self, rv: torch.Tensor, q_target: torch.Tensor, errors,
                  dropout: bool = False, *, params: Optional[StateDict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(loss, mean E[F])`` on explicit disorder ``errors``; dropout (from
        the trainer's generator) only when asked.  On a mesh the arguments
        are the global batch and its whole disorder; the rank computes its
        block and every rank returns the global values, whose gradient here
        is the rank's block's alone (:meth:`train_step` sums the ranks').
        ``params`` (name → tensor) stand in for the model's parameters."""
        pulses, rows = self._pulses(rv, dropout, params)
        q_target, errors = q_target[rows], self._place_errors(errors)
        if self._per_target_fid is not None:
            # CVaR: the mean loss over the worst `tail_focus` fraction of
            # targets; the losses decrease in E[F], so the top-k losses are
            # the worst-k targets
            f = self._per_target_fid(pulses, q_target, errors)
            if self.mesh is not None:
                f = self.mesh.gather(f, DATA_AXIS)
            k = max(1, round(self.config.tail_focus * f.shape[0]))
            worst = torch.topk(self._loss_of_mean_fid(f), k).values
            w = self.config.tail_weight
            loss = (torch.mean(worst) if w >= 1.0 else
                    (1.0 - w) * self._loss_of_mean_fid(torch.mean(f))
                    + w * torch.mean(worst))
            return loss, torch.mean(f)
        mean_fid = self._mean_fid(pulses, q_target, errors)
        return self._loss_of_mean_fid(mean_fid), mean_fid

    @span("trainer.step")
    def train_step(self, rv: torch.Tensor, q_target: torch.Tensor, errors,
                   dropout: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on explicit disorder; returns the step's
        ``(loss, mean E[F])`` as device tensors (no host sync).

        Where the step is graphed, its graphs are kept by the shapes and
        dtypes of the inputs and by ``dropout``: the first step with a new
        key is the eager step (the warm-up, which also creates Adam's
        state), the second captures :meth:`_graphed_step` and runs it, every
        later one replays it.  The graph draws its dropout masks from the
        trainer's generator, where the eager step would: the same bits, and
        the generator left where the eager step leaves it."""
        if not self._graphed:
            return self._eager_step(rv, q_target, errors, dropout)
        inputs = (rv, q_target, *errors)
        key = (dropout,) + tuple((tuple(t.shape), t.dtype) for t in inputs)

        def before_run() -> None:
            self.model.train(dropout)
            self._schedule_learning_rate()
            self.step_count += 1
        return self.graphs(key, inputs,
                           lambda rv, q, *e: self._eager_step(rv, q, e, dropout),
                           lambda rv, q, *e: self._graphed_step(rv, q, e, dropout),
                           before_run, (self.generator,))

    def _graphed_step(self, rv: torch.Tensor, q_target: torch.Tensor, errors,
                      dropout: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step a graph captures: forward, backward, clip and Adam at
        the learning rate in Adam's device scalar, which the host writes
        before each run (not :meth:`apply_gradients`, whose write would be
        captured)."""
        self.optimizer.zero_grad(set_to_none=True)   # the warm-up's: the graph has its own
        params = {n: p for n, p in self.model.named_parameters() if p.requires_grad}
        # the graph differentiates fresh leaves on the parameters' storage:
        # a parameter's own gradient node, kept alive by an autograd graph
        # from an earlier eager backward, would tie the capture to the
        # stream of that backward, and a capture may not wait on the
        # default stream
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss, mean_fid = self.objective(rv, q_target, errors, dropout, params=leaves)
        with span("trainer.backward", backward=True):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        # the graph's own gradients, which every replay rewrites
        for p, g in zip(params.values(), grads):
            p.grad = g
        with span("trainer.optimizer"):
            self._clip_grads()
            self.optimizer.step()
        return loss, mean_fid

    def _eager_step(self, rv: torch.Tensor, q_target: torch.Tensor, errors,
                    dropout: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        self.optimizer.zero_grad(set_to_none=True)
        loss, mean_fid = self.objective(rv, q_target, errors, dropout)
        with span("trainer.backward", backward=True):
            loss.backward()
        if self.mesh is not None:
            # each rank's gradient is its block's: their sum over the ranks,
            # scaled, is the unsharded one
            obj = self._per_target_fid if self._per_target_fid is not None else self._mean_fid
            self.mesh.all_reduce_many_(
                [p.grad for p in self.model.parameters() if p.grad is not None],
                obj.grad_scale)
        self.apply_gradients()
        return loss.detach(), mean_fid.detach()

    @torch.no_grad()
    def eval_step(self, rv: torch.Tensor, q_target: torch.Tensor,
                  band: CurriculumBand) -> torch.Tensor:
        errors = self._place_errors(self.sample_errors(rv.shape[0], band))
        pulses, rows = self._pulses(rv, dropout=False)
        return self._mean_fid(pulses, q_target[rows], errors)

    @torch.no_grad()
    def predict(self, rv: torch.Tensor) -> torch.Tensor:
        """Eval-mode pulses ``(B, L, P)``."""
        self.model.eval()
        return self._apply_model(rv)

    # ------------------------------------------------------------------
    # Orchestration
    # ------------------------------------------------------------------

    def init_params(self) -> StateDict:
        """Draw the model's weights from Flax's defaults with a generator
        seeded by ``config.seed``; returns a copy of the ``state_dict``."""
        gen = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.model.init_like_flax(gen)
        return _snapshot(self.model)

    def train(
        self,
        train_rv: torch.Tensor,
        train_q_target: torch.Tensor,
        eval_rv: torch.Tensor,
        eval_q_target: torch.Tensor,
        curriculum: Optional[List[CurriculumBand]] = None,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        save_dir: Optional[str] = None,
        logger: Optional[MetricsLogger] = None,
        epochs: Optional[int] = None,
        resume: bool = False,
    ) -> Tuple[StateDict, Dict[str, Any]]:
        """Run the full curriculum.  Returns ``(best state_dict, history)``.

        Per band: reset the best fidelity, run the epochs, track the best
        model by eval fidelity, reload it before the next band, checkpoint
        it and export its pulses.  With ``config.state_every > 0`` and a
        ``save_dir`` the full state is saved every N epochs under
        ``save_dir/state``; ``resume=True`` continues from the latest one.
        """
        with torch.autograd.set_detect_anomaly(self.config.debug_nans):
            return self._train(train_rv, train_q_target, eval_rv, eval_q_target,
                               curriculum, params, save_dir, logger, epochs, resume)

    def _train(self, train_rv, train_q_target, eval_rv, eval_q_target,
               curriculum, params, save_dir, logger, epochs, resume):
        cfg = self.config
        curriculum = curriculum or default_curriculum()
        epochs = epochs if epochs is not None else cfg.epochs
        if params is None:
            self.init_params()
        else:
            self.model.load_state_dict(params)
        self.reset_optimizer()
        if self.mesh is not None:
            for n in (min(cfg.batch_size, train_rv.shape[0]),
                      min(cfg.batch_size, eval_rv.shape[0])):
                self.mesh.block(n, DATA_AXIS)  # raises on uneven shards

        n_train = train_rv.shape[0]
        n_eval = eval_rv.shape[0]
        bs = min(cfg.batch_size, n_train)
        n_batches = n_train // bs
        eval_bs = min(cfg.batch_size, n_eval)
        n_eval_batches = n_eval // eval_bs

        self.generator.manual_seed(cfg.seed + 1)
        history: Dict[str, Any] = {"bands": []}

        start_band, start_epoch = 0, 0
        resume_best_params, resume_best_fid = None, None
        state_dir = None if save_dir is None else f"{save_dir}/state"
        if resume and state_dir is not None and latest_step(state_dir) is not None:
            st = restore_train_state(state_dir, map_location=self.device)
            self.model.load_state_dict(st.params)
            self.load_optimizer_state(st.opt_state)
            self.generator.set_state(st.generator_state)
            start_band, start_epoch = st.band_idx, st.epoch
            resume_best_params, resume_best_fid = st.best_params, st.best_fid

        profiling = cfg.profile_dir is not None and self.is_writer
        fused = cfg.fused_epoch and not profiling
        profiler = None
        steps_done = 0

        for band_idx, band in enumerate(curriculum):
            if band_idx < start_band:
                history["bands"].append({
                    "band": dataclasses.asdict(band), "eval_fid": [],
                    "train_loss": [], "best_fid": None, "skipped_resume": True})
                continue
            if cfg.reset_optimizer_per_band and band_idx > start_band:
                self.reset_optimizer()
            if band_idx == start_band and resume_best_params is not None:
                best_fid, best_params = resume_best_fid, resume_best_params
            else:
                best_fid, best_params = 0.0, _snapshot(self.model)
            band_hist = {"band": dataclasses.asdict(band), "eval_fid": [],
                         "train_loss": [], "step_loss": [], "step_fid": [],
                         "recoveries": 0}
            below_best = 0  # consecutive epochs spent in a collapsed basin
            self._place_params()

            epoch0 = start_epoch if band_idx == start_band else 0
            for epoch in range(epoch0, epochs):
                t_epoch = time.perf_counter()
                if cfg.shuffle:
                    rng = np.random.default_rng(
                        cfg.seed * 100003 + band_idx * 1009 + epoch)
                    perm = torch.from_numpy(rng.permutation(n_train)).to(train_rv.device)
                    epoch_rv, epoch_qt = train_rv[perm], train_q_target[perm]
                else:
                    epoch_rv, epoch_qt = train_rv, train_q_target

                losses, step_fids = [], []
                for b in range(n_batches):
                    rv = epoch_rv[b * bs:(b + 1) * bs]
                    qt = epoch_qt[b * bs:(b + 1) * bs]
                    if profiling and steps_done == 1:
                        # skip step 0 (kernel build, allocator warm-up)
                        profiler = _start_profiler(self.device)
                    loss, step_fid = self.train_step(rv, qt, self.sample_errors(bs, band),
                                                     dropout=True)
                    steps_done += 1
                    if profiling and steps_done == 1 + cfg.profile_steps:
                        _stop_profiler(profiler, self.device, cfg.profile_dir)
                        profiling = False
                    losses.append(loss if fused else loss.item())
                    step_fids.append(step_fid if fused else step_fid.item())

                fids = []
                for b in range(n_eval_batches):
                    f = self.eval_step(eval_rv[b * eval_bs:(b + 1) * eval_bs],
                                       eval_q_target[b * eval_bs:(b + 1) * eval_bs],
                                       band)
                    fids.append(f if fused else f.item())
                if fused:
                    # the epoch's one host read
                    stacked = torch.stack(losses)
                    vals = torch.cat([torch.stack([stacked.mean(), torch.stack(fids).mean()]),
                                      stacked, torch.stack(step_fids)]).tolist()
                    train_loss, eval_fid = vals[:2]
                    losses, step_fids = vals[2:2 + n_batches], vals[2 + n_batches:]
                else:
                    train_loss, eval_fid = float(np.mean(losses)), float(np.mean(fids))
                band_hist["train_loss"].append(train_loss)
                band_hist["eval_fid"].append(eval_fid)
                band_hist["step_loss"].extend(losses)
                band_hist["step_fid"].extend(step_fids)

                if eval_fid > best_fid:
                    best_fid = eval_fid
                    best_params = _snapshot(self.model)
                    below_best = 0
                elif (cfg.recover_collapse > 0.0
                      and eval_fid < best_fid - cfg.recover_collapse):
                    below_best += 1
                    if below_best >= cfg.recover_patience:
                        # collapsed basin: restart from the band best with
                        # fresh optimizer moments
                        self.model.load_state_dict(best_params)
                        self._place_params()
                        self.reset_optimizer()
                        band_hist["recoveries"] += 1
                        below_best = 0
                else:
                    below_best = 0

                if logger is not None and self.is_writer:
                    dt = time.perf_counter() - t_epoch
                    # sequence propagations per second: a train step
                    # propagates bs × MC sequences, an eval step eval_bs × MC
                    props = (n_batches * bs + n_eval_batches * eval_bs) * cfg.monte_carlo
                    logger.log(
                        band=band_idx, delta_std=band.delta_std,
                        epsilon_std=band.epsilon_std, epoch=epoch,
                        train_loss=train_loss, eval_fid=eval_fid,
                        best_fid=best_fid,
                        throughput_props_s=round(props / dt, 1),
                    )

                if (cfg.state_every and state_dir is not None and self.is_writer
                        and (epoch + 1) % cfg.state_every == 0):
                    save_train_state(
                        state_dir,
                        TrainState(params=_snapshot(self.model),
                                   opt_state=self.optimizer_state(),
                                   best_params=best_params,
                                   generator_state=self.generator.get_state(),
                                   band_idx=band_idx, epoch=epoch + 1,
                                   best_fid=best_fid),
                        step=band_idx * epochs + epoch + 1)

            # reload the best before escalating the disorder
            self.model.load_state_dict(best_params)
            band_hist["best_fid"] = best_fid
            history["bands"].append(band_hist)

            if save_dir is not None and self.is_writer:
                tag = (f"band{band_idx}_delta{band.delta_std:g}"
                       f"_eps{band.epsilon_std:g}")
                meta = {"band": dataclasses.asdict(band), "best_fid": best_fid}
                if hasattr(self.model, "hparams"):
                    # what an export needs to rebuild the Flax layout (n_heads)
                    meta["model"] = {"class": type(self.model).__name__,
                                     **self.model.hparams}
                save_checkpoint(save_dir, best_params, tag=tag, metadata=meta)
                # the best model's pulses on the train set, in eval mode
                pulses = [self.predict(train_rv[b * bs:(b + 1) * bs]).cpu().numpy()
                          for b in range(n_batches)]
                np.savez(f"{save_dir}/{tag}_pulses.npz",
                         pulses=np.concatenate(pulses, axis=0))

        return _snapshot(self.model), history

    def evaluate(self, params: Optional[Mapping[str, torch.Tensor]],
                 rv: torch.Tensor, q_target: torch.Tensor, delta_std: float,
                 epsilon_std: float,
                 generator: Optional[torch.Generator] = None) -> float:
        """Mean fidelity over one eval set.  ``params`` (if given) is loaded
        into the model first; ``generator`` defaults to one seeded with 0."""
        if params is not None:
            self.model.load_state_dict(params)
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        errors = self._place_errors(self.system.sample_errors(
            gen, (rv.shape[0], self.config.monte_carlo), delta_std, epsilon_std))
        with torch.no_grad():
            pulses, rows = self._pulses(rv, dropout=False)
            return float(self._mean_fid(pulses, q_target[rows], errors))


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str) -> None:
    """Stop after the traced steps finish on the device; write ``trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
