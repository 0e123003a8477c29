"""Fine-tuning on one GPU (port of ``tone_tpu/training/train.py``).

The reference's recipe: AdamW, a linear warmup over 5 % of the steps and a
linear decay to zero, lr 5e-5, bf16 compute with float32 parameters and
optimizer state, gradients clipped to a global norm of 1, CTC loss, greedy
WER for evaluation, and checkpoint/resume of the whole train state.

The optimizer is the port's own code with optax's arithmetic, which the JAX
package uses (``make_optimizer``):

* the schedule is evaluated at the optimizer's count before it increments,
  so the first update has lr 0;
* ``clip_by_global_norm``: ``g`` if ``‖g‖ < max`` else ``g / ‖g‖ · max``;
* AdamW: β = (0.9, 0.999), ε added to √v̂, weight decay ``wd · p`` added
  to the Adam direction before the lr scales it;
* ``grad_accum_steps = k > 1`` is ``optax.MultiSteps``: the running mean of
  k micro-batch gradients, then one clipped AdamW update; the other calls
  update nothing, and ``TrainState.step`` counts every call.

Dropout masks are pure functions of the step's seed, the layer and the site
(``core.encoder.layer_generators``), so a rematerialized forward draws the
same masks.  ``save``/``restore`` use ``torch.save``'s format (the JAX
package writes orbax checkpoints).  One device only: the data-parallel mesh
is ROADMAP A14.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from itertools import groupby
from pathlib import Path
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.utils.checkpoint as ckpt

from tone_tpu_torch.bridge import tree_leaves, tree_map
from tone_tpu_torch.config import LABELS, ToneConfig
from tone_tpu_torch.core.layers import mix_seed
from tone_tpu_torch.core.model import apply_offline
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.training.ctc import ctc_loss
from tone_tpu_torch.training.wer import word_error_rate

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
REMAT_POLICIES = (None, "dots", "full")
STATE_FILE = "train_state.pt"


@dataclass(frozen=True)
class TrainerConfig:
    """Hyperparameters (defaults = the reference fine-tune recipe)."""

    learning_rate: float = 5e-5
    warmup_ratio: float = 0.05
    total_steps: int = 1000
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    # >1 averages gradients over that many train_step calls before one
    # optimizer update (HF Trainer's gradient_accumulation_steps).
    grad_accum_steps: int = 1
    # Recomputation of the forward during the backward: None keeps every
    # activation, "dots" keeps only the outputs of the 2-D matrix products
    # (the counterpart of jax.checkpoint's dots_with_no_batch_dims policy),
    # "full" keeps nothing.
    remat: str | None = None
    # Chunk-blocked offline attention (layers.mhsa_blocked) instead of
    # masked (T, T) products.
    blocked_attention: bool = True
    seed: int = 0


@dataclass
class AdamState:
    """AdamW's state: the update count (the schedule's count too) and the
    moments, trees that mirror the parameters."""

    count: int
    mu: Any
    nu: Any


@dataclass
class MultiStepsState:
    """Gradient accumulation's state (``optax.MultiStepsState``)."""

    mini_step: int
    gradient_step: int
    inner_opt_state: AdamState
    acc_grads: Any


@dataclass
class TrainState:
    step: int
    params: Any
    batch_stats: Any
    opt_state: AdamState | MultiStepsState
    rng: int  # the dropout seed; split at every step


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule in float32: ``init`` to ``end`` over ``steps``,
    then held; constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count: int) -> np.float32:
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    return schedule


def make_lr_schedule(cfg: TrainerConfig) -> Callable[[int], np.float32]:
    """Linear warmup then linear decay to zero (HF Trainer 'linear')."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    rise = _linear_schedule(0.0, cfg.learning_rate, warmup)
    fall = _linear_schedule(cfg.learning_rate, 0.0, cfg.total_steps - warmup)
    return lambda count: rise(count) if count < warmup else fall(count - warmup)


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def clip_by_global_norm(g: list, max_norm: float) -> list:
    """New tensors: ``g`` if its global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (optax's formula; no epsilon), chosen on the
    device without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    g = torch._foreach_div(g, torch.where(keep, one, norm))
    torch._foreach_mul_(g, torch.where(keep, one, one * max_norm))
    return g


class Optimizer:
    """Global-norm clipping and AdamW on the schedule, with optional
    gradient accumulation: ``make_optimizer``'s transformation.  Works on
    trees of float32 tensors with multi-tensor (``torch._foreach_*``) ops."""

    def __init__(self, cfg: TrainerConfig) -> None:
        self.config = cfg
        self.schedule = make_lr_schedule(cfg)

    def init(self, params) -> AdamState | MultiStepsState:
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                       requires_grad=False), params)

        adam = AdamState(count=0, mu=zeros(), nu=zeros())
        if self.config.grad_accum_steps > 1:
            return MultiStepsState(mini_step=0, gradient_step=0, inner_opt_state=adam,
                                   acc_grads=zeros())
        return adam

    @torch.no_grad()
    def update(self, grads, state: AdamState | MultiStepsState, params,
               ) -> tuple[Any | None, AdamState | MultiStepsState]:
        """The updates to add to ``params`` (None when this call only
        accumulates) and the state.  The state's tensors are updated in
        place."""
        g, p = tree_leaves(grads), tree_leaves(params)
        if isinstance(state, AdamState):
            return _unflatten(grads, self._adamw(g, state, p)), state
        acc = tree_leaves(state.acc_grads)
        delta = torch._foreach_sub(g, acc)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        torch._foreach_add_(acc, delta)
        emit = state.mini_step == self.config.grad_accum_steps - 1
        state.mini_step = (state.mini_step + 1) % self.config.grad_accum_steps
        if not emit:
            return None, state
        updates = self._adamw(acc, state.inner_opt_state, p)
        torch._foreach_zero_(acc)
        state.gradient_step += 1
        return _unflatten(grads, updates), state

    def _adamw(self, g: list, state: AdamState, p: list) -> list:
        """Clip ``g`` to the global norm, then one AdamW step: the updates."""
        g = clip_by_global_norm(g, self.config.max_grad_norm)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - ADAM_B1))
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(g, 1 - ADAM_B2)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, g)
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = np.float32(1) - np.float32(ADAM_B1) ** np.float32(state.count)
        bc2 = np.float32(1) - np.float32(ADAM_B2) ** np.float32(state.count)
        denom = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu, float(bc1))
        torch._foreach_div_(updates, denom)
        if self.config.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(p, self.config.weight_decay))
        torch._foreach_mul_(updates, -float(lr))
        return updates


def make_optimizer(cfg: TrainerConfig) -> Optimizer:
    return Optimizer(cfg)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of 2-D matrix products (the linear layers), recompute
    everything else."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class Trainer:
    """Fine-tuning steps of the acoustic model on one device."""

    def __init__(self, model_config: ToneConfig, trainer_config: TrainerConfig | None = None,
                 mesh=None, device: str | torch.device | None = None) -> None:
        """``device``: ``cuda`` unless the caller asks for the CPU."""
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the multi-GPU data-parallel mesh "
                "(tone_tpu/parallel/mesh.py) is not ported yet (ROADMAP A14)")
        self.model_config = model_config
        self.config = trainer_config or TrainerConfig()
        if self.config.remat not in REMAT_POLICIES:
            raise ValueError(f"remat {self.config.remat!r} is not one of {REMAT_POLICIES}")
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(self.config)

    # -- state -------------------------------------------------------------

    def create_state(self, variables: dict[str, Any]) -> TrainState:
        """A fresh train state from ``{"params", "batch_stats"}`` (copied to
        float32 tensors on the trainer's device; the parameters require
        grad)."""
        params = tree_map(self._param, variables["params"])
        return TrainState(step=0, params=params,
                          batch_stats=tree_map(self._tensor, variables["batch_stats"]),
                          opt_state=self.optimizer.init(params), rng=self.config.seed)

    def _tensor(self, t) -> torch.Tensor:
        return torch.as_tensor(t).detach().to(self.device, torch.float32).clone()

    def _param(self, t) -> torch.Tensor:
        return self._tensor(t).requires_grad_(True)

    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return tuple(torch.as_tensor(np.asarray(batch[k])).to(self.device)
                     for k in ("input_values", "input_lengths", "labels"))

    # -- steps -------------------------------------------------------------

    def _forward(self, params, batch_stats, seed: int, audio, lengths):
        return apply_offline({"params": params, "batch_stats": batch_stats},
                             self.model_config, audio, lengths, rng=seed, training=True,
                             blocked_attention=self.config.blocked_attention)

    def compute_gradients(self, state: TrainState, batch: dict, seed: int | None = None,
                          ) -> tuple[torch.Tensor, Any, Any]:
        """The loss, the gradient tree and the updated BatchNorm statistics
        of ``batch`` at ``state`` (nothing is updated).  ``seed`` is the
        dropout seed, by default the one ``train_step`` would use next."""
        if seed is None:
            seed = mix_seed(state.rng, 1)
        audio, lengths, labels = self._batch(batch)
        forward = functools.partial(self._forward, state.params, state.batch_stats, seed)
        with torch.enable_grad():
            if self.config.remat is None:
                logprobs, out_lens, new_stats = forward(audio, lengths)
            else:
                context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _dots_policy)
                           if self.config.remat == "dots" else ckpt.noop_context_fn)
                logprobs, out_lens, new_stats = ckpt.checkpoint(
                    forward, audio, lengths, use_reentrant=False, context_fn=context)
            loss = ctc_loss(logprobs, out_lens, labels, blank_id=self.model_config.blank_id)
            leaves = tree_leaves(state.params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return loss.detach(), _unflatten(state.params, grads), new_stats

    def train_step(self, state: TrainState, batch: dict[str, np.ndarray],
                   ) -> tuple[TrainState, torch.Tensor]:
        """One optimization step (one micro-step under accumulation).
        ``state`` is consumed: its tensors are updated in place, as the JAX
        trainer donates its state."""
        rng, seed = mix_seed(state.rng, 0), mix_seed(state.rng, 1)
        loss, grads, new_stats = self.compute_gradients(state, batch, seed)
        updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        if updates is not None:
            with torch.no_grad():
                torch._foreach_add_(tree_leaves(state.params), tree_leaves(updates))
        return TrainState(step=state.step + 1, params=state.params, batch_stats=new_stats,
                          opt_state=opt_state, rng=rng), loss

    # -- evaluation --------------------------------------------------------

    @torch.no_grad()
    def eval_wer(self, state: TrainState, batches: Iterable[dict],
                 references: list[str]) -> float:
        """Greedy-decode ``batches`` and compute the corpus WER against
        ``references``."""
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        hyps: list[str] = []
        for batch in batches:
            audio, lengths, _ = self._batch(batch)
            logprobs, out_lens, _ = apply_offline(variables, self.model_config, audio, lengths)
            tokens = logprobs.argmax(-1).cpu().numpy()
            for row, n in zip(tokens, out_lens.cpu().tolist()):
                collapsed = (t for t, _ in groupby(row[:n].tolist()))
                hyps.append("".join(LABELS[t] for t in collapsed if t < len(LABELS)).strip())
        return word_error_rate(hyps, references)

    # -- checkpoint/resume -------------------------------------------------

    def save(self, path, state: TrainState) -> None:
        """Write the whole train state under the directory ``path``."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)

        def host(tree):
            return tree_map(lambda t: t.detach().cpu(), tree)

        opt = state.opt_state
        adam = opt.inner_opt_state if isinstance(opt, MultiStepsState) else opt
        record = {"step": state.step, "rng": state.rng, "params": host(state.params),
                  "batch_stats": host(state.batch_stats),
                  "adam": {"count": adam.count, "mu": host(adam.mu), "nu": host(adam.nu)}}
        if isinstance(opt, MultiStepsState):
            record["accumulation"] = {"mini_step": opt.mini_step,
                                      "gradient_step": opt.gradient_step,
                                      "acc_grads": host(opt.acc_grads)}
        torch.save(record, path / STATE_FILE)

    def restore(self, path, template: TrainState | None = None) -> TrainState:
        """The train state written by ``save``, on the trainer's device.  With
        ``template``, the parameters must have its structure and shapes."""
        record = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
        if template is not None:
            def shapes(tree):
                return tree_map(lambda t: tuple(t.shape), tree)

            if shapes(record["params"]) != shapes(template.params):
                raise ValueError(f"{path}: the saved parameters do not match the template")
        if ("accumulation" in record) != (self.config.grad_accum_steps > 1):
            raise ValueError(f"{path}: saved with other grad_accum_steps than "
                             f"{self.config.grad_accum_steps}")
        adam = AdamState(count=record["adam"]["count"],
                         mu=tree_map(self._tensor, record["adam"]["mu"]),
                         nu=tree_map(self._tensor, record["adam"]["nu"]))
        opt: AdamState | MultiStepsState = adam
        if "accumulation" in record:
            acc = record["accumulation"]
            opt = MultiStepsState(mini_step=acc["mini_step"],
                                  gradient_step=acc["gradient_step"], inner_opt_state=adam,
                                  acc_grads=tree_map(self._tensor, acc["acc_grads"]))
        return TrainState(step=record["step"], params=tree_map(self._param, record["params"]),
                          batch_stats=tree_map(self._tensor, record["batch_stats"]),
                          opt_state=opt, rng=record["rng"])
