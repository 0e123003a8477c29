"""Fine-tuning on one GPU or on a mesh of ranks (port of
``tone_tpu/training/train.py``).

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
package writes orbax checkpoints).

On a mesh (``Trainer(mesh=ProcessMesh(n_data, n_model))``, one process per
mesh position, ``parallel/``) every rank is given the global batch and
takes its data position's rows (the batch must split evenly); it holds its
model position's shards of the parameters and of the Adam moments
(``parallel.mesh.param_spec``: Megatron column and row splits of the
feed-forwards and the attention heads).  Inside the forward the
BatchNorms use the global batch statistics and each dropout mask is cut
from the one-device mask.  The gradients, and the loss, are averaged over
the data ranks before clipping: the CTC loss is a batch mean of equal
shards, so the average is the one-device gradient.  The gradients of the
replicated leaves are also averaged over the model ranks, which all
compute them in full, so that the card's non-repeatable backward cannot
let the replicas drift apart.  The global-norm clip
sums the squares of the split leaves over the model ranks and counts each
replicated leaf once.  AdamW acts elementwise on the shards.  ``save``
writes the full, unsharded state (rank 0 writes), so that a checkpoint of
any mesh restores on one device, and ``restore`` shards it again.
``eval_wer`` splits the rows over the data ranks and gathers the tokens.

Traced (``profiling``), a step records the spans ``train.batch`` (the
batch's conversion and upload), ``train.forward``, ``train.loss``,
``train.backward`` (the gradients, averaged over the ranks on a mesh) and
``train.optimizer`` (clip, AdamW, the parameters' update), with the
state's step as their id, and the counts ``train.audio_samples`` (this
rank's unpadded samples) and ``train.padded_samples`` (its rows times the
padded length), read from the batch's host arrays (not counted where the
caller staged the lengths on the device).
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

from tone_tpu_torch import profiling
from tone_tpu_torch.bridge import tree_leaves, tree_map
from tone_tpu_torch.config import LABELS, ToneConfig
from tone_tpu_torch.core.layers import mix_seed
from tone_tpu_torch.core.model import apply_offline
from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.parallel.collectives import ProcessMesh, shard_along
from tone_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, param_shardings, param_specs
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


def clip_by_global_norm(g: list, max_norm: float, split: list[bool] | None = None,
                        mesh: ProcessMesh | None = None) -> list:
    """New tensors: ``g`` if its global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (optax's formula; no epsilon), chosen on the
    device without a host sync.

    Under tensor parallelism, ``split[i]`` says ``g[i]`` is this rank's
    shard of a leaf split over the model ranks of ``mesh``: the squares of
    the split leaves are summed over the model ranks, and each replicated
    leaf, which every model rank holds whole, counts once."""
    norms = torch._foreach_norm(g)
    if split is not None and any(split):
        squares = torch.stack(norms).square()
        is_split = torch.tensor(split, device=squares.device)
        norm = (squares[~is_split].sum()
                + mesh.sum_over_model(squares[is_split].sum())).sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    keep = norm < max_norm
    one = torch.ones((), device=norm.device)
    g = torch._foreach_div(g, torch.where(keep, one, norm))
    torch._foreach_mul_(g, torch.where(keep, one, one * max_norm))
    return g


class Optimizer:
    """Global-norm clipping and AdamW on the schedule, with optional
    gradient accumulation: ``make_optimizer``'s transformation.  Works on
    trees of float32 tensors with multi-tensor (``torch._foreach_*``) ops.
    On a ``mesh`` with model ranks the trees hold this rank's shards, and the
    clip's norm is the global one (``clip_by_global_norm``)."""

    def __init__(self, cfg: TrainerConfig, mesh: ProcessMesh | None = None) -> None:
        self.config = cfg
        self.schedule = make_lr_schedule(cfg)
        self.mesh = mesh

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
        split = None
        if self.mesh is not None and self.mesh.n_model > 1:
            split = [MODEL_AXIS in spec for spec in param_specs(params)]
        if isinstance(state, AdamState):
            return _unflatten(grads, self._adamw(g, state, p, split)), state
        acc = tree_leaves(state.acc_grads)
        delta = torch._foreach_sub(g, acc)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        torch._foreach_add_(acc, delta)
        emit = state.mini_step == self.config.grad_accum_steps - 1
        state.mini_step = (state.mini_step + 1) % self.config.grad_accum_steps
        if not emit:
            return None, state
        updates = self._adamw(acc, state.inner_opt_state, p, split)
        torch._foreach_zero_(acc)
        state.gradient_step += 1
        return _unflatten(grads, updates), state

    def _adamw(self, g: list, state: AdamState, p: list, split: list[bool] | None) -> list:
        """Clip ``g`` to the global norm, then one AdamW step: the updates."""
        g = clip_by_global_norm(g, self.config.max_grad_norm, split, self.mesh)
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


def make_optimizer(cfg: TrainerConfig, mesh: ProcessMesh | None = None) -> Optimizer:
    return Optimizer(cfg, mesh)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of 2-D matrix products (the linear layers), recompute
    everything else."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class Trainer:
    """Fine-tuning steps of the acoustic model on one device, or on this
    rank's device of a training mesh."""

    def __init__(self, model_config: ToneConfig, trainer_config: TrainerConfig | None = None,
                 mesh: ProcessMesh | None = None,
                 device: str | torch.device | None = None) -> None:
        """``mesh``: this rank's ``parallel.collectives.ProcessMesh``, or None
        for one device.  ``device``: ``cuda`` unless the caller asks for the
        CPU."""
        if mesh is not None and not isinstance(mesh, ProcessMesh):
            raise TypeError(f"Trainer(mesh=...) takes a parallel.collectives.ProcessMesh "
                            f"(one process per mesh position), not {type(mesh).__name__}")
        if mesh is not None and model_config.encoder.n_heads % mesh.n_model:
            raise ValueError(f"{model_config.encoder.n_heads} heads do not split over "
                             f"{mesh.n_model} model ranks")
        self.model_config = model_config
        self.config = trainer_config or TrainerConfig()
        if self.config.remat not in REMAT_POLICIES:
            raise ValueError(f"remat {self.config.remat!r} is not one of {REMAT_POLICIES}")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(self.config, mesh)

    # -- state -------------------------------------------------------------

    def create_state(self, variables: dict[str, Any]) -> TrainState:
        """A fresh train state from ``{"params", "batch_stats"}`` (copied to
        float32 tensors on the trainer's device, this rank's shards on a
        mesh; the parameters require grad)."""
        params = tree_map(self._param, self._shard(variables["params"], variables["params"]))
        return TrainState(step=0, params=params,
                          batch_stats=tree_map(self._tensor, variables["batch_stats"]),
                          opt_state=self.optimizer.init(params), rng=self.config.seed)

    def _tensor(self, t) -> torch.Tensor:
        return torch.as_tensor(t).detach().to(self.device, torch.float32).clone()

    def _param(self, t) -> torch.Tensor:
        return self._tensor(t).requires_grad_(True)

    def _shard(self, tree, params):
        """This rank's model shards of ``tree``, a tree that mirrors the full
        ``params`` (the tree itself without a mesh)."""
        if self.mesh is None:
            return tree
        specs = [s.spec for s in tree_leaves(param_shardings(self.mesh, params))]
        return _unflatten(tree, [shard_along(torch.as_tensor(t), spec, self.mesh)
                                 for t, spec in zip(tree_leaves(tree), specs)])

    def _full(self, trees: list, params) -> list:
        """The full trees of this rank's shards ``trees`` (each mirrors
        ``params``), gathered over the model ranks in one all-reduce."""
        leaves = [[t.detach() for t in tree_leaves(tree)] for tree in trees]
        if self.mesh is None or self.mesh.n_model == 1:
            return [_unflatten(tree, ls) for tree, ls in zip(trees, leaves)]
        specs = param_specs(params)
        where = [(k, i) for k in range(len(trees)) for i, spec in enumerate(specs)
                 if MODEL_AXIS in spec]
        fulls = self.mesh.gather_model_split([leaves[k][i] for k, i in where],
                                             [specs[i] for _, i in where])
        for (k, i), full in zip(where, fulls):
            leaves[k][i] = full
        return [_unflatten(tree, ls) for tree, ls in zip(trees, leaves)]

    def _rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n`` rows."""
        if self.mesh is None:
            return slice(0, n)
        if n % self.mesh.n_data:
            raise ValueError(f"a batch of {n} rows must be a multiple of the mesh "
                             f"'{DATA_AXIS}' axis size ({self.mesh.n_data})")
        per = n // self.mesh.n_data
        return slice(self.mesh.data_rank * per, (self.mesh.data_rank + 1) * per)

    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # tensors may already be staged on the device
        arrays = [batch[k] if isinstance(batch[k], torch.Tensor)
                  else torch.as_tensor(np.asarray(batch[k]))
                  for k in ("input_values", "input_lengths", "labels")]
        rows = self._rows(arrays[0].shape[0])
        if profiling.recording() and arrays[1].device.type == "cpu":
            profiling.count("train.audio_samples", int(arrays[1][rows].sum()))
            profiling.count("train.padded_samples", arrays[0][rows].numel())
        return tuple(a[rows].to(self.device) for a in arrays)

    # -- steps -------------------------------------------------------------

    def _forward(self, params, batch_stats, seed: int, audio, lengths):
        return apply_offline({"params": params, "batch_stats": batch_stats},
                             self.model_config, audio, lengths, rng=seed, training=True,
                             mesh=self.mesh)

    def compute_gradients(self, state: TrainState, batch: dict, seed: int | None = None,
                          ) -> tuple[torch.Tensor, Any, Any]:
        """The loss, the gradient tree and the updated BatchNorm statistics
        of ``batch`` at ``state`` (nothing is updated).  ``seed`` is the
        dropout seed, by default the one ``train_step`` would use next.  On a
        mesh, the loss and gradients are averaged over the data ranks."""
        if seed is None:
            seed = mix_seed(state.rng, 1)
        with profiling.span("train.batch", state.step):
            audio, lengths, labels = self._batch(batch)
        forward = functools.partial(self._forward, state.params, state.batch_stats, seed)
        with torch.enable_grad():
            with profiling.span("train.forward", state.step):
                if self.config.remat is None:
                    logprobs, out_lens, new_stats = forward(audio, lengths)
                else:
                    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 _dots_policy)
                               if self.config.remat == "dots" else ckpt.noop_context_fn)
                    logprobs, out_lens, new_stats = ckpt.checkpoint(
                        forward, audio, lengths, use_reentrant=False, context_fn=context)
            with profiling.span("train.loss", state.step):
                loss = ctc_loss(logprobs, out_lens, labels, blank_id=self.model_config.blank_id)
        with profiling.span("train.backward", state.step):
            leaves = tree_leaves(state.params)
            with torch.enable_grad():
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
            loss = loss.detach()
            if self.mesh is not None:
                loss, *grads = self.mesh.average_over_data([loss, *grads])
                if self.mesh.n_model > 1:
                    # Every model rank computes the replicated leaves'
                    # gradients in full, but the card's backward is not
                    # bit-repeatable: their average keeps the replicas equal.
                    rep = [i for i, spec in enumerate(param_specs(state.params))
                           if MODEL_AXIS not in spec]
                    for i, g in zip(rep, self.mesh.average_over_model([grads[i] for i in rep])):
                        grads[i] = g
        return loss, _unflatten(state.params, grads), new_stats

    def train_step(self, state: TrainState, batch: dict[str, np.ndarray],
                   ) -> tuple[TrainState, torch.Tensor]:
        """One optimization step (one micro-step under accumulation).
        ``state`` is consumed: its tensors are updated in place, as the JAX
        trainer donates its state."""
        rng, seed = mix_seed(state.rng, 0), mix_seed(state.rng, 1)
        loss, grads, new_stats = self.compute_gradients(state, batch, seed)
        with profiling.span("train.optimizer", state.step):
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
        ``references`` (on a mesh: the data ranks split each batch, its
        last row repeated to an even split, and gather the tokens)."""
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        hyps: list[str] = []
        for batch in batches:
            audio, lengths = (torch.as_tensor(np.asarray(batch[k]))
                              for k in ("input_values", "input_lengths"))
            n = audio.shape[0]
            if self.mesh is not None:
                pad = -n % self.mesh.n_data
                audio = torch.cat([audio, audio[-1:].expand(pad, -1)])
                lengths = torch.cat([lengths, lengths[-1:].expand(pad)])
            rows = self._rows(audio.shape[0])
            logprobs, out_lens, _ = apply_offline(variables, self.model_config,
                                                  audio[rows].to(self.device),
                                                  lengths[rows].to(self.device),
                                                  mesh=self.mesh)
            tokens = torch.cat([logprobs.argmax(-1), out_lens[:, None]], dim=1)
            if self.mesh is not None:
                # The rows of every data rank, through a sum of zeros.
                full = tokens.new_zeros((audio.shape[0], tokens.shape[1]))
                full[rows] = tokens
                tokens = self.mesh.all_reduce(full, self.mesh.data_group)[:n]
            for *row, length in tokens.cpu().tolist():
                collapsed = (t for t, _ in groupby(row[:length]))
                hyps.append("".join(LABELS[t] for t in collapsed if t < len(LABELS)).strip())
        return word_error_rate(hyps, references)

    # -- checkpoint/resume -------------------------------------------------

    def save(self, path, state: TrainState) -> None:
        """Write the whole train state under the directory ``path``: on a
        mesh every rank calls it, the full state is gathered and rank 0
        writes it."""
        path = Path(path)

        def host(tree):
            return tree_map(lambda t: t.detach().cpu(), tree)

        opt = state.opt_state
        adam = opt.inner_opt_state if isinstance(opt, MultiStepsState) else opt
        accumulating = isinstance(opt, MultiStepsState)
        trees = [state.params, adam.mu, adam.nu] + ([opt.acc_grads] if accumulating else [])
        params, mu, nu, *acc = self._full(trees, state.params)
        record = {"step": state.step, "rng": state.rng, "params": host(params),
                  "batch_stats": host(state.batch_stats),
                  "adam": {"count": adam.count, "mu": host(mu), "nu": host(nu)}}
        if accumulating:
            record["accumulation"] = {"mini_step": opt.mini_step,
                                      "gradient_step": opt.gradient_step,
                                      "acc_grads": host(acc[0])}
        if self.mesh is None or self.mesh.rank == 0:
            path.mkdir(parents=True, exist_ok=True)
            torch.save(record, path / STATE_FILE)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, path, template: TrainState | None = None) -> TrainState:
        """The train state written by ``save``, on the trainer's device (this
        rank's shards on a mesh).  With ``template``, the parameters must
        have its structure and shapes."""
        record = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
        full = record["params"]
        record["params"] = self._shard(full, full)
        record["adam"]["mu"] = self._shard(record["adam"]["mu"], full)
        record["adam"]["nu"] = self._shard(record["adam"]["nu"], full)
        if "accumulation" in record:
            acc = record["accumulation"]
            acc["acc_grads"] = self._shard(acc["acc_grads"], full)
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
