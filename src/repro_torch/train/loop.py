"""Fault-tolerant training loop: grad accumulation, checkpoint/restart,
straggler monitoring, optional int8-compressed gradient averaging.

Port of ``repro.train.loop``. The loop is deliberately boring: all failure
handling is explicit and testable (tests/test_torch_train.py kills it
mid-run and restarts it).

What differs from the reference, in PyTorch's idiom:

* ``jax.value_and_grad`` becomes ``torch.autograd.grad`` of the model's
  ``loss_fn`` at detached views of the parameters (every floating leaf; an
  unused leaf gets zeros, as JAX gives). With ``cast_params`` the views
  are copies in that dtype of the float32 leaves, and the gradients are
  taken at them, in that dtype, as the reference takes them.
* ``jax.jit`` has no counterpart: the step runs eagerly, and ``TrainLoop``
  has no ``jit`` option. Its kernels launch on the current CUDA stream.
* The step writes the new parameters and moments into the state it is
  given (``adamw_update``; ROADMAP, divergence 20) and returns it, and
  clips by handing ``global_norm_scale``'s factor to ``adamw_update``
  (no second tree of gradients; the same bits as the reference's clip).
* ``jax.random.PRNGKey`` becomes a seeded ``torch.Generator``: the model
  draws its weights from it on the generator's device.
* Data parallelism (``group``, from ``launch/train.py --distributed``)
  replaces GSPMD's batch sharding: each rank differentiates its slice of
  the global batch at replicated parameters, and the gradients are summed
  over the group, each rank's weighted by its share of what the loss
  averages over (:func:`loss_weight`: masked positions of a masked-LM
  batch, else rows), so the step is the one process's on the whole batch
  up to the order of the sums. A loss that is not such an average (the
  moe family's aux loss) is averaged per rank the same way (ROADMAP,
  divergence 21).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm_scale
from repro_torch.optim.compression import compressed_mean, init_error_state

__all__ = ["StragglerMonitor", "TrainLoop", "TrainState", "loss_weight", "make_train_step",
           "value_and_grad"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    error_fb: Any = None  # compression error-feedback state

    def tree(self):
        t = {"params": self.params, "opt": self.opt}
        if self.error_fb is not None:
            t["error_fb"] = self.error_fb
        return t

    @classmethod
    def from_tree(cls, t):
        return cls(t["params"], t["opt"], t.get("error_fb"))


def value_and_grad(loss_fn: Callable, params, batch, cast_params=None):
    """(loss, metrics, grads) of ``loss_fn(params, batch) -> (loss,
    metrics)``: gradients of every floating leaf, in the dtype it was
    differentiated at (zeros where the loss does not reach it)."""

    def view(p):
        if not p.is_floating_point():
            return p
        if cast_params is not None and p.dtype == torch.float32:
            return p.detach().to(cast_params).requires_grad_()
        return p.detach().requires_grad_()

    views = tree_map(view, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(views, batch)
    leaves = [v for v in tree_leaves(views) if v.requires_grad]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    grads = tree_map(lambda v: next(grads) if v.requires_grad else torch.zeros_like(v), views)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return loss.detach(), {k: detach(m) for k, m in metrics.items()}, grads


def loss_weight(batch) -> float:
    """What a batch's loss averages over: the masked positions of a
    masked-LM batch (``mlm_mask``), else its rows (every row the same
    positions)."""
    if "mlm_mask" in batch:
        return float(batch["mlm_mask"].sum())
    return float(batch["tokens"].shape[0])


def _share(batch, group) -> float:
    """This rank's share of the group's :func:`loss_weight` (the global
    average's denominator floored at 1, as ``softmax_xent``'s)."""
    import torch.distributed as dist

    w = loss_weight(batch)
    total = torch.tensor([w], dtype=torch.float64, device=batch["tokens"].device)
    dist.all_reduce(total, group=group)
    return w / max(float(total), 1.0)


def _all_sum(tensors, group) -> None:
    """Sum each of ``tensors`` over ``group`` in place (float32 on the
    wire for narrower floats)."""
    import torch.distributed as dist

    for t in tensors:
        if t.dtype in (torch.float16, torch.bfloat16):
            wide = t.float()
            dist.all_reduce(wide, group=group)
            t.copy_(wide)
        else:
            dist.all_reduce(t, group=group)


def make_train_step(
    loss_fn: Callable,
    *,
    accum: int = 1,
    max_norm: float = 1.0,
    peak_lr: float = 3e-4,
    warmup: int = 20,
    total: int = 10_000,
    compress: bool = False,
    cast_params=None,
    group=None,
):
    """(state, batches) -> (state, metrics). ``batches`` is a dict whose
    leaves carry a leading [accum] dim when accum > 1.

    ``cast_params=torch.bfloat16`` differentiates at a bf16 view of the
    float32 master weights, as the reference's does (there it halves the
    FSDP gathers and gradient reductions).

    ``group`` (a ``torch.distributed`` process group): ``batches`` is this
    rank's slice of the global batch; gradients, the loss and the scalar
    metrics are summed over the group, each rank's weighted by its share
    of :func:`loss_weight` (one all-reduce a leaf, or ``compressed_mean``
    over the group under ``compress``), giving every rank the whole
    batch's values."""

    def one(params, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch, cast_params)
        if group is not None:
            share = _share(batch, group)
            tree_map(lambda g: g.mul_(share), grads)
            loss = loss * share
            metrics = {k: m * share if isinstance(m, torch.Tensor) and m.dim() == 0 else m
                       for k, m in metrics.items()}
        return loss, metrics, grads

    def step(state: TrainState, batches) -> tuple[TrainState, dict]:
        params = state.params
        if accum == 1:
            loss, metrics, grads = one(params, batches)
        else:
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            l_sum = None
            for i in range(accum):
                micro = tree_map(lambda x: x[i], batches)
                loss, _, grads = one(params, micro)
                tree_map(torch.Tensor.add_, g_sum, grads)
                l_sum = loss if l_sum is None else l_sum + loss
                del grads
            grads = tree_map(lambda g: g.div_(accum), g_sum)
            loss = l_sum / accum
            metrics = {"loss": loss}

        error_fb = state.error_fb
        if group is not None:
            scalars = {k: m for k, m in metrics.items()
                       if isinstance(m, torch.Tensor) and m.dim() == 0}
            stacked = torch.stack([loss.float(), *(m.float() for m in scalars.values())])
            _all_sum([stacked], group)
            loss = stacked[0]
            metrics = {**metrics, **dict(zip(scalars, stacked[1:]))}
            metrics["loss"] = loss
        if compress:
            if error_fb is None:
                error_fb = init_error_state(grads)
            if group is not None:  # compressed_mean averages: hand it world x the share
                import torch.distributed as dist

                world = dist.get_world_size(group)
                tree_map(lambda g: g.mul_(world), grads)
            grads, error_fb = compressed_mean(grads, error_fb, group)
        elif group is not None:
            _all_sum(tree_leaves(grads), group)

        scale, gnorm = global_norm_scale(grads, max_norm)
        new_params, new_opt = adamw_update(
            params, grads, state.opt, peak_lr=peak_lr, warmup=warmup, total=total,
            grad_scale=scale,
        )
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return TrainState(new_params, new_opt, error_fb), metrics

    return step


class StragglerMonitor:
    """EWMA step-time monitor. In a multi-host deployment the flag triggers
    re-balancing / hot-spare swap; here it records and reports."""

    def __init__(self, alpha=0.2, threshold=2.0):
        self.alpha, self.threshold = alpha, threshold
        self.ewma = None
        self.flags: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flags.append((step, dt))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class TrainLoop:
    """Checkpointed, restartable loop around a train step. ``ckpt_dir``
    None (or empty) runs without checkpoints: nothing is restored or
    written. ``seconds`` holds each step's wall time (the loss is read back
    every step, so it covers the card's work). With ``group`` (data
    parallelism, ``batch_fn`` giving this rank's slice) the step reduces
    over the group and rank 0 alone writes the checkpoints, which every
    rank restores from."""

    def __init__(
        self,
        model,
        *,
        ckpt_dir: Optional[str],
        batch_fn: Callable[[int], Any],
        step_fn=None,
        save_every: int = 50,
        accum: int = 1,
        peak_lr: float = 3e-4,
        compress: bool = False,
        group=None,
    ):
        self.model = model
        self.ckpt_dir = ckpt_dir or None
        self.batch_fn = batch_fn
        self.save_every = save_every
        writes = True
        if group is not None:
            import torch.distributed as dist

            writes = dist.get_rank() == 0
        self.ckpt = AsyncCheckpointer(ckpt_dir) if self.ckpt_dir and writes else None
        self.monitor = StragglerMonitor()
        self.seconds: Dict[int, float] = {}
        self.step_fn = step_fn or make_train_step(
            model.loss_fn, accum=accum, peak_lr=peak_lr, compress=compress, group=group
        )

    def init_or_restore(self, key: torch.Generator) -> tuple[TrainState, int]:
        start = latest_step(self.ckpt_dir) if self.ckpt_dir else None
        params = self.model.init(key)
        state = TrainState(params, adamw_init(params))
        if start is not None:
            state = TrainState.from_tree(
                restore(self.ckpt_dir, start, state.tree())
            )
            return state, start
        return state, 0

    def run(self, key: torch.Generator, n_steps: int, *, fail_at: int | None = None) -> dict:
        """Runs to ``n_steps`` global steps (resuming if checkpoints exist).
        ``fail_at`` raises mid-run to simulate preemption (tests)."""
        state, start = self.init_or_restore(key)
        losses = {}
        for step in range(start, n_steps):
            if fail_at is not None and step == fail_at:
                self._wait()
                raise RuntimeError(f"simulated preemption at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            losses[step] = float(metrics["loss"])
            self.seconds[step] = time.perf_counter() - t0
            self.monitor.record(step, self.seconds[step])
            if self.ckpt and ((step + 1) % self.save_every == 0 or step + 1 == n_steps):
                self.ckpt.save_async(step + 1, state.tree())
        self._wait()
        return losses

    def _wait(self):
        if self.ckpt:
            self.ckpt.wait()
