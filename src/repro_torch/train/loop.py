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

__all__ = ["StragglerMonitor", "TrainLoop", "TrainState", "make_train_step", "value_and_grad"]


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
):
    """(state, batches) -> (state, metrics). ``batches`` is a dict whose
    leaves carry a leading [accum] dim when accum > 1.

    ``cast_params=torch.bfloat16`` differentiates at a bf16 view of the
    float32 master weights, as the reference's does (there it halves the
    FSDP gathers and gradient reductions)."""

    def step(state: TrainState, batches) -> tuple[TrainState, dict]:
        params = state.params
        if accum == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batches, cast_params)
        else:
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            l_sum = None
            for i in range(accum):
                micro = tree_map(lambda x: x[i], batches)
                loss, _, grads = value_and_grad(loss_fn, params, micro, cast_params)
                tree_map(torch.Tensor.add_, g_sum, grads)
                l_sum = loss if l_sum is None else l_sum + loss
                del grads
            grads = tree_map(lambda g: g.div_(accum), g_sum)
            loss = l_sum / accum
            metrics = {"loss": loss}

        error_fb = state.error_fb
        if compress:
            if error_fb is None:
                error_fb = init_error_state(grads)
            grads, error_fb = compressed_mean(grads, error_fb)

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
    every step, so it covers the card's work)."""

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
    ):
        self.model = model
        self.ckpt_dir = ckpt_dir or None
        self.batch_fn = batch_fn
        self.save_every = save_every
        self.ckpt = AsyncCheckpointer(ckpt_dir) if self.ckpt_dir else None
        self.monitor = StragglerMonitor()
        self.seconds: Dict[int, float] = {}
        self.step_fn = step_fn or make_train_step(
            model.loss_fn, accum=accum, peak_lr=peak_lr, compress=compress
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
