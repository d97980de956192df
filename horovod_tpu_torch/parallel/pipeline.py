"""Pipeline parallelism over a ``pp`` axis: GPipe and 1F1B.

Counterpart of ``horovod_tpu/parallel/pipeline.py``. Each rank along the
``pp`` axis holds one stage's parameters; activations hand off between
neighbouring stages with :func:`~horovod_tpu_torch.parallel.mesh.shift`,
one ``batch_isend_irecv`` a tick, and microbatches keep every stage busy
except the fill/drain bubble, ``(n - 1) / (M + n - 1)`` for GPipe and
``2 (n - 1) / (M + 2 (n - 1))`` for the lockstep 1F1B.

Where JAX's stacked ``[n_stages, ...]`` parameters are split over the pp
axis by ``shard_map``, one process here holds its own stage, the stage
parameters of :func:`pipeline_value_and_grad`'s ``vg``: a module, a
tensor, or a list or tuple of tensors.

- :func:`pipeline` runs the lockstep ticks. The hand-off is the
  differentiable ``shift``, whose backward shifts the cotangent the other
  way, so autograd through the ticks is GPipe's backward, as JAX derives
  it by AD through ``ppermute``. A rank skips its stage on a fill or drain
  tick and sends zeros: such a tick's output feeds only other such ticks.
  Every tick's hand-off still takes part in the graph (zeros tied to an
  anchor that requires a gradient), so every rank runs the backward of
  every hand-off, in one order, and the sends and receives stay matched.
- :func:`pipeline_1f1b_value_and_grad` is the hand-scheduled 1F1B: one
  forward and one backward a tick, the stage recomputed in its backward
  from a ring of ``2 (n - 1) + 1`` saved inputs. The last stage, whose
  backward microbatch is its forward one, runs its stage once a tick,
  with gradients.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from .mesh import Axis, shift


def stage_parameters(stage_params) -> List[torch.Tensor]:
    """The tensors of a stage's parameters: a module's, a tensor, or a
    list or tuple of tensors."""
    if isinstance(stage_params, torch.nn.Module):
        return list(stage_params.parameters())
    if torch.is_tensor(stage_params):
        return [stage_params]
    return [t for t in stage_params]


class _Idle(torch.autograd.Function):
    """A skipped tick's output: zeros shaped as ``buf``, tied to ``buf``
    and to ``anchor`` so that the tick's hand-off is in the graph."""

    @staticmethod
    def forward(ctx, buf, anchor):
        return torch.zeros_like(buf)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


class _Feed(torch.autograd.Function):
    """Stage 0's input: the microbatch, with the received ``buf`` (unused)
    tied in, so that the hand-off that brought it runs its backward."""

    @staticmethod
    def forward(ctx, x, buf):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def pipeline(stage_fn: Callable, stage_params, x_microbatches: torch.Tensor,
             axis: Axis) -> torch.Tensor:
    """Run microbatches ``[M, ...]`` through the pipeline (differentiable).
    ``stage_fn(stage_params, x) -> y`` keeps ``x``'s shape and dtype; only
    stage 0's ``x_microbatches`` are read. Returns ``[M, ...]`` outputs,
    valid on the last rank; elsewhere zeros tied to the rank's last tick,
    so a loss of them back-propagates through every hand-off."""
    n, idx = axis.size, axis.index
    M = x_microbatches.shape[0]
    total = M + n - 1
    grad = torch.is_grad_enabled()
    anchor = (torch.zeros((), device=x_microbatches.device,
                          requires_grad=True) if grad else None)
    buf = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(total):
        mb = t - idx
        if 0 <= mb < M:
            x_in = x_microbatches[mb]
            if idx > 0:
                x_in = buf
            elif grad and buf.requires_grad:
                x_in = _Feed.apply(x_in, buf)
            y = stage_fn(stage_params, x_in)
            if idx == n - 1:
                outs.append(y)
        else:
            y = _Idle.apply(buf, anchor) if grad else torch.zeros_like(buf)
        if t < total - 1:
            (buf,) = shift(axis, [y], 1)
    return torch.stack(outs if idx == n - 1 else [y] * M)


def _dp_average(grads: List[Optional[torch.Tensor]], loss: torch.Tensor,
                dp: Optional[Axis]):
    """The stage gradients and the loss averaged over the dp axis, one
    all-reduce of the flat concatenation (a None gradient, of a frozen
    parameter, stays None)."""
    if dp is None or dp.size == 1:
        return grads, loss
    live = [g for g in grads if g is not None]
    flat = torch.cat([g.reshape(-1).float() for g in live]
                     + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=dp.group)
    flat /= dp.size
    out, off = [], 0
    for g in grads:
        if g is None:
            out.append(None)
            continue
        out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
        off += g.numel()
    return out, flat[-1]


def _replicate(loss: torch.Tensor, axis: Axis, last: bool) -> torch.Tensor:
    """The last stage's loss on every rank of the axis."""
    loss = (loss if last else torch.zeros_like(loss)).detach().clone()
    dist.all_reduce(loss, group=axis.group)
    return loss


def pipeline_value_and_grad(stage_fn: Callable, loss_fn: Callable,
                            axis: Axis, dp_axis: Optional[Axis] = None):
    """``vg(stage_params, x_microbatches, targets) -> (loss, grads)``,
    GPipe by autograd through :func:`pipeline`. ``loss_fn(outs, targets)``
    scores the last stage's ``[M, ...]`` outputs; only the last rank's
    counts, and it is masked, not summed over pp, before the backward (a
    sum would seed one cotangent a rank). ``grads`` are this rank's stage
    gradients, in :func:`stage_parameters` order; a parameter that does
    not require a gradient (frozen by a deferred cadence) gets None.

    ``dp_axis`` is the dp x pp seam: each stage's parameters are replicas
    along it, and the gradients and the loss are averaged over it after
    the backward."""
    def vg(stage_params, x_microbatches, targets):
        params = stage_parameters(stage_params)
        last = axis.index == axis.size - 1
        kept = [p.grad for p in params]
        for p in params:
            p.grad = None
        with torch.enable_grad():
            outs = pipeline(stage_fn, stage_params, x_microbatches, axis)
            loss = loss_fn(outs, targets)
            (loss if last else loss * 0.0).backward()
        grads = [p.grad if p.grad is not None else
                 torch.zeros_like(p) if p.requires_grad else None
                 for p in params]
        for p, g in zip(params, kept):
            p.grad = g
        grads, loss = _dp_average(grads, _replicate(loss, axis, last),
                                  dp_axis)
        return loss, grads

    return vg


def pipeline_1f1b_value_and_grad(stage_fn: Callable, loss_fn: Callable,
                                 axis: Axis):
    """1F1B training: ``vg(stage_params, x_microbatches, targets) -> (loss,
    grads)``. At tick t stage r runs the forward of microbatch ``t - r``
    and the backward of microbatch ``t - 2 (n - 1) + r``, recomputing its
    stage from the saved input (at most ``2 (n - 1) + 1`` inputs live),
    for ``M + 2 (n - 1)`` ticks. ``loss_fn(y_mb, target_mb)`` scores one
    microbatch; the loss and gradients are those of the mean over the
    microbatches, None for a parameter that does not require a gradient.
    ``stage_fn`` keeps ``x``'s shape and dtype."""
    def vg(stage_params, x_microbatches, targets):
        n, idx = axis.size, axis.index
        last = idx == n - 1
        M = x_microbatches.shape[0]
        K = 2 * (n - 1) + 1
        # a frozen parameter (requires_grad off) takes no gradient: None
        params = [p for p in stage_parameters(stage_params)
                  if p.requires_grad]
        grads = [torch.zeros_like(p) for p in params]
        zeros = torch.zeros_like(x_microbatches[0])
        fwd_buf, bwd_buf = zeros, zeros
        ring: List[Optional[torch.Tensor]] = [None] * K
        lacc = torch.zeros((), dtype=torch.float32,
                           device=x_microbatches.device)
        for t in range(M + 2 * (n - 1)):
            mb_f = t - idx
            y = zeros
            if 0 <= mb_f < M:
                x_in = x_microbatches[mb_f] if idx == 0 else fwd_buf
                ring[mb_f % K] = x_in
                if not last:  # the last stage's forward runs below
                    with torch.no_grad():
                        y = stage_fn(stage_params, x_in)
            mb_b = t - 2 * (n - 1) + idx
            dx = zeros
            if 0 <= mb_b < M:
                x_saved = ring[mb_b % K].detach().requires_grad_(idx > 0)
                wrt = params + ([x_saved] if idx > 0 else [])
                with torch.enable_grad():
                    y2 = stage_fn(stage_params, x_saved)
                    if last:
                        lval = loss_fn(y2, targets[mb_b]) / M
                        lacc += lval.detach().float()
                        d = torch.autograd.grad(lval, wrt, allow_unused=True)
                    else:
                        d = torch.autograd.grad(y2, wrt, bwd_buf,
                                                allow_unused=True)
                for g, dp in zip(grads, d):
                    if dp is not None:
                        g += dp
                if idx > 0:
                    dx = d[-1]
            (fwd_buf,) = shift(axis, [y], 1)
            (bwd_buf,) = shift(axis, [dx], -1)
        live = iter(grads)
        return _replicate(lacc, axis, last), [
            next(live) if p.requires_grad else None
            for p in stage_parameters(stage_params)]

    return vg
