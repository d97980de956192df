"""Optimizer levers for MoE expert banks.

Counterpart of ``horovod_tpu/optimizer/moe_opt.py``. An 8-expert top-2 MoE
carries a bank of expert weights whose AdamW pass reads the gradient,
parameter and both moments and writes three of them every step, for weights
that are mostly idle. The levers, each applied to the expert bank alone so
the dense parameters keep exact AdamW:

- :func:`adamw_low_precision`: m and/or v stored in bf16, computed in f32,
  with stochastic rounding on the store (:func:`_stochastic_round`);
- ``"factored"``: optax's Adafactor (:func:`adafactor`) for the bank;
- :func:`every_k`: the bank's update applied every k-th step, scaled by k;
- :func:`deferred_pair`: the same cadence as two step programs, the skip
  step computing no gradient for the bank at all
  (``train.make_gspmd_deferred_train_step``).

optax composes transforms over a pytree; torch binds an optimizer to its
parameters. So a transform here is a parameter-group template, a dict of
options (``{"rule": "adamw", "lr": ..., ...}``), and :func:`partition`
routes parameters to templates by name, as parameter groups
(:func:`param_groups`). :class:`MoEOptimizer` is the one
``torch.optim.Optimizer`` that runs every rule, group by group; it keeps
each option in its groups, so ``DistributedOptimizer`` can rebuild it from
``param_groups`` alone. :func:`optimizer_for` builds it from a transform.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.adamw import adamw as _torch_adamw


# ------------------------------------------------------------ the transforms

def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Dict:
    """Exact AdamW, ``optax.adamw``'s arithmetic: ``p -= lr (m_hat /
    (sqrt(v_hat) + eps) + weight_decay p)``, the moments in the
    parameters' dtype."""
    _constant(learning_rate, "adamw")
    return {"rule": "adamw", "lr": float(learning_rate), "b1": b1, "b2": b2,
            "eps": eps, "weight_decay": weight_decay, "mu_dtype": None,
            "nu_dtype": None, "stochastic_rounding": False, "seed": 0}


def adamw_low_precision(learning_rate: float, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 1e-4,
                        mu_dtype: Optional[torch.dtype] = None,
                        nu_dtype: Optional[torch.dtype] = None,
                        stochastic_rounding: bool = True,
                        seed: int = 0) -> Dict:
    """AdamW with the moments STORED in ``mu_dtype`` / ``nu_dtype`` (e.g.
    ``torch.bfloat16``) and computed in f32 (:func:`scale_by_adam_low_
    precision`). The noise of the stochastic rounding comes from a
    ``torch.Generator`` seeded with ``seed``, one per group and device."""
    return dict(adamw(learning_rate, b1, b2, eps, weight_decay),
                mu_dtype=mu_dtype, nu_dtype=nu_dtype,
                stochastic_rounding=stochastic_rounding, seed=seed)


def adafactor(learning_rate: float, decay_rate: float = 0.8,
              weight_decay_rate: Optional[float] = None,
              min_dim_size_to_factor: int = 128,
              multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0,
              eps: float = 1e-30) -> Dict:
    """``optax.adafactor`` as :func:`moe_adamw` calls it (no momentum, no
    decay offset): the factored second moment of the two largest dims
    (:func:`_adafactor_update`), the update clipped to RMS
    ``clipping_threshold``, scaled by ``learning_rate`` and by the
    parameter's RMS (at least 1e-3), plus ``weight_decay_rate p``. Not
    ``torch.optim.Adafactor``, whose rule differs."""
    _constant(learning_rate, "adafactor")
    return {"rule": "adafactor", "lr": float(learning_rate),
            "decay_rate": decay_rate, "weight_decay": weight_decay_rate,
            "min_dim_size_to_factor": min_dim_size_to_factor,
            "multiply_by_parameter_scale": multiply_by_parameter_scale,
            "clipping_threshold": clipping_threshold, "eps": eps}


def every_k(inner: Dict, k: int, scale: Optional[float] = None) -> Dict:
    """Apply ``inner`` only every k-th step, its update scaled by ``scale``
    (default k, the same expected per-step learning rate); the other k - 1
    steps leave the parameters and the inner state alone. The applied
    update uses the CURRENT gradient: an accumulator would itself read and
    write a bank-sized buffer every step. The inner rule's step count
    advances only on apply steps, so its learning rate must be constant.
    The gradient is still computed and reduced on every step; for the
    saving use :func:`deferred_pair`."""
    if k < 1:
        raise ValueError(f"every_k needs k >= 1, got {k}")
    return dict(inner, every=int(k), every_scale=float(k if scale is None
                                                       else scale))


def frozen_like(inner: Dict) -> Dict:
    """``inner``'s options and state, but no update and the state left
    alone: the skip half of :func:`deferred_pair`."""
    return dict(inner, frozen=True)


class Partition(NamedTuple):
    """Transforms by label, and the labeler that maps a parameter's name
    to its label (``optax.multi_transform`` keyed by path)."""
    transforms: Dict[str, Dict]
    labeler: Callable[[str], str]


def partition(transforms: Dict[str, Dict],
              labeler: Callable[[str], str]) -> Partition:
    """Route each parameter, by its name, to ``transforms[labeler(name)]``
    (one parameter group per label, :func:`param_groups`)."""
    return Partition(dict(transforms), labeler)


def is_expert_param(name: str) -> bool:
    """The routed expert bank: ``...moe.w1``, ``w2``, ``w3`` (leading E
    dim); the router and the norms are always active. Takes the port's
    ``.``-joined names or the JAX package's ``/``-joined paths."""
    path = name.replace(".", "/").lower()
    return "moe" in path and path.rsplit("/", 1)[-1] in ("w1", "w2", "w3")


Transform = Union[Dict, Partition]


def param_groups(transform: Transform, named_parameters) -> List[Dict]:
    """The parameter groups of ``transform`` over ``named_parameters``: one
    group for a plain transform, one per label of a :class:`Partition` (in
    the order of its ``transforms``; labels without parameters are left
    out). Each group carries its label."""
    named = list(named_parameters)
    if not isinstance(transform, Partition):
        return [dict(transform, params=[p for _, p in named], label=None)]
    by_label: Dict[str, list] = {k: [] for k in transform.transforms}
    for n, p in named:
        label = transform.labeler(n)
        if label not in by_label:
            raise ValueError(f"parameter {n!r} has label {label!r}, not in "
                             f"{sorted(transform.transforms)}")
        by_label[label].append((n, p))
    return [dict(transform.transforms[k], params=[p for _, p in v], label=k)
            for k, v in by_label.items() if v]


def optimizer_for(transform: Transform, named_parameters) -> "MoEOptimizer":
    """:class:`MoEOptimizer` over the groups of ``transform``."""
    return MoEOptimizer(param_groups(transform, named_parameters))


class DeferredPair(NamedTuple):
    """A matched (apply, skip) pair of transforms and their cadence, in one
    value so the update scale baked into ``apply`` and the cadence of
    ``train.make_gspmd_deferred_train_step`` cannot disagree. The two share
    their labels; build the optimizer from ``apply``."""
    apply: Partition
    skip: Partition
    every: int


def deferred_pair(learning_rate: float, *, every: int = 4,
                  weight_decay: float = 1e-4, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  expert_nu_dtype: Optional[torch.dtype] = None,
                  is_expert: Callable[[str], bool] = is_expert_param
                  ) -> DeferredPair:
    """Two-step expert-update deferral: the apply transform gives the bank
    the ``every``-scaled AdamW update of the current gradient; the skip
    transform freezes the bank (``train.make_gspmd_deferred_train_step``
    then computes no gradient for it). The dense parameters get exact AdamW
    on every step. Constant learning rate only. ``expert_nu_dtype=
    torch.bfloat16`` stores the bank's second moment in bf16."""
    if callable(learning_rate):
        raise ValueError("deferred_pair needs a constant learning rate "
                         "(the expert arm ticks only on apply steps)")
    dense = adamw(learning_rate, b1, b2, eps, weight_decay)
    inner = (adamw_low_precision(learning_rate, b1, b2, eps, weight_decay,
                                 nu_dtype=expert_nu_dtype)
             if expert_nu_dtype is not None else dense)
    expert_apply = dict(inner, lr_scale=float(every))
    labeler = (lambda n: "expert" if is_expert(n) else "dense")
    return DeferredPair(
        partition({"dense": dense, "expert": expert_apply}, labeler),
        partition({"dense": dense, "expert": frozen_like(expert_apply)},
                  labeler),
        int(every))


def moe_adamw(learning_rate: float, *, expert_variant: str = "adamw",
              weight_decay: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, every: int = 4,
              is_expert: Callable[[str], bool] = is_expert_param
              ) -> Transform:
    """AdamW with a selectable treatment of the expert bank (the dense
    parameters always get exact AdamW):

    - ``"adamw"``      exact AdamW everywhere (baseline)
    - ``"bf16_nu"``    expert v stored bf16 with stochastic rounding
    - ``"bf16_munu"``  expert m AND v stored bf16 with stochastic rounding
    - ``"factored"``   Adafactor for the expert tensors (factored v, no m)
    - ``"deferred"``   expert update applied every ``every`` steps at
                       ``every`` times the learning rate (:func:`every_k`)
    """
    dense = adamw(learning_rate, b1, b2, eps, weight_decay)
    if expert_variant == "adamw":
        return dense
    if expert_variant == "bf16_nu":
        expert = adamw_low_precision(learning_rate, b1, b2, eps,
                                     weight_decay, nu_dtype=torch.bfloat16)
    elif expert_variant == "bf16_munu":
        expert = adamw_low_precision(learning_rate, b1, b2, eps,
                                     weight_decay, mu_dtype=torch.bfloat16,
                                     nu_dtype=torch.bfloat16)
    elif expert_variant == "factored":
        expert = adafactor(learning_rate, decay_rate=b2,
                           weight_decay_rate=weight_decay)
    elif expert_variant == "deferred":
        if callable(learning_rate):
            raise ValueError(
                "expert_variant='deferred' needs a constant learning rate "
                "(the deferred inner AdamW's schedule count advances only "
                "every k steps; see every_k's docstring)")
        expert = every_k(dense, every)
    else:
        raise ValueError(f"unknown expert_variant {expert_variant!r}")
    return partition({"dense": dense, "expert": expert},
                     lambda n: "expert" if is_expert(n) else "dense")


def _constant(learning_rate, what: str) -> None:
    if callable(learning_rate):
        raise ValueError(f"the port's {what} takes a constant learning "
                         "rate; a schedule sets the group's lr from outside")


# --------------------------------------------------------------- the rules

def _stochastic_round(x: torch.Tensor, dtype: torch.dtype,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding: add a uniform 16-bit value below the
    truncation point to the f32 bits, then truncate the mantissa (bf16 is
    f32's top 16 bits). ``noise``: the values to add (their low 16 bits are
    used, as the JAX function uses ``jax.random.bits & 0xFFFF``); else drawn
    from ``generator``."""
    if dtype != torch.bfloat16:
        raise ValueError("stochastic rounding is implemented for bf16")
    bits = x.float().contiguous().view(torch.int32)
    if noise is None:
        noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                              dtype=torch.int32, device=x.device)
    else:
        noise = (noise.to(torch.int64) & 0xFFFF).to(torch.int32)
    # int32 addition wraps as the JAX uint32 one does; -65536 = 0xFFFF0000
    return ((bits + noise) & -65536).view(torch.float32).to(torch.bfloat16)


def scale_by_adam_low_precision(grad: torch.Tensor, state: Dict, *,
                                b1: float = 0.9, b2: float = 0.999,
                                eps: float = 1e-8,
                                mu_dtype: Optional[torch.dtype] = None,
                                nu_dtype: Optional[torch.dtype] = None,
                                stochastic_rounding: bool = True,
                                generator: Optional[torch.Generator] = None
                                ) -> torch.Tensor:
    """One tensor's Adam direction ``m_hat / (sqrt(v_hat) + eps)`` in f32,
    with the moments ``state["exp_avg"]``, ``state["exp_avg_sq"]`` STORED
    in ``mu_dtype`` / ``nu_dtype`` (None: f32) and ``state["step"]``
    advanced: ``optax.scale_by_adam`` with a low-precision store. With
    ``stochastic_rounding`` a bf16 store is unbiased, so v's tiny per-step
    increments survive (round-to-nearest freezes v once ``b2 v`` dominates
    the increment)."""
    if "step" not in state:
        state["step"] = 0
        state["exp_avg"] = torch.zeros_like(grad, dtype=mu_dtype
                                            or torch.float32)
        state["exp_avg_sq"] = torch.zeros_like(grad, dtype=nu_dtype
                                               or torch.float32)
    state["step"] += 1
    g = grad.float()
    m = state["exp_avg"].float().mul_(b1).add_(g, alpha=1 - b1)
    v = state["exp_avg_sq"].float().mul_(b2).addcmul_(g, g, value=1 - b2)
    t = state["step"]
    out = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt_().add_(eps))
    for key, new, dtype in (("exp_avg", m, mu_dtype),
                            ("exp_avg_sq", v, nu_dtype)):
        if dtype is None:
            state[key] = new
        elif stochastic_rounding and dtype == torch.bfloat16:
            state[key] = _stochastic_round(new, dtype, generator)
        else:
            state[key] = new.to(dtype)
    return out


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: the two largest dims (by ``np.argsort``), or None
    when the second largest is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _whole_sum(x: torch.Tensor, place, dims) -> torch.Tensor:
    """``x``, sums over ``dims`` of this rank's block of a tensor placed by
    ``place`` (a ``sharding.Placement``, or None for a whole tensor), as
    sums over those dims of the whole tensor: all-reduced over the axis of
    each such dim that is split, in dim order, over that axis's row (the
    ranks that hold the tensor's other blocks along it, every other
    coordinate fixed). Every rank posts the same all-reduces in the same
    order."""
    if place is None:
        return x
    for d in sorted(dims):
        a = place.axes[d]
        if a is not None and a.size > 1:
            x = x.contiguous()
            dist.all_reduce(x, group=a.group)
    return x


def _adafactor_update(p: torch.Tensor, g: torch.Tensor, state: Dict,
                      group: Dict, lr: float) -> torch.Tensor:
    """The Adafactor update ``u`` (``p -= u``) of one tensor, optax's
    ``scale_by_factored_rms`` -> ``clip_by_block_rms`` ->
    ``scale_by_learning_rate`` -> ``scale_by_param_block_rms`` ->
    ``add_decayed_weights``.

    optax applies each rule to the whole tensor, so ``p`` may be one block
    of a tensor split over mesh axes (its ``sharding.Placement``, e.g. an
    expert bank ``[E/ep, D/fsdp, M/tp]``): the factored dims come from the
    whole shape, and every mean (the row and column second moments, their
    ``row_col_mean``, the update's and the parameter's block RMS) is a sum
    over the whole tensor (:func:`_whole_sum`) divided by the whole
    count. The moments ``v_row``, ``v_col`` and ``v`` are this rank's
    blocks of optax's."""
    place = getattr(p, "placement", None)
    shape = tuple(place.shape) if place is not None else tuple(p.shape)
    numel = float(np.prod(shape))
    dims = _factored_dims(shape, group["min_dim_size_to_factor"])
    if "step" not in state:
        state["step"] = 0
        if dims is None:
            state["v"] = torch.zeros_like(p, dtype=torch.float32)
        else:
            d1, d0 = dims
            state["v_row"] = torch.zeros_like(p.float().mean(d0))
            state["v_col"] = torch.zeros_like(p.float().mean(d1))
    # the decay of step t (counted from 0): 1 - (t + 1)^(-decay_rate)
    decay = 1.0 - (state["step"] + 1.0) ** (-group["decay_rate"])
    state["step"] += 1
    g = g.float()
    g2 = g * g + group["eps"]
    if dims is None:
        state["v"] = decay * state["v"] + (1 - decay) * g2
        u = g * state["v"].rsqrt()
    else:
        d1, d0 = dims
        row = _whole_sum(g2.sum(d0), place, (d0,)) / shape[d0]
        col = _whole_sum(g2.sum(d1), place, (d1,)) / shape[d1]
        state["v_row"] = decay * state["v_row"] + (1 - decay) * row
        state["v_col"] = decay * state["v_col"] + (1 - decay) * col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = _whole_sum(
            state["v_row"].sum(reduced_d1, keepdim=True), place,
            (d1,)) / shape[d1]
        row_factor = (state["v_row"] / row_col_mean).rsqrt()
        col_factor = state["v_col"].rsqrt()
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
    every = range(len(shape))
    # the update's and the parameter's squared sums, posted together
    sq = _whole_sum(torch.stack([u.square().sum(),
                                 p.float().square().sum()]), place, every)
    if group["clipping_threshold"] is not None:
        u = u / torch.clamp_min((sq[0] / numel).sqrt()
                                / group["clipping_threshold"], 1.0)
    u = u * lr
    if group["multiply_by_parameter_scale"]:
        u = u * torch.clamp_min((sq[1] / numel).sqrt(), 1e-3)
    if group["weight_decay"] is not None:
        u = u + group["weight_decay"] * p.float()
    return u


class MoEOptimizer(torch.optim.Optimizer):
    """The optimizer of this module's transforms: each parameter group
    carries its rule (``"adamw"`` or ``"adafactor"``) and options, and
    optionally ``every``/``every_scale`` (:func:`every_k`), ``lr_scale``
    (a constant factor on the update) and ``frozen`` (:func:`frozen_like`).
    A parameter whose ``.grad`` is None is left alone, its state too.

    AdamW with moments in the parameters' dtype is torch's foreach
    ``adamw`` at ``lr x scale`` (optax's arithmetic); a low-precision
    store, and Adafactor, run tensor by tensor."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, dict(adamw(lr), lr_scale=1.0, every=None,
                                      every_scale=1.0, every_count=0,
                                      frozen=False, label=None))
        self._generators: Dict = {}

    def _generator(self, index: int, group: Dict, device):
        key = (index, str(device))
        if key not in self._generators:
            self._generators[key] = torch.Generator(
                device=device).manual_seed(int(group["seed"]))
        return self._generators[key]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for index, group in enumerate(self.param_groups):
            if group.get("frozen"):
                continue
            scale = group.get("lr_scale", 1.0)
            if group.get("every"):
                group["every_count"] = group.get("every_count", 0) + 1
                if group["every_count"] % group["every"]:
                    continue
                scale *= group["every_scale"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr = group["lr"] * scale
            if group["rule"] == "adafactor":
                for p in params:
                    p.sub_(_adafactor_update(p, p.grad, self.state[p],
                                             group, lr).to(p.dtype))
            elif group["mu_dtype"] is None and group["nu_dtype"] is None:
                self._adamw(params, group, lr)
            else:
                gen = None
                for p in params:
                    if gen is None and group["stochastic_rounding"]:
                        gen = self._generator(index, group, p.device)
                    u = scale_by_adam_low_precision(
                        p.grad, self.state[p], b1=group["b1"],
                        b2=group["b2"], eps=group["eps"],
                        mu_dtype=group["mu_dtype"],
                        nu_dtype=group["nu_dtype"],
                        stochastic_rounding=group["stochastic_rounding"],
                        generator=gen)
                    u.add_(p.float(), alpha=group["weight_decay"])
                    p.sub_((lr * u).to(p.dtype))
        return loss

    def _adamw(self, params, group: Dict, lr: float) -> None:
        """``optax.adamw``: torch's foreach ``adamw``, whose decoupled
        weight decay ``p (1 - lr wd)`` is optax's ``lr wd p``."""
        for p in params:
            st = self.state[p]
            if "step" not in st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
        sts = [self.state[p] for p in params]
        _torch_adamw(
            params, [p.grad for p in params], [st["exp_avg"] for st in sts],
            [st["exp_avg_sq"] for st in sts], [], [st["step"] for st in sts],
            foreach=True, amsgrad=False, beta1=group["b1"],
            beta2=group["b2"], lr=lr, weight_decay=group["weight_decay"],
            eps=group["eps"], maximize=False)
