"""Optimizers and learning-rate schedules (counterpart of
``aonerf.train.optim`` and of ``aonerf.train.step.make_adam``).

  Adam    Adam(0.9, 0.999, eps 1e-8); with ``weight_decay`` AdamW as optax
          computes it: -lr * (m^ / (sqrt(v^) + eps) + wd * p), the decay on
          every parameter (the reference's 'adam')
  SGD     g + wd * p (coupled decay), then the momentum trace
          t = g + momentum * t, the update -lr * t
  RAdam   g + wd * p, then Rectified Adam: -lr * r * m^ / (sqrt(v^) + eps)
          where rho_t >= 5, else -lr * m^ (optax's threshold and formula)
  Ranger  ``Lookahead`` around RAdam: the fast weights take RAdam's steps;
          every 6th update the slow weights move half way to them and the
          parameters take the slow weights
  LatentSplit  one optimizer for the auto-decoder's field and an AdamW at
          ``latent_lr`` for its code tables; a clip stays inside the first

Every optimizer has ``init(params) -> OptState``, ``update(params, grads,
state, mask=None) -> OptState`` (the parameters updated in place) and
``schedule(count)``, the learning rate of the update that follows ``count``
updates. ``OptState`` holds one count, the updates applied (optax keeps one
per transform, and all of them advance together), and the per-parameter
slots by name: lists in the parameters' order, None where a slot does not
apply (the latent split's codes have no momentum trace). ``mask`` restricts
an update to the parameters it marks: the others and every slot of theirs
stay as they were, the count advances (the auto-encoder's field-only steps).

Plain PyTorch tensor code in optax's order of operations, not torch.optim's;
the scalars of an update (bias corrections, RAdam's rectification, the
learning rate) are computed in np.float32, as JAX computes them. XLA's
float32 pow and cos are not correctly rounded; the schedules here round the
float64 value, which lands within one ulp of XLA's.

The schedules are the reference's epoch-granular ones over steps (epoch =
step / steps_per_epoch): steplr (x gamma at each milestone), cosine (to
1e-8 over num_epochs), poly ((1 - e / num_epochs) ^ poly_exp), with the
gradual warmup of GradualWarmupScheduler in front (not for radam and
ranger, as the reference skips it).
"""

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aonerf_torch.train.lr import log_lerp_lr

_EPS = 1e-8
f32 = np.float32
Schedule = Callable[[int], float]


@dataclass
class OptState:
    count: int
    slots: Dict[str, List[Optional[torch.Tensor]]]


def _pow32(base, exp) -> np.float32:
    """float32 base ** exp, rounded from float64."""
    return f32(np.float64(f32(base)) ** np.float64(f32(exp)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's clip: each gradient / norm * max_norm when the global norm
    reaches max_norm (no 1e-6, as ``torch.nn.utils.clip_grad_norm_`` adds)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    return [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]


class Optimizer:
    """A per-parameter rule: ``_scalars(count)`` once an update, then
    ``_leaf`` for each parameter returns its update and its new slots."""

    slots: Tuple[str, ...] = ()

    def __init__(self, schedule: Schedule, grad_clip: Optional[float] = None):
        self.schedule, self.grad_clip = schedule, grad_clip

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(count=0, slots={s: [torch.zeros_like(p) for p in params] for s in self.slots})

    def _scalars(self, count: int) -> Dict[str, float]:
        return {"step_size": -float(f32(self.schedule(count)))}

    def _leaf(self, p, g, slots: Dict[str, torch.Tensor], c) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def _apply(self, p, u, slots, c) -> Dict[str, torch.Tensor]:
        p.add_(u)
        return slots

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], state: OptState,
               mask: Optional[Sequence[bool]] = None) -> OptState:
        """One update of ``params`` in place; returns the new state. With
        ``mask`` only the marked parameters move (the others' gradients
        are not read: optax's would be zeros, which add nothing to the
        clip's norm)."""
        live = [i for i in range(len(params)) if mask is None or mask[i]]
        g = [grads[i] for i in live]
        if self.grad_clip:
            g = clip_by_global_norm(g, self.grad_clip)
        c = self._scalars(state.count)
        slots = {k: list(v) for k, v in state.slots.items()}
        for i, gi in zip(live, g):
            old = {k: slots[k][i] for k in self.slots}
            u, new = self._leaf(params[i], gi, old, c)
            new = self._apply(params[i], u, new, c)
            for k in self.slots:
                slots[k][i] = new[k]
        return OptState(count=state.count + 1, slots=slots)


class Adam(Optimizer):
    """Adam(b1, b2, eps) after an optional global-norm clip, as optax's
    ``clip_by_global_norm`` then ``adam`` (``adamw`` with
    ``weight_decay``) compute it: the schedule read at the count before the
    update."""

    slots = ("mu", "nu")

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        super().__init__(schedule, grad_clip)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def _scalars(self, count):
        n = f32(count + 1)
        return {
            "bc1": float(f32(1.0) - f32(self.b1) ** n),
            "bc2": float(f32(1.0) - f32(self.b2) ** n),
            **super()._scalars(count),
        }

    def _leaf(self, p, g, s, c):
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * s["mu"]
        nu = (1 - b2) * (g * g) + b2 * s["nu"]
        u = (mu / c["bc1"]) / (torch.sqrt(nu / c["bc2"]) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p
        return u * c["step_size"], {"mu": mu, "nu": nu}


class SGD(Optimizer):
    """optax's chain(add_decayed_weights(wd), sgd(lr, momentum))."""

    slots = ("trace",)

    def __init__(self, schedule: Schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None):
        super().__init__(schedule, grad_clip)
        self.momentum, self.weight_decay = momentum, weight_decay

    def _leaf(self, p, g, s, c):
        if self.weight_decay:
            g = g + self.weight_decay * p
        t = g + self.momentum * s["trace"]
        return t * c["step_size"], {"trace": t}


class RAdam(Optimizer):
    """optax's chain(add_decayed_weights(wd), radam(lr, eps=eps))."""

    slots = ("mu", "nu")

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0, weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        super().__init__(schedule, grad_clip)
        self.b1, self.b2, self.eps, self.threshold, self.weight_decay = b1, b2, eps, threshold, weight_decay

    def _scalars(self, count):
        n = count + 1
        b2t = _pow32(self.b2, n)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = f32(ro_inf) - f32(2 * n) * b2t / (f32(1.0) - b2t)
        rectify = bool(ro >= f32(self.threshold))
        r = 0.0
        if rectify:
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf) / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return {
            "bc1": float(f32(1.0) - _pow32(self.b1, n)),
            "bc2": float(f32(1.0) - b2t),
            "rectify": rectify,
            "r": float(r),
            **super()._scalars(count),
        }

    def _leaf(self, p, g, s, c):
        if self.weight_decay:
            g = g + self.weight_decay * p
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * s["mu"]
        nu = (1 - b2) * (g * g) + b2 * s["nu"]
        mu_hat = mu / c["bc1"]
        u = (c["r"] * mu_hat) / (torch.sqrt(nu / c["bc2"]) + self.eps) if c["rectify"] else mu_hat
        return u * c["step_size"], {"mu": mu, "nu": nu}


class Lookahead(Optimizer):
    """``flat_lookahead`` around ``inner``: the slow weights in the state.
    The parameter takes p + (x - p), x the fast weights p + u or, on a sync
    update, the slow weights moved ``alpha`` of the way to them, as optax
    applies the lookahead's update."""

    def __init__(self, inner: Optimizer, sync_period: int = 6, alpha: float = 0.5):
        super().__init__(inner.schedule, inner.grad_clip)
        self.inner, self.sync_period, self.alpha = inner, sync_period, alpha
        self.slots = inner.slots + ("slow",)

    def init(self, params):
        state = self.inner.init(params)
        state.slots["slow"] = [p.detach().clone() for p in params]
        return state

    def _scalars(self, count):
        return {**self.inner._scalars(count), "sync": (count + 1) % self.sync_period == 0}

    def _leaf(self, p, g, s, c):
        u, new = self.inner._leaf(p, g, s, c)
        return u, {**new, "slow": s["slow"]}

    def _apply(self, p, u, new, c):
        x = p + u
        if c["sync"]:
            x = new["slow"] + self.alpha * (x - new["slow"])
            new = {**new, "slow": x}
        p.add_(x - p)
        return new


class LatentSplit:
    """``model_tx`` for the first ``n_model`` parameters (the field) and
    ``codes_tx`` for the rest (the code tables), as optax's
    multi_transform over {'model', 'codes'}; one state, its slots the union
    of both (None where a side has no such slot)."""

    def __init__(self, model_tx: Optimizer, codes_tx: Optimizer, n_model: int):
        self.model_tx, self.codes_tx, self.n_model = model_tx, codes_tx, n_model
        self.schedule = model_tx.schedule
        self.slots = tuple(dict.fromkeys(model_tx.slots + codes_tx.slots))

    def _sides(self, items):
        return ((self.model_tx, items[: self.n_model]), (self.codes_tx, items[self.n_model :]))

    def _merge(self, count, states, sizes) -> OptState:
        return OptState(count=count, slots={
            k: [x for st, n in zip(states, sizes) for x in st.slots.get(k, [None] * n)] for k in self.slots
        })

    def init(self, params):
        sides = self._sides(params)
        return self._merge(0, [tx.init(p) for tx, p in sides], [len(p) for _, p in sides])

    def update(self, params, grads, state: OptState, mask=None) -> OptState:
        n = self.n_model
        cut = {k: (v[:n], v[n:]) for k, v in state.slots.items()}
        masks = (None, None) if mask is None else (mask[:n], mask[n:])
        out = []
        for side, ((tx, p), g, m) in enumerate(zip(self._sides(params), (grads[:n], grads[n:]), masks)):
            sub = OptState(count=state.count, slots={k: cut[k][side] for k in tx.slots})
            out.append(tx.update(p, g, sub, mask=m))
        return self._merge(state.count + 1, out, [n, len(params) - n])


def make_adam(
    lr_init: float = 5.0e-4,
    lr_final: float = 5.0e-6,
    max_steps: int = 100_000,
    lr_delay_steps: int = 2500,
    lr_delay_mult: float = 0.01,
    grad_clip: Optional[float] = None,
) -> Adam:
    """Adam(0.9, 0.999, eps 1e-8) with the log-lerp + sin-delay schedule;
    ``grad_clip`` (global norm) is off by default, as in the reference."""
    schedule = partial(
        log_lerp_lr, lr_init=lr_init, lr_final=lr_final, max_steps=max_steps,
        lr_delay_steps=lr_delay_steps, lr_delay_mult=lr_delay_mult,
    )
    return Adam(schedule, grad_clip=grad_clip)


def make_schedule(
    name: str,
    lr: float,
    num_epochs: int = 80,
    decay_step: Sequence[int] = (20,),
    decay_gamma: float = 0.1,
    poly_exp: float = 0.99,
    steps_per_epoch: int = 1,
) -> Schedule:
    """The reference's scheduler ``name`` over steps, epoch-granular."""

    def progress(step):
        return np.clip(f32(step) / f32(steps_per_epoch) / f32(num_epochs), f32(0.0), f32(1.0))

    if name == "steplr":
        boundaries = sorted(int(m) * steps_per_epoch for m in decay_step)
        return lambda step: float(f32(lr) * _pow32(decay_gamma, sum(step >= b for b in boundaries)))
    if name == "cosine":
        cos = lambda t: f32(np.cos(np.float64(f32(np.pi) * t)))  # noqa: E731
        return lambda step: float(f32(_EPS) + f32((lr - _EPS) * 0.5) * (f32(1.0) + cos(progress(step))))
    if name == "poly":
        return lambda step: float(f32(lr) * _pow32(f32(1.0) - progress(step), poly_exp))
    raise ValueError(f"scheduler {name!r} not recognized")


def with_warmup(
    schedule: Schedule,
    lr: float,
    warmup_multiplier: float = 1.0,
    warmup_epochs: int = 0,
    steps_per_epoch: int = 1,
) -> Schedule:
    """GradualWarmupScheduler: lr * ((m - 1) * e / total + 1) while step <=
    warmup_epochs * steps_per_epoch, then the wrapped schedule (restarted
    at 0) times m."""
    if warmup_epochs <= 0:
        return schedule
    if warmup_multiplier < 1.0:
        raise ValueError("multiplier should be greater than or equal to 1.")
    total = warmup_epochs * steps_per_epoch

    def warmed(step):
        if step <= total:
            e = np.minimum(f32(step) / f32(steps_per_epoch), f32(warmup_epochs))
            return float(f32(lr) * (f32(warmup_multiplier - 1.0) * e / f32(warmup_epochs) + f32(1.0)))
        return float(f32(schedule(step - total)) * f32(warmup_multiplier))

    return warmed


def make_optimizer(
    optimizer: str = "adam",
    schedule: Schedule = lambda count: 1e-3,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    """The reference's get_optimizer; 'adam' is AdamW, as the reference
    maps it."""
    if optimizer == "sgd":
        return SGD(schedule, momentum=momentum, weight_decay=weight_decay, grad_clip=grad_clip)
    if optimizer == "adam":
        return Adam(schedule, eps=_EPS, weight_decay=weight_decay, grad_clip=grad_clip)
    if optimizer == "radam":
        return RAdam(schedule, eps=_EPS, weight_decay=weight_decay, grad_clip=grad_clip)
    if optimizer == "ranger":
        return Lookahead(RAdam(schedule, eps=_EPS, weight_decay=weight_decay, grad_clip=grad_clip))
    raise ValueError(f"optimizer {optimizer!r} not recognized")


def make_optimizer_with_latent(model_tx: Optimizer, n_model: int, latent_lr: float = 1e-3) -> LatentSplit:
    """``model_tx`` for the field and optax's default AdamW (weight decay
    1e-4) at ``latent_lr`` for the code tables, unclipped."""
    return LatentSplit(model_tx, Adam(lambda count: latent_lr, eps=_EPS, weight_decay=1e-4), n_model)


def build_optimizer_from_config(cfg, n_model: Optional[int] = None) -> Tuple[object, Schedule]:
    """(tx, lr_fn) for a Config, routed as JAX's: 'adam' with no
    lr_scheduler is the log-lerp Adam; anything else ``make_optimizer``
    with ``make_schedule(lr_scheduler or 'poly')`` and the warmup (not for
    radam and ranger). ``grad_clip`` > 0 clips either way. ``latent_lr`` on
    the auto-decoder splits off the code tables, the parameters after the
    field's first ``n_model``."""
    clip = cfg.grad_clip or None
    if cfg.optimizer == "adam" and cfg.lr_scheduler is None:
        tx = make_adam(
            lr_init=cfg.lr_init, lr_final=cfg.lr_final, max_steps=cfg.run_max_steps,
            lr_delay_steps=cfg.lr_delay_steps, lr_delay_mult=cfg.lr_delay_mult, grad_clip=clip,
        )
    else:
        schedule = make_schedule(
            cfg.lr_scheduler or "poly", lr=cfg.lr_init, num_epochs=cfg.num_epochs, decay_step=cfg.decay_step,
            decay_gamma=cfg.decay_gamma, poly_exp=cfg.poly_exp, steps_per_epoch=cfg.steps_per_epoch,
        )
        if cfg.optimizer not in ("radam", "ranger"):
            schedule = with_warmup(schedule, lr=cfg.lr_init, warmup_multiplier=cfg.warmup_multiplier,
                                   warmup_epochs=cfg.warmup_epochs, steps_per_epoch=cfg.steps_per_epoch)
        tx = make_optimizer(cfg.optimizer, schedule, momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                            grad_clip=clip)
    lr_fn = tx.schedule
    if cfg.latent_lr is not None and cfg.exp_type == "vanilla_autodecoder":
        if n_model is None:
            raise ValueError("latent_lr needs n_model, the count of the field's parameters")
        tx = make_optimizer_with_latent(tx, n_model, latent_lr=cfg.latent_lr)
    return tx, lr_fn
