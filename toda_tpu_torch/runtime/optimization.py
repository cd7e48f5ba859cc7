"""Optimizer and LR schedule of the training step, with optax's semantics.

The port's own counterpart of ``toda_tpu/runtime/optimization.py``, cut to
the ``adam_onecycle`` optimizer that the CenterPoint configs use:

  * the LR is ``optax.cosine_onecycle_schedule(transition_steps=total_steps,
    peak_value=LR, pct_start, div_factor, final_div_factor=1e4)``, evaluated
    at the step count before the update (0 on the first step);
  * Adam's b1 follows the OneCycle momentum companion (``build_b1_schedule``):
    MOMS[0] -> MOMS[1] over the warm-up and back, both by cosine;
  * ``AdamW`` is ``optax.chain(clip_by_global_norm(GRAD_NORM_CLIP),
    adamw(lr, b1, b2=0.999, eps=1e-8, weight_decay, mask))``: the gradients
    are scaled by max_norm / norm only when norm >= max_norm; the moments
    use the step's b1, and so does its bias correction 1 - b1^t; eps is added
    outside the square root; weight decay is added to the update of every
    leaf that flax would not call ``bias`` or ``scale``.

The schedules are host functions of the host step counter, so a step needs
no host-device sync; the gradient norm and the clip factor stay on the
device.
"""

import math

import torch


def _annealing_cos(start, end, t):
    """fastai annealing_cos: cosine interpolation start -> end over t in [0, 1]."""
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * t))


def cosine_onecycle_schedule(transition_steps, peak_value, pct_start=0.3, div_factor=25.0,
                             final_div_factor=1e4):
    """step -> LR, as optax's ``cosine_onecycle_schedule``: cosine from
    peak/div to peak over int(pct_start * T) steps, then to
    peak/(div*final_div) at T, constant after."""
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = [peak_value / div_factor, peak_value,
              peak_value / (div_factor * final_div_factor)]

    def schedule(step):
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return _annealing_cos(values[i], values[i + 1], pct)
        return values[-1] if step >= bounds[-1] else values[0]

    return schedule


def build_scheduler_fn(opt_cfg, total_steps):
    """step -> LR of the configured optimizer (adam_onecycle)."""
    name = opt_cfg.get("OPTIMIZER", "adam_onecycle")
    lr = float(opt_cfg["LR"])
    if name != "adam_onecycle":
        raise NotImplementedError(f"the port's optimizer is adam_onecycle, not {name}")
    return cosine_onecycle_schedule(
        max(total_steps, 1), lr, pct_start=float(opt_cfg.get("PCT_START", 0.4)),
        div_factor=float(opt_cfg.get("DIV_FACTOR", 10.0)), final_div_factor=1e4)


def build_b1_schedule(opt_cfg, total_steps):
    """step -> Adam's b1: the OneCycle momentum companion (MOMS[0] -> MOMS[1]
    over the PCT_START warm-up, then back to MOMS[0], both by cosine)."""
    moms = [float(m) for m in opt_cfg.get("MOMS", [0.95, 0.85])]
    pct = float(opt_cfg.get("PCT_START", 0.4))
    total = max(total_steps, 1)
    warm = max(int(total * pct), 1)

    def sched(step):
        step = min(max(step, 0), total)
        if step < warm:
            return _annealing_cos(moms[0], moms[1], min(max(step / warm, 0.0), 1.0))
        t2 = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return _annealing_cos(moms[1], moms[0], t2)

    return sched


def decays(name, param):
    """Whether flax's weight-decay mask keeps this leaf: every leaf that
    flax does not call ``bias`` or ``scale``. In the port a BatchNorm
    ``weight`` (1-D) is flax's ``scale``; conv ``weight``s are flax
    ``kernel``s."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("kernel", "proj_kernel"):
        return True
    return leaf == "weight" and param.dim() > 1


class AdamW:
    """Global-norm clip, then Adam with a per-step LR and b1 and decoupled
    weight decay on the masked leaves (optax semantics, see the module
    docstring). Updates the parameters in place."""

    def __init__(self, named_params, lr_fn, b1_fn, b2=0.999, eps=1e-8, weight_decay=0.0,
                 max_grad_norm=0.0):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.decayed = [i for i, (n, p) in enumerate(named) if weight_decay > 0 and decays(n, p)]
        self.lr_fn, self.b1_fn = lr_fn, b1_fn
        self.b2, self.eps, self.weight_decay = b2, eps, weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0  # steps taken, on the host

    def state_dict(self):
        """The moments and the step count (a checkpoint's optimizer part)."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, sd):
        for dst, src in zip(self.mu + self.nu, list(sd["mu"]) + list(sd["nu"])):
            dst.copy_(src)
        self.count = int(sd["count"])

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.max_grad_norm
            one = torch.ones((), device=norm.device)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_grad_norm))
        lr, b1, b2 = self.lr_fn(self.count), self.b1_fn(self.count), self.b2
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - b2 ** self.count))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.decayed:
            torch._foreach_add_([upd[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed], alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)


def build_optimizer(opt_cfg, total_steps, named_params):
    """Returns (AdamW over ``named_params``, LR schedule)."""
    schedule = build_scheduler_fn(opt_cfg, total_steps)
    tx = AdamW(named_params, schedule, build_b1_schedule(opt_cfg, total_steps),
               weight_decay=float(opt_cfg.get("WEIGHT_DECAY", 0.0)),
               max_grad_norm=float(opt_cfg.get("GRAD_NORM_CLIP", 0.0)))
    return tx, schedule
