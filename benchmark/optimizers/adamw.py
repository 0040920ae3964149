"""AdamW as the benchmark knows it, found by the configuration's
``optimizer`` key: the plain update the reference takes, and what the
check reads of the program's ``torch.optim`` optimizer.

The update: decoupled weight decay ``p *= 1 - lr * wd``, then Adam with
eps 1e-8 added to the bias-corrected root, betas and decay from the
configuration's settings (``adam_beta1``, ``adam_beta2``,
``weight_decay``).
"""

from typing import Dict, List

import torch

EPS = 1e-8


class Reference:
    """The reference's optimizer state over ``params`` (name -> tensor)."""

    def __init__(self, params: Dict[str, torch.Tensor], settings: Dict):
        self.b1, self.b2 = settings["adam_beta1"], settings["adam_beta2"]
        self.wd = settings["weight_decay"]
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, t: int, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> None:
        for n, g in grads.items():
            p, m, v = params[n], self.m[n], self.v[n]
            p.mul_(1.0 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v / (1.0 - self.b2 ** t)).sqrt_().add_(EPS)
            p.addcdiv_(m, denom, value=-lr / (1.0 - self.b1 ** t))


def first_gradient_norms(optimizer, leaves: List, settings: Dict
                         ) -> Dict[str, float]:
    """The norm of each (name, parameter)'s gradient as the optimizer got
    it at its first step, from its state after that step: exp_avg /
    (1 - beta1); 0 for a leaf with no state (no step took it)."""
    zero = None
    norms = []
    for _, p in leaves:
        state = optimizer.state.get(p, {})
        if "exp_avg" in state:
            norms.append(state["exp_avg"].norm())
        else:
            zero = torch.zeros((), device=p.device) if zero is None else zero
            norms.append(zero)
    values = (torch.stack(norms) / (1.0 - settings["adam_beta1"])).tolist()
    return dict(zip([n for n, _ in leaves], values))


def settings_diff(optimizer, leaves: List, settings: Dict) -> int:
    """How far the optimizer departs from the configuration: each of beta1,
    beta2, eps and weight decay that differs in a group holding trainable
    leaves, and each trainable leaf that it holds other than once."""
    want = (settings["adam_beta1"], settings["adam_beta2"], EPS,
            settings["weight_decay"])
    held: Dict[int, int] = {}
    diff = 0
    for group in optimizer.param_groups:
        got = (*group["betas"], group["eps"], group["weight_decay"])
        if any(p.requires_grad for p in group["params"]):
            diff += sum(float(a) != float(b) for a, b in zip(got, want))
        for p in group["params"]:
            held[id(p)] = held.get(id(p), 0) + 1
    return diff + sum(held.get(id(p), 0) != 1 for _, p in leaves)
