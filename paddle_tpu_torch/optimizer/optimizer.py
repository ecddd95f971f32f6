"""Optimizers (counterpart of `paddle_tpu/optimizer/optimizer.py`): the
`Optimizer` base and SGD, Momentum, Adagrad, Adam, AdamW, Adamax, RMSProp,
Adadelta, Lamb, RAdam, NAdam, ASGD and Rprop, with `L1Decay` and `L2Decay`,
each with the reference's update math. LBFGS is not ported.

`step()` is the reference's eager step: the (parameter, gradient) pairs of
the parameters that take gradients (`requires_grad`, the reference's
`stop_gradient` unset) and have one, through `grad_clip` if given, then
one update each at the learning rate (a float or an `lr.LRScheduler`)
times the parameter's `optimize_attr["learning_rate"]`, with the name ''
handed to AdamW's `apply_decay_param_fun` (a tensor's `name` is None and
cannot be set; the reference's layer parameters are unnamed, '').
`apply_gradients` is the reference's compiled-step update
(`apply_gradients_functional`): no clip, no `optimize_attr` scale, the
structured parameter names (`jit.train_step` uses it).

Weight decay as in the reference: a float, `L2Decay(c)` or `L1Decay(c)` is
the coefficient c of an L2 term added to the gradient (the reference reads
only the coefficient, so `L1Decay` acts as L2 there and here); AdamW's
`weight_decay` is its decoupled coefficient.

Adam and AdamW keep their moments in f32 whatever the parameter dtype (the
reason this is not `torch.optim.AdamW`, whose moments follow the parameter:
bf16 under O2), an f32 master weight under `multi_precision`, and the
bias-correction accumulators `beta1_pow` / `beta2_pow` as f32 host
scalars; their update is `kernels.adam.adam_update` (the one-pass CUDA
kernel for CUDA tensors, its plain version for CPU tensors). The other
optimizers run PyTorch operations in the reference's order and dtypes: a
Python scalar in an operation on a bf16 / f16 tensor is first rounded to
that dtype, as JAX's weak typing rounds it (`_weak`).

The port updates parameters and state in place (the JAX package builds new
arrays) to keep the working set near one f32 copy of the largest tensor.
State is keyed by the parameter's position in the list.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import adam as _kadam
from .lr import LRScheduler


def _coeff(weight_decay):
    """A float, an `L2Decay` / `L1Decay` (its coefficient) or None (0)."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff", 0.0))


def _weak(x, t):
    """Python scalar x as JAX's weak typing uses it in an operation on
    tensor t: rounded to t's dtype."""
    if t.dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(float(x), dtype=t.dtype))


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class Optimizer:
    """Holds the parameter list, the learning rate (a float or an
    `LRScheduler`), `grad_clip` and the per-parameter state (keyed by the
    parameter's position in the list)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._grad_clip = grad_clip
        self._weight_decay = _coeff(weight_decay)
        self._accumulators = {}
        self._step_count = 0

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    def _init_state(self, p):
        return {}

    def _update_param(self, p, g, state, lr, param_name=None):
        raise NotImplementedError

    def _state_for(self, i):
        if i not in self._accumulators:
            self._accumulators[i] = self._init_state(
                self._parameter_list[i])
        return self._accumulators[i]

    def _decay_grad(self, p, g):
        """The L2 term: g + coeff * p (no term at coeff 0)."""
        if self._weight_decay:
            return g + _weak(self._weight_decay, p) * p
        return g

    @torch.no_grad()
    def step(self):
        """One update of every parameter that takes a gradient and has one:
        `grad_clip` over the (parameter, gradient) list first, then each at
        lr times its `optimize_attr["learning_rate"]`."""
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer constructed without parameters")
        pos = {id(p): i for i, p in enumerate(params)}
        params_grads = [(p, p.grad) for p in params
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        self._step_count += 1
        for p, g in params_grads:
            if g is None:
                continue
            scale = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            self._update_param(p, g, self._state_for(pos[id(p)]),
                               lr * scale, p.name or "")

    @torch.no_grad()
    def apply_gradients(self, named_grads, lr):
        """The compiled step's update (the reference's
        `apply_gradients_functional`): for each (name, parameter, gradient)
        one update at `lr` (an f32 scalar, as the compiled step passes it),
        with `name` for AdamW's `apply_decay_param_fun`; no `grad_clip`, no
        `optimize_attr` scale, no step count."""
        pos = {id(p): i for i, p in enumerate(self._parameter_list)}
        for name, p, g in named_grads:
            self._update_param(p, g, self._state_for(pos[id(p)]), lr, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list or ():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        """{"step": n, "<i>_<name>": state, "LR_Scheduler": the scheduler's
        state (with a scheduler)} for parameter position i. The reference
        keys an entry "<p.name or i>_<name>"
        (`paddle_tpu/optimizer/optimizer.py::state_dict`), and its layers'
        parameters are unnamed (`name == ''`), so its keys fall back to the
        position too: the two packages' keys agree."""
        out = {"step": self._step_count}
        for i, st in sorted(self._accumulators.items()):
            for k, v in st.items():
                out[f"{i}_{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Restore `step`, the scheduler's state (`LR_Scheduler`, with a
        scheduler) and each "<i>_<name>" entry of `state` (this
        optimizer's `state_dict`, or the reference's, its arrays as numpy
        arrays or tensors) into the state of parameter i, on the
        parameter's device and in the dtype this optimizer keeps for that
        entry. Keys of no parameter or no state entry are ignored, as the
        reference ignores them."""
        self._step_count = int(state.get("step", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for key, v in state.items():
            i, _, name = key.partition("_")
            if not i.isdigit() or int(i) >= len(self._parameter_list):
                continue
            st = self._state_for(int(i))
            if name not in st:
                continue
            cur = st[name]
            t = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, copy=True))
            if isinstance(cur, torch.Tensor):
                st[name] = t.to(cur.device, cur.dtype).reshape(cur.shape) \
                    .clone()
            else:  # host scalars: the f32 pows, counters
                st[name] = type(cur)(t.item())


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p, g)
        p.sub_(_weak(lr, p) * g.to(p.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p, g)
        v = _weak(self._momentum, g) * state["velocity"] + g
        update = g + _weak(self._momentum, v) * v if self._nesterov else v
        state["velocity"] = v
        p.sub_(_weak(lr, p) * update.to(p.dtype))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p.detach(), self._init_val)}

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p, g)
        m = state["moment"] + g.square()
        state["moment"] = m
        p.copy_(p - _weak(lr, g) * g / (m.sqrt() + _weak(self._epsilon, m)))


class Adam(Optimizer):
    """Adam with f32 moments; `weight_decay` is an L2 term on the gradient.
    `lazy_mode=True` (sparse rows) has no dense meaning and raises;
    `use_multi_tensor` is accepted and unused, as in the reference (the
    update is one kernel launch a parameter either way)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None):
        if lazy_mode:
            raise NotImplementedError("Adam(lazy_mode=True): sparse lazy "
                                      "updates have no dense counterpart")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _init_state(self, p):
        st = {"moment1": _zeros32(p), "moment2": _zeros32(p),
              "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().float()
        return st

    def _decoupled_coeff(self, param_name):
        return 0.0

    def _update_param(self, p, g, state, lr, param_name=None):
        b1p = np.float32(state["beta1_pow"] * np.float32(self._beta1))
        b2p = np.float32(state["beta2_pow"] * np.float32(self._beta2))
        coeff = self._decoupled_coeff(param_name)
        _kadam.adam_update(p, g, state["moment1"], state["moment2"],
                           state.get("master_weight"), self._beta1,
                           self._beta2, self._epsilon, lr, coeff,
                           0.0 if coeff else self._weight_decay,
                           1 - b1p, 1 - b2p)
        state["beta1_pow"], state["beta2_pow"] = b1p, b2p


class AdamW(Adam):
    """Adam with decoupled weight decay `weight_decay` (default 0.01, or an
    `L2Decay`'s coefficient), applied to the working copy before the
    update, except to parameters whose name `apply_decay_param_fun`
    refuses. `lr_ratio` is accepted and unused, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._coeff = _coeff(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_coeff(self, param_name):
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(param_name):
            return 0.0
        return self._coeff


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p),
                "beta1_pow": np.float32(1.0)}

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p.float(), g.float())
        b1p = np.float32(state["beta1_pow"] * self._beta1)
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], g.abs())
        step = float(lr / (1 - b1p)) * m / (u + self._epsilon)
        p.copy_(p.float() - step)
        state.update(moment=m, inf_norm=u, beta1_pow=b1p)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        st = {"mean_square": _zeros32(p), "momentum": _zeros32(p)}
        if self._centered:
            st["mean_grad"] = _zeros32(p)
        return st

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p.float(), g.float())
        rho = self._rho
        ms = rho * state["mean_square"] + (1 - rho) * g.square()
        state["mean_square"] = ms
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = (ms - mg.square() + self._epsilon).sqrt()
            state["mean_grad"] = mg
        else:
            denom = (ms + self._epsilon).sqrt()
        mom = self._momentum * state["momentum"] + lr * g / denom
        state["momentum"] = mom
        p.copy_(p.float() - mom)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def _update_param(self, p, g, state, lr, param_name=None):
        g = self._decay_grad(p.float(), g.float())
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g.square()
        update = ((state["avg_squared_update"] + eps).sqrt()
                  / (asg + eps).sqrt()) * g
        asu = rho * state["avg_squared_update"] + (1 - rho) * update.square()
        p.copy_(p.float() - lr * update)
        state.update(avg_squared_grad=asg, avg_squared_update=asu)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._coeff = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}

    def _update_param(self, p, g, state, lr, param_name=None):
        pf, g = p.float(), g.float()
        b1, b2 = self._beta1, self._beta2
        b1p = np.float32(state["beta1_pow"] * b1)
        b2p = np.float32(state["beta2_pow"] * b2)
        m1 = b1 * state["moment1"] + (1 - b1) * g
        m2 = b2 * state["moment2"] + (1 - b2) * g.square()
        m1h = m1 / float(1 - b1p)
        m2h = m2 / float(1 - b2p)
        coeff = self._coeff
        if self._exclude_fn is not None and self._exclude_fn(param_name):
            coeff = 0.0
        r = m1h / (m2h.sqrt() + self._epsilon) + coeff * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_(pf - lr * trust * r)
        state.update(moment1=m1, moment2=m2, beta1_pow=b1p, beta2_pow=b2p)


class RAdam(Optimizer):
    """Rectified Adam: the adaptive step scaled by the variance
    rectification r_t once rho_t > 5, plain momentum before."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0),
                "t": np.float32(0.0)}

    def _update_param(self, p, g, state, lr, param_name=None):
        work = p.float()
        g = self._decay_grad(work, g.float())
        b1, b2 = self._beta1, self._beta2
        t = np.float32(state["t"] + 1)
        b1p = np.float32(state["beta1_pow"] * b1)
        b2p = np.float32(state["beta2_pow"] * b2)
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        m_hat = m / float(1 - b1p)
        rho_inf = 2.0 / (1 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * b2p / (1 - b2p)
        r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
        r_den = (rho_inf - 4) * (rho_inf - 2) * np.maximum(rho_t, 1e-6)
        r_t = np.sqrt(np.maximum(r_num / r_den, np.float32(0.0)))
        if rho_t > 5.0:
            v_hat = (v / float(1 - b2p)).sqrt() + self._epsilon
            delta = float(lr * r_t) * m_hat / v_hat
        else:
            delta = lr * m_hat
        p.copy_(work - delta)
        state.update(moment1=m, moment2=v, beta1_pow=b1p, beta2_pow=b2p,
                     t=t)


class NAdam(Optimizer):
    """Adam with Nesterov momentum and the momentum-decay schedule
    mu_t = beta1 (1 - 0.5 * 0.96^(t psi))."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _init_state(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p),
                "mu_prod": np.float32(1.0), "beta2_pow": np.float32(1.0),
                "t": np.float32(0.0)}

    def _update_param(self, p, g, state, lr, param_name=None):
        work = p.float()
        g = self._decay_grad(work, g.float())
        b1, b2, psi = self._beta1, self._beta2, self._psi
        t = np.float32(state["t"] + 1)
        mu_t = np.float32(b1 * (1 - 0.5 * 0.96 ** (t * psi)))
        mu_next = np.float32(b1 * (1 - 0.5 * 0.96 ** ((t + 1) * psi)))
        mu_prod = np.float32(state["mu_prod"] * mu_t)
        b2p = np.float32(state["beta2_pow"] * b2)
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g.square()
        m_hat = (float(mu_next) * m / float(1 - mu_prod * mu_next)
                 + float(1 - mu_t) * g / float(1 - mu_prod))
        v_hat = v / float(1 - b2p)
        p.copy_(work - lr * m_hat / (v_hat.sqrt() + self._epsilon))
        state.update(moment1=m, moment2=v, mu_prod=mu_prod, beta2_pow=b2p,
                     t=t)


class ASGD(Optimizer):
    """Averaged SGD: steps along the mean of the last `batch_num`
    gradients (the first pass: of those seen so far). `multi_precision`
    is accepted and unused, as in the reference."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._n = max(int(batch_num), 1)

    def _init_state(self, p):
        return {"d": _zeros32(p),
                "grads": torch.zeros((self._n,) + tuple(p.shape),
                                     dtype=torch.float32, device=p.device),
                "t": 0}

    def _update_param(self, p, g, state, lr, param_name=None):
        work = p.float()
        g = self._decay_grad(work, g.float())
        slot = state["t"] % self._n
        d = state["d"] - state["grads"][slot] + g
        state["grads"][slot] = g
        seen = np.float32(min(state["t"] + 1, self._n))
        p.copy_(work - lr * d / float(seen))
        state.update(d=d, t=state["t"] + 1)


class Rprop(Optimizer):
    """Resilient backpropagation (iRprop-): per-element step sizes grown by
    `etas[1]` while the gradient keeps its sign and shrunk by `etas[0]`
    when it flips (then no step, and the gradient is forgotten), within
    `learning_rate_range`. `multi_precision` is accepted and unused, as in
    the reference."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_state(self, p):
        return {"prev_grad": _zeros32(p),
                "step_size": torch.full(p.shape, float(self.get_lr()),
                                        dtype=torch.float32,
                                        device=p.device)}

    def _update_param(self, p, g, state, lr, param_name=None):
        work = p.float()
        g = g.float()
        sign = g * state["prev_grad"]
        size = state["step_size"]
        step = torch.where(
            sign > 0, torch.clamp(size * self._eta_pos, max=self._lr_max),
            torch.where(sign < 0,
                        torch.clamp(size * self._eta_neg, min=self._lr_min),
                        size))
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        p.copy_(work - g_eff.sign() * step)
        state.update(prev_grad=g_eff, step_size=step)


__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "L1Decay", "L2Decay", "Lamb", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop", "SGD"]
