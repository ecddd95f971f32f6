"""Optimizers (counterpart of `paddle_tpu/optimizer/optimizer.py`): the
`Optimizer` base, `Adam` and `AdamW`, with the reference's own update math.

Adam keeps its moments in f32 whatever the parameter dtype (the reason this
is not `torch.optim.AdamW`, whose moments follow the parameter: bf16 under
O2), and the bias-correction accumulators `beta1_pow` / `beta2_pow` as f32
scalars. One update, per parameter (`_update_param`):

    work = master weight if multi_precision else f32(p)
    g = f32(grad)                   (+ weight_decay * work for Adam's L2)
    beta1_pow *= beta1; beta2_pow *= beta2
    m1 = beta1 m1 + (1 - beta1) g;  m2 = beta2 m2 + (1 - beta2) g^2
    work *= 1 - lr * coeff          (AdamW: decoupled decay, first)
    work -= lr * (m1 / (1 - beta1_pow)) / (sqrt(m2 / (1 - beta2_pow)) + eps)
    p = work cast to p's dtype

The port updates parameters and state in place (the JAX package builds new
arrays) to keep the working set near one f32 copy of the largest tensor.
Learning-rate schedulers and gradient clipping are not ported.
"""
from __future__ import annotations

import numpy as np
import torch


class Optimizer:
    """Holds the parameter list, the learning rate and the per-parameter
    state (keyed by the parameter's position in the list)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None):
        if parameters is None:
            raise ValueError("the optimizer needs its parameters")
        self._lr = float(learning_rate)
        self._parameter_list = list(parameters)
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._accumulators = {}
        self._step_count = 0

    def get_lr(self) -> float:
        return self._lr

    def _init_state(self, p):
        return {}

    def _update_param(self, p, g, state, lr):
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """Apply one update to every parameter that has a gradient."""
        lr = self.get_lr()
        self._step_count += 1
        for i, p in enumerate(self._parameter_list):
            if p.grad is None:
                continue
            if i not in self._accumulators:
                self._accumulators[i] = self._init_state(p)
            self._update_param(p, p.grad, self._accumulators[i], lr)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    def state_dict(self):
        """{"step": n, "<i>_<name>": state} for parameter position i. The
        reference keys an entry "<p.name or i>_<name>"
        (`paddle_tpu/optimizer/optimizer.py::state_dict`), and its layers'
        parameters are unnamed (`name == ''`), so its keys fall back to the
        position too: the two packages' keys agree."""
        out = {"step": self._step_count}
        for i, st in self._accumulators.items():
            for k, v in st.items():
                out[f"{i}_{k}"] = v
        return out

    def set_state_dict(self, state):
        """Restore `step` and each "<i>_<name>" entry of `state` (this
        optimizer's `state_dict`, or the reference's, its arrays as numpy
        arrays or tensors) into the state of parameter i, on the
        parameter's device and in the dtype this optimizer keeps for that
        entry. Keys of no parameter or no state entry are ignored, as the
        reference ignores them."""
        self._step_count = int(state.get("step", 0))
        for key, v in state.items():
            i, _, name = key.partition("_")
            if not i.isdigit() or int(i) >= len(self._parameter_list):
                continue
            st = self._accumulators.get(int(i))
            if st is None:
                st = self._accumulators[int(i)] = self._init_state(
                    self._parameter_list[int(i)])
            if name not in st:
                continue
            cur = st[name]
            t = v.detach() if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, copy=True))
            if isinstance(cur, torch.Tensor):
                st[name] = t.to(cur.device, cur.dtype).reshape(cur.shape) \
                    .clone()
            else:  # the f32 beta pows
                st[name] = type(cur)(t.item())


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _init_state(self, p):
        st = {
            "moment1": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device),
            "beta1_pow": np.float32(1.0),
            "beta2_pow": np.float32(1.0),
        }
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().float()
        return st

    def _decoupled_coeff(self):
        return 0.0

    def _update_param(self, p, g, state, lr):
        master = state.get("master_weight")
        work = master if master is not None else p.detach().float()
        g = g.float()
        if self._decoupled_coeff() == 0.0 and self._weight_decay:
            g = g + self._weight_decay * work
        b1p = np.float32(state["beta1_pow"] * np.float32(self._beta1))
        b2p = np.float32(state["beta2_pow"] * np.float32(self._beta2))
        m1, m2 = state["moment1"], state["moment2"]
        m1.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        m2.mul_(self._beta2).addcmul_(g, g, value=1 - self._beta2)
        coeff = self._decoupled_coeff()
        if coeff:
            work.mul_(1 - lr * coeff)
        denom = (m2 / (1 - b2p)).sqrt_().add_(self._epsilon)
        work.sub_((m1 / (1 - b1p)).mul_(lr).div_(denom))
        state["beta1_pow"], state["beta2_pow"] = b1p, b2p
        if work.data_ptr() != p.data_ptr():  # else f32 p was updated in place
            p.copy_(work)  # the cast back to p's dtype


class AdamW(Adam):
    """Adam with decoupled weight decay `weight_decay` (default 0.01),
    applied to the working copy before the update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, multi_precision)
        self._coeff = float(weight_decay)

    def _decoupled_coeff(self):
        return self._coeff
