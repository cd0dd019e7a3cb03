"""A client `torch.optim.Optimizer` behind the engine's functional
protocol — the port's counterpart of deepspeed_tpu/runtime/optax_adapter.py
(the reference's torch.optim passthrough, engine.py:702-757).

    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, optimizer=opt,
                                                config_params=cfg)

`TorchOptimizer` gives the wrapped optimizer `init(params)` /
`update(grads, state, params, lr=)`, the `param_groups` the LR schedulers
write (the wrapped optimizer's own), and `state_dict` /
`load_state_dict` for its hyperparameters.  The optimizer is re-pointed
at work tensors of the engine's (owned) masters' shapes: an update copies
the masters in, sets the gradients, loads copies of the functional
state into `optimizer.state`, runs `optimizer.step()` and hands the work
tensors and the stepped state back, so the engine's branchless overflow
skip keeps the old masters and state.  For Adam, AdamW and SGD the
state exists from `init` (zeros, step 0: what the first step would
create); for another class it comes into being at the first step, and an
overflow at that step is not rolled back.  On the card Adam and AdamW run
`capturable`, their step counts on the device (no host sync).

The config's `"optax:<name>"` (JAX's optax passthrough) maps onto the
`torch.optim` class with the same update rule, `adam`, `adamw` or `sgd`,
with optax's parameter names and defaults (adamw's weight decay 1e-4).
Checkpoints of these three carry their state as JAX's OptaxOptimizer
writes it, `{"__optax_leaves__": [...]}` in the leaf order of
`{"_base_lr", "optax": inject_hyperparams(...)}`, so tags cross both
engines; the functional state keeps optax's update `count` beside the
torch state for that.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

OPTAX_NAMES = ("adam", "adamw", "sgd")

# optax's defaults for the names above (optax/_src/alias.py)
_OPTAX_DEFAULTS = {
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                  weight_decay=1e-4),
    "sgd": dict(momentum=None, nesterov=False),
}


def kind_of(optimizer) -> Optional[str]:
    """"adam", "adamw" or "sgd" for those torch.optim classes (their
    JAX-tag layout), else None."""
    for cls, kind in ((torch.optim.AdamW, "adamw"),
                      (torch.optim.Adam, "adam"),
                      (torch.optim.SGD, "sgd")):
        if type(optimizer) is cls:
            return kind
    return None


def from_optax_name(name: str, params: Dict) -> "TorchOptimizer":
    """The config's "optax:<name>" with optax's keyword names (lr or
    learning_rate, b1, b2, eps, eps_root, weight_decay, momentum,
    nesterov) -> the TorchOptimizer of the matching torch.optim class
    (its parameters bound at the engine's `init`)."""
    fn = name.split(":", 1)[1]
    if fn not in OPTAX_NAMES:
        raise ValueError(
            f"optimizer {name!r}: the port maps optax:<name> onto the "
            f"torch.optim class with the same update rule, one of "
            f"{['optax:' + n for n in OPTAX_NAMES]}")
    kw = dict(params)
    lr = kw.pop("lr", kw.pop("learning_rate", 1e-3))
    hp = dict(_OPTAX_DEFAULTS[fn])
    unknown = set(kw) - set(hp)
    if unknown:
        raise ValueError(f"optimizer {name!r}: unknown parameter(s) "
                         f"{sorted(unknown)}; expected {sorted(hp)}")
    hp.update(kw)
    if fn in ("adam", "adamw"):
        if hp["eps_root"]:
            raise ValueError(f"{name!r}: eps_root has no torch.optim "
                             f"counterpart; it must be 0")
        args = dict(lr=lr, betas=(hp["b1"], hp["b2"]), eps=hp["eps"])
        if fn == "adamw":
            args["weight_decay"] = hp["weight_decay"]
            make = lambda ps: torch.optim.AdamW(ps, **args)  # noqa: E731
        else:
            make = lambda ps: torch.optim.Adam(ps, **args)  # noqa: E731
    else:
        mom = hp["momentum"]
        args = dict(lr=lr, momentum=float(mom or 0.0),
                    nesterov=bool(hp["nesterov"]))
        make = lambda ps: torch.optim.SGD(ps, **args)  # noqa: E731
    return TorchOptimizer(None, kind=fn, factory=make,
                          momentum_hyper=fn == "sgd" and hp["momentum"]
                          is not None)


class TorchOptimizer:
    name = "TorchOptimizer"

    def __init__(self, optimizer: Optional[torch.optim.Optimizer] = None,
                 kind: Optional[str] = None, factory=None,
                 momentum_hyper: Optional[bool] = None):
        """`optimizer`: a client torch.optim.Optimizer over the module's
        parameters (or None with `factory`, which builds one over the
        work tensors at `init`)."""
        if optimizer is None and factory is None:
            raise ValueError("TorchOptimizer needs an optimizer or a factory")
        self.optimizer = optimizer
        self.kind = kind if kind is not None else kind_of(optimizer)
        self._factory = factory
        self._masters = None
        self._work: List[torch.Tensor] = []
        if momentum_hyper is None and self.kind == "sgd":
            momentum_hyper = bool(optimizer.param_groups[0]["momentum"])
        self._momentum_hyper = bool(momentum_hyper)
        groups = optimizer.param_groups if optimizer is not None else None
        self._base_lr = float(groups[0]["lr"]) if groups else None

    # -- the surface the engine and the schedulers read -----------------

    @property
    def param_groups(self):
        if self.optimizer is None:
            raise RuntimeError("TorchOptimizer: param_groups exist once the "
                               "engine has bound the parameters (init)")
        return self.optimizer.param_groups

    @property
    def lr(self):
        return self.param_groups[0]["lr"]

    def bind(self, masters):
        """The engine's masters (the module's parameters, in its order):
        a client optimizer's parameters are found among them by
        identity."""
        self._masters = list(masters)

    def init(self, params):
        dev = params[0].device
        self._work = [torch.zeros_like(p, dtype=torch.float32)
                      for p in params]
        if self.optimizer is None:
            self.optimizer = self._factory(self._work)
            self._base_lr = float(self.optimizer.param_groups[0]["lr"])
        else:
            self._retarget()
        if dev.type == "cuda" and self.kind in ("adam", "adamw"):
            for g in self.optimizer.param_groups:
                g["capturable"] = True
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.kind in ("adam", "adamw"):
            state["step"] = [torch.zeros((), dtype=torch.float32,
                                         device=dev if dev.type == "cuda"
                                         else "cpu") for _ in params]
            state["exp_avg"] = [torch.zeros_like(w) for w in self._work]
            state["exp_avg_sq"] = [torch.zeros_like(w) for w in self._work]
        elif self.kind == "sgd" and self._momentum_hyper:
            state["momentum_buffer"] = [torch.zeros_like(w)
                                        for w in self._work]
        return state

    def _retarget(self):
        """Point the client optimizer's parameter slots at the work
        tensors (every engine parameter must be in it exactly once)."""
        if self._masters is None:
            raise RuntimeError("TorchOptimizer.init before bind(masters)")
        pos = {id(p): i for i, p in enumerate(self._masters)}
        seen = set()
        for g in self.optimizer.param_groups:
            new = []
            for p in g["params"]:
                i = pos.get(id(p))
                if i is None or i in seen:
                    raise ValueError(
                        "the client optimizer's parameters must be the "
                        "module's parameters handed to initialize(), each "
                        "once")
                seen.add(i)
                new.append(self._work[i])
                if p in self.optimizer.state:
                    self.optimizer.state[self._work[i]] = \
                        self.optimizer.state.pop(p)
            g["params"] = new
        if len(seen) != len(self._masters):
            raise ValueError(
                f"the client optimizer holds {len(seen)} of the module's "
                f"{len(self._masters)} parameters; the engine updates "
                f"every parameter through it")

    def update(self, grads, state, params, lr=None, **_):
        opt = self.optimizer
        if lr is not None and len(opt.param_groups) == 1:
            opt.param_groups[0]["lr"] = float(lr)
        for w, p, g in zip(self._work, params, grads):
            w.copy_(p)
            w.grad = g.to(torch.float32)
        keys = [k for k in state if k != "count"]
        for k in keys:
            for w, t in zip(self._work, state[k]):
                opt.state[w][k] = t.clone()
        opt.step()
        new_state = {"count": state["count"] + 1}
        if keys:
            new_state.update({k: [opt.state[w][k] for w in self._work]
                              for k in keys})
        else:
            # a class whose state the first step creates
            found = sorted({k for w in self._work
                            for k, v in opt.state[w].items()
                            if torch.is_tensor(v)})
            new_state.update({k: [opt.state[w][k] for w in self._work]
                              for k in found})
        for w in self._work:
            w.grad = None
        return list(self._work), new_state

    # -- hyperparameters (checkpoint "optimizer_hparams") ---------------

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups]}

    def load_state_dict(self, sd):
        for g, saved in zip(self.param_groups, sd.get("param_groups") or []):
            for k, v in saved.items():
                if k in g and k != "params":
                    g[k] = tuple(v) if k == "betas" else v

    # -- optimizer state in JAX's OptaxOptimizer tag layout ---------------

    def _hyper(self):
        """inject_hyperparams' numeric hyperparameters, sorted by name."""
        g = self.param_groups[0]
        if self.kind in ("adam", "adamw"):
            hp = {"b1": g["betas"][0], "b2": g["betas"][1], "eps": g["eps"],
                  "eps_root": 0.0, "learning_rate": g["lr"]}
            if self.kind == "adamw":
                hp["weight_decay"] = g["weight_decay"]
        else:
            hp = {"learning_rate": g["lr"]}
            if self._momentum_hyper:
                hp["momentum"] = g["momentum"]
        return [hp[k] for k in sorted(hp)]

    def serialize_state(self, state, order):
        """The functional state -> {"__optax_leaves__": [...]}, the leaves
        of JAX's `{"_base_lr", "optax": InjectHyperparamsState}` (its
        moment trees in `order`, the JAX tree's leaf order)."""
        if self.kind is None:
            raise NotImplementedError(
                f"{type(self.optimizer).__name__}: only Adam, AdamW and SGD "
                f"states have a JAX tag layout (optax:adam|adamw|sgd)")
        f32 = lambda v: np.asarray(float(v), np.float32)  # noqa: E731
        count = np.asarray(int(state["count"]), np.int32)
        leaves = [f32(self._base_lr), count] + [f32(v) for v in
                                                self._hyper()]
        if self.kind in ("adam", "adamw"):
            leaves.append(count)
            leaves += [state["exp_avg"][i] for i in order]
            leaves += [state["exp_avg_sq"][i] for i in order]
        elif self._momentum_hyper:
            leaves += [state["momentum_buffer"][i] for i in order]
        return {"__optax_leaves__": leaves}

    def deserialize_state(self, payload, like, order):
        """Inverse of `serialize_state` into tensors shaped and placed as
        the functional state `like`."""
        leaves = list(payload["__optax_leaves__"])
        n_hyper = len(self._hyper())
        n = len(order)

        def as_like(v, t):
            v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            return v.to(device=t.device, dtype=t.dtype).reshape(t.shape)

        count = int(np.asarray(leaves[1]))
        out = {"count": torch.full_like(like["count"], count)}
        rest = leaves[2 + n_hyper:]
        if self.kind in ("adam", "adamw"):
            rest = rest[1:]    # the inner ScaleByAdamState's count
            mu, nu = rest[:n], rest[n:2 * n]
            out["step"] = [torch.full_like(s, count) for s in like["step"]]
            out["exp_avg"] = [None] * n
            out["exp_avg_sq"] = [None] * n
            for j, i in enumerate(order):
                out["exp_avg"][i] = as_like(mu[j], like["exp_avg"][i])
                out["exp_avg_sq"][i] = as_like(nu[j], like["exp_avg_sq"][i])
        elif self._momentum_hyper:
            out["momentum_buffer"] = [None] * n
            for j, i in enumerate(order):
                out["momentum_buffer"][i] = as_like(
                    rest[j], like["momentum_buffer"][i])
        if len(leaves) != 2 + n_hyper + (
                (1 + 2 * n) if self.kind in ("adam", "adamw")
                else n if self._momentum_hyper else 0):
            raise ValueError(
                f"a tag's optax state of {len(leaves)} leaves does not "
                f"match optax:{self.kind} over {n} parameters")
        return out
