"""SDE base classes and the capability-dispatch wrappers (counterpart of
``torchsde_tpu/core/base_sde.py``).

Which user spellings (``f``/``g``/``f_and_g``/``g_prod``/``f_and_g_prod``)
an SDE provides is resolved once, when ``ForwardSDE`` wraps it.
"""

import torch
from torch import nn

from ..settings import NOISE_TYPES, SDE_TYPES
from ..utils import misc


class BaseSDE(nn.Module):
    """Base class for all SDEs; validates the noise/sde trait strings."""

    def __init__(self, noise_type, sde_type):
        super().__init__()
        if noise_type not in NOISE_TYPES:
            raise ValueError(f"Expected noise type in {NOISE_TYPES}, but found {noise_type}")
        if sde_type not in SDE_TYPES:
            raise ValueError(f"Expected sde type in {SDE_TYPES}, but found {sde_type}")
        self.noise_type = noise_type
        self.sde_type = sde_type


class SDEIto(BaseSDE):
    def __init__(self, noise_type):
        super().__init__(noise_type=noise_type, sde_type=SDE_TYPES.ito)


class SDEStratonovich(BaseSDE):
    def __init__(self, noise_type):
        super().__init__(noise_type=noise_type,
                         sde_type=SDE_TYPES.stratonovich)


_CAPABILITIES = ("f", "g", "h", "f_and_g", "g_prod", "f_and_g_prod")


def sde_has_method(sde, name):
    """Does `sde` provide capability `name`? Wrappers may override via
    a `has_method` hook so renamed/augmented methods report correctly."""
    hook = getattr(type(sde), "has_method", None)
    if hook is not None:
        return sde.has_method(name)
    return callable(getattr(sde, name, None))


class RenameMethodsSDE(BaseSDE):
    """Adapter for SDEs whose drift/diffusion live under different method
    names (``sdeint(..., names={"drift": "h"})``)."""

    def __init__(self, sde, drift="f", diffusion="g", prior_drift="h",
                 diffusion_prod="g_prod", drift_and_diffusion="f_and_g",
                 drift_and_diffusion_prod="f_and_g_prod"):
        super().__init__(noise_type=sde.noise_type, sde_type=sde.sde_type)
        self._base_sde = sde
        self._name_map = {"f": drift, "g": diffusion, "h": prior_drift,
                          "g_prod": diffusion_prod,
                          "f_and_g": drift_and_diffusion,
                          "f_and_g_prod": drift_and_diffusion_prod}

    def _target(self, name):
        return self._name_map.get(name, name)

    def has_method(self, name):
        return sde_has_method(self._base_sde, self._target(name))

    def f(self, t, y):
        return getattr(self._base_sde, self._target("f"))(t, y)

    def g(self, t, y):
        return getattr(self._base_sde, self._target("g"))(t, y)

    def h(self, t, y):
        return getattr(self._base_sde, self._target("h"))(t, y)

    def g_prod(self, t, y, v):
        return getattr(self._base_sde, self._target("g_prod"))(t, y, v)

    def f_and_g(self, t, y):
        return getattr(self._base_sde, self._target("f_and_g"))(t, y)

    def f_and_g_prod(self, t, y, v):
        return getattr(self._base_sde, self._target("f_and_g_prod"))(t, y, v)


class ForwardSDE(BaseSDE):
    """Capability-complete view of a user SDE: exposes ``f``, ``g``, ``h``,
    ``f_and_g``, ``prod``, ``g_prod`` and ``f_and_g_prod`` whichever subset
    the user defined."""

    def __init__(self, sde):
        super().__init__(noise_type=sde.noise_type, sde_type=sde.sde_type)
        self._base_sde = sde
        self._has = tuple(name for name in _CAPABILITIES
                          if sde_has_method(sde, name))

    def has_method(self, name):
        return True  # ForwardSDE synthesises every capability.

    def f(self, t, y):
        if "f" in self._has:
            return self._base_sde.f(t, y)
        if "f_and_g" in self._has:
            return self._base_sde.f_and_g(t, y)[0]
        raise RuntimeError("Method `f` has not been provided, but is required "
                           "for this method.")

    def g(self, t, y):
        if "g" in self._has:
            return self._base_sde.g(t, y)
        if "f_and_g" in self._has:
            return self._base_sde.f_and_g(t, y)[1]
        raise RuntimeError("Method `g` has not been provided, but is required "
                           "for this method.")

    def h(self, t, y):
        if "h" in self._has:
            return self._base_sde.h(t, y)
        raise RuntimeError("Method `h` has not been provided, but is required "
                           "for this method.")

    def f_and_g(self, t, y):
        if "f_and_g" in self._has:
            return self._base_sde.f_and_g(t, y)
        return self.f(t, y), self.g(t, y)

    def prod(self, g, v):
        """Diffusion-vector product given a materialised diffusion."""
        if self.noise_type == NOISE_TYPES.diagonal:
            return g * v
        return misc.batch_mvp(g, v)

    def g_prod(self, t, y, v):
        if "g_prod" in self._has:
            return self._base_sde.g_prod(t, y, v)
        return self.prod(self.g(t, y), v)

    def f_and_g_prod(self, t, y, v):
        if "f_and_g_prod" in self._has:
            return self._base_sde.f_and_g_prod(t, y, v)
        if "f" in self._has and "g_prod" in self._has:
            return self._base_sde.f(t, y), self._base_sde.g_prod(t, y, v)
        f, g = self.f_and_g(t, y)
        return f, self.prod(g, v)

    # -- derivative-based capabilities ----------------------------------- #
    # The derivatives come from torch.autograd.grad on a ``y`` that requires
    # grad (a detached copy where ``y`` does not); their graph is kept
    # (create_graph) when grad mode is on, so a solve differentiated
    # through its steps differentiates these terms too.

    def g_prod_and_gdg_prod(self, t, y, v1, v2):
        """Returns ``(g @ v1, sum_{j,l} g_{jl} dg_{jl}/dy_i v2_l)``, the
        Milstein correction pair."""
        if self.noise_type == NOISE_TYPES.additive:
            return self.g_prod(t, y, v1), 0.0
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            y = y if y.requires_grad else y.detach().requires_grad_(True)
            g = self.g(t, y)
            if self.noise_type == NOISE_TYPES.diagonal:
                cotangent = g * v2
            else:  # scalar (and general): broadcast v2 over the columns
                cotangent = g * v2[..., None, :]
            vg_dg_vjp, = torch.autograd.grad(g, y, cotangent,
                                             create_graph=create_graph,
                                             allow_unused=True)
        if vg_dg_vjp is None:        # g does not depend on y
            vg_dg_vjp = torch.zeros_like(y)
        return self.prod(g, v1), vg_dg_vjp

    def dg_ga_jvp_column_sum(self, t, y, a):
        """The log-ODE Levy-area correction
        ``sum_{j,k,l} (dg_{il}/dy_j) g_{jk} A_{kl}`` (general noise; zero
        otherwise): for each noise column l, the Jacobian-vector product of
        that column of g along column l of ``g A``, by a double vjp."""
        if self.noise_type != NOISE_TYPES.general:
            return 0.0
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            y = y if y.requires_grad else y.detach().requires_grad_(True)
            g = self.g(t, y)
            ga = torch.einsum("...dm,...mk->...dk", g, a)
            total = torch.zeros_like(y)
            for col in range(g.shape[-1]):
                g_col = g[..., col]
                dummy = torch.zeros_like(g_col, requires_grad=True)
                vjp, = torch.autograd.grad(g_col, y, dummy, create_graph=True,
                                           allow_unused=True)
                if vjp is None:
                    continue
                jvp, = torch.autograd.grad(vjp, dummy, ga[..., col],
                                           retain_graph=True,
                                           create_graph=create_graph,
                                           allow_unused=True)
                if jvp is not None:
                    total = total + jvp
        return total


class SDELogqp(BaseSDE):
    """Augments the state with one channel integrating the KL between the
    posterior (drift ``f``) and prior (drift ``h``) path measures:
    ``u = g^{-1}(f - h)``, KL integrand ``0.5 |u|^2``."""

    def __init__(self, sde):
        super().__init__(noise_type=sde.noise_type, sde_type=sde.sde_type)
        for name in ("f", "g", "h"):
            if not sde_has_method(sde, name):
                raise AttributeError("If using logqp then drift, diffusion and "
                                     "prior drift must all be specified.")
        self._base_sde = sde

    def has_method(self, name):
        return name in ("f", "g", "f_and_g")

    def _f_g_h(self, t, y):
        # An SDE may provide `f_and_h(t, y) -> (f, h)` that shares work
        # between the two drifts (LatentSDE shares the context lookup).
        f_and_h = getattr(self._base_sde, "f_and_h", None)
        if callable(f_and_h):
            f, h = f_and_h(t, y)
        else:
            f, h = self._base_sde.f(t, y), self._base_sde.h(t, y)
        return f, self._base_sde.g(t, y), h

    def f_and_g(self, t, y):
        y = y[:, :-1]
        f, g, h = self._f_g_h(t, y)
        if self.noise_type == NOISE_TYPES.diagonal:
            u = misc.stable_division(f - h, g)
            g_logqp = y.new_zeros((y.shape[0], 1))
        else:
            u = misc.batch_mvp(torch.linalg.pinv(g), f - h)
            g_logqp = y.new_zeros((g.shape[0], 1, g.shape[-1]))
        f_logqp = 0.5 * torch.sum(u * u, dim=1, keepdim=True)
        return torch.cat([f, f_logqp], dim=1), torch.cat([g, g_logqp], dim=1)

    def f(self, t, y):
        return self.f_and_g(t, y)[0]

    def g(self, t, y):
        y_ = y[:, :-1]
        g = self._base_sde.g(t, y_)
        if self.noise_type == NOISE_TYPES.diagonal:
            g_logqp = y_.new_zeros((y_.shape[0], 1))
        else:
            g_logqp = y_.new_zeros((g.shape[0], 1, g.shape[-1]))
        return torch.cat([g, g_logqp], dim=1)


def collect_adjoint_params(sde):
    """Every floating tensor requiring grad that ``sde`` holds, each once by
    identity, in a fixed order: the parameters, buffers and plain tensor
    attributes of every module reached from it (through the ``ForwardSDE``,
    ``SDELogqp`` and ``RenameMethodsSDE`` wrappers, and through lists,
    tuples and dicts), and those of an SDE object that is not a module."""
    return adjoint_param_slots(sde)[0]


def adjoint_param_slots(sde):
    """``(tensors, slots)``: the adjoint parameters, and for each of them
    that is not a leaf (a context or a path computed upstream) its index
    and the ``(container, key)`` that holds it, where the backward puts a
    leaf stand-in (``leaf_stand_ins``)."""
    found, slots, seen = [], [], set()

    def visit(obj, container=None, key=None):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if torch.is_tensor(obj):
            if obj.is_floating_point() and obj.requires_grad:
                if not obj.is_leaf:
                    if not isinstance(container, (dict, list)):
                        raise ValueError(
                            "sdeint_adjoint differentiates a tensor the SDE "
                            "computes upstream only where a module attribute, "
                            "a buffer, a list or a dict holds it, not a tuple")
                    slots.append((len(found), container, key))
                found.append(obj)
        elif isinstance(obj, (list, tuple)):
            for i, item in enumerate(obj):
                visit(item, obj, i)
        elif isinstance(obj, dict):
            for k, item in obj.items():
                visit(item, obj, k)
        elif isinstance(obj, nn.Module) or hasattr(obj, "noise_type"):
            visit(vars(obj))

    visit(sde)
    return tuple(found), slots
