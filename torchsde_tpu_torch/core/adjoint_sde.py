"""The adjoint SDE: its drift and diffusion are vector-Jacobian products of
the forward SDE's (counterpart of ``torchsde_tpu/core/adjoint_sde.py``).

The augmented state is the tuple ``(y, adj_y, adj_params)``, with
``adj_params`` a tuple holding one tensor per adjoint parameter (the
tensors ``core/base_sde.collect_adjoint_params`` gathers from the SDE); the
solvers step it with ``utils.misc.tree_lc``.

Sign and time conventions are the JAX package's: the backward solve runs on
negated, increasing time; the adjoint vector fields evaluate the forward
SDE at ``-t`` and negate only the state slot (``_neg_first``), the vjp
slots entering with a positive sign.

Trait map: the adjoint of an additive-noise SDE has general noise (its
diffusion is linear in ``adj_y``); diagonal, scalar and general stay
themselves. The adjoint of an Itô SDE (but additive) is integrated as the
Stratonovich SDE whose drift carries the double-Stratonovich correction
``f - sum_l (dg_l/dy) g_l``, plus the Itô-conversion vjps.

Every vjp is ``torch.autograd.grad`` over ``(y, *params)`` under
``torch.enable_grad()``, with ``create_graph`` when grad mode is on (a
double backward) and ``allow_unused``; a tensor that an output does not
read gets zeros. Each vector field is evaluated at a leaf copy of the state
(``at_leaf``), so its vjps are partial derivatives as the JAX package's
``jax.vjp`` gives them; without ``create_graph`` the outputs are detached,
so a backward sweep keeps no graph from step to step, and with it they are
spliced back onto the state.
"""

import torch

from ..settings import NOISE_TYPES, SDE_TYPES


def vjp(outputs, inputs, cotangents, create_graph, zeros=True):
    """``sum_k <outputs[k], cotangents[k]>`` differentiated with respect to
    each of ``inputs`` (a tuple); where an input is not read, zeros, or
    None without ``zeros``. The graph is retained, so several vjps may
    share it."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    if pairs:
        grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                    [c for _, c in pairs],
                                    create_graph=create_graph,
                                    retain_graph=True, allow_unused=True)
    else:
        grads = (None,) * len(inputs)
    if not zeros:
        return grads
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs))


def plus(a, b):
    """``a + b`` where None is an exact zero (a parameter slot that no
    gradient has reached)."""
    if b is None:
        return a
    return b if a is None else a + b




def jvp(output, y, tangent):
    """The Jacobian of ``output`` with respect to ``y`` along ``tangent``,
    by the double-vjp trick; differentiable again."""
    dummy = torch.zeros_like(output, requires_grad=True)
    back, = vjp((output,), (y,), (dummy,), create_graph=True)
    if not back.requires_grad:
        return torch.zeros_like(output)
    return vjp((back,), (dummy,), (tangent,), create_graph=True)[0]


class _Splice(torch.autograd.Function):
    """Identity on ``outs`` (functions of the leaves ``leaves``) that also
    hangs them on ``reals``, the tensors the leaves stand for: the gradient
    reaching ``outs`` flows on to each real by the vjp with respect to its
    leaf, and into their own graph for the rest."""

    @staticmethod
    def forward(ctx, n, *args):
        ctx.n = n
        ctx.leaves, ctx.outs = args[n:2 * n], args[2 * n:]
        return tuple(o.view_as(o) for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        with torch.enable_grad():
            to_reals = vjp(ctx.outs, ctx.leaves, grads,
                           create_graph=torch.is_grad_enabled())
        return (None, *to_reals) + (None,) * ctx.n + grads


def splice(reals, leaves, outs):
    """``outs``, computed from ``leaves`` (leaf stand-ins of ``reals``), as
    functions of ``reals`` for a further backward (``_Splice``); a None in
    ``outs`` stays None."""
    tensors = [o for o in outs if o is not None]
    spliced = iter(_Splice.apply(len(reals), *reals, *leaves, *tensors))
    return tuple(None if o is None else next(spliced) for o in outs)


def at_leaf(fn, y):
    """``fn(y_)`` at ``y`` for a ``fn`` that differentiates with respect to
    ``y_`` and the parameters: ``y_`` is a leaf copy of ``y``, so those
    are partial derivatives even where ``y`` itself depends on the
    parameters (the state of a double backward's reverse sweep). ``fn``
    returns a tuple of tensors and runs with grad mode on. Without grad
    mode the outputs come back detached; with it they are spliced onto
    ``y`` (``_Splice``), so a double backward differentiates them as
    functions of ``y`` and the parameters."""
    y_leaf = y.detach().requires_grad_(True)
    build = torch.is_grad_enabled()
    with torch.enable_grad():
        outs = fn(y_leaf)
    if not build:
        return tuple(None if o is None else o.detach() for o in outs)
    return splice((y,), (y_leaf,), outs)


def _neg_first(triple):
    """Negate only the state-like slot: the vjp components enter the
    augmented dynamics with a positive sign on the reversed clock."""
    first, vjp_y, vjp_params = triple
    return (-first, vjp_y, vjp_params)


def _triple(flat):
    return flat[0], flat[1], tuple(flat[2:])


class AdjointSDE:
    """The adjoint of ``forward_sde`` (a ``ForwardSDE``) with respect to its
    state and to ``params``, on the augmented state ``(y, adj_y,
    adj_params)``."""

    is_adjoint_sde = True

    def __init__(self, forward_sde, params):
        self.forward_sde = forward_sde
        self.params = tuple(params)
        self.sde_type = forward_sde.sde_type
        self.noise_type = {
            NOISE_TYPES.general: NOISE_TYPES.general,
            NOISE_TYPES.additive: NOISE_TYPES.general,
            NOISE_TYPES.scalar: NOISE_TYPES.scalar,
            NOISE_TYPES.diagonal: NOISE_TYPES.diagonal,
        }[forward_sde.noise_type]
        self._fwd_noise = forward_sde.noise_type
        self._corrected = (forward_sde.sde_type == SDE_TYPES.ito and
                           forward_sde.noise_type != NOISE_TYPES.additive)

    def has_method(self, name):
        return name in ("f", "g_prod", "f_and_g_prod", "g_prod_and_gdg_prod")

    def _flat_vjp(self, outputs, y, cotangents, create_graph):
        """``(vjp_y, *vjp_params)`` of :meth:`_vjp`."""
        vjp_y, vjp_params = self._vjp(outputs, y, cotangents, create_graph)
        return (vjp_y,) + tuple(vjp_params)

    def _vjp(self, outputs, y, cotangents, create_graph):
        """``(vjp_y, vjp_params)``: zeros for y where it is not read, None
        for a parameter that is not."""
        grads = vjp(outputs, (y,) + self.params, cotangents, create_graph,
                    zeros=False)
        vjp_y = torch.zeros_like(y) if grads[0] is None else grads[0]
        return vjp_y, grads[1:]

    # ------------------------------------------------------------------ #
    #  Itô corrections                                                   #
    # ------------------------------------------------------------------ #

    def _correction(self, y, g):
        """``sum_l (dg_l/dy) g_l`` at ``y`` from its diffusion ``g``,
        differentiable again: for diagonal noise one vjp of g with
        cotangent g, else per noise column the jvp of that column along
        it."""
        if self._fwd_noise == NOISE_TYPES.diagonal:
            return vjp((g,), (y,), (g,), create_graph=True)[0]
        total = torch.zeros_like(y)
        for col in range(g.shape[-1]):
            total = total + jvp(g[..., col], y, g[..., col])
        return total

    def _ito_conversion_cotangent(self, y, g, adj_y, create_graph):
        """The cotangent of g whose vjp over ``(y, params)`` is the term
        that turns the adjoint Stratonovich SDE into Itô form: the vjp of
        g in y with cotangent adj_y, per noise column for scalar and
        general noise (stacked over the columns: by the linearity of vjps
        in the cotangent, one vjp of g with it sums the columns')."""
        if self._fwd_noise == NOISE_TYPES.diagonal:
            return vjp((g,), (y,), (adj_y,), create_graph)[0]
        return torch.stack([vjp((g[..., col],), (y,), (adj_y,),
                                create_graph)[0]
                            for col in range(g.shape[-1])], dim=-1)

    # ------------------------------------------------------------------ #
    #  Capability interface on the augmented state                       #
    # ------------------------------------------------------------------ #

    def f(self, t, y_aug):
        y, adj_y, _ = y_aug
        sde = self.forward_sde
        create_graph = torch.is_grad_enabled()

        def fn(y):
            drift = sde.f(-t, y)
            if not self._corrected:
                return (drift,) + self._flat_vjp((drift,), y, (adj_y,),
                                                 create_graph)
            # The drift's vjp, then the Itô-conversion term's, added: the
            # JAX package's order of the sums (two passes; one pass over
            # both outputs sums their terms in another order, which bf16
            # rounds apart).
            g = sde.g(-t, y)
            drift = drift - self._correction(y, g)
            vjp_y, vjp_params = self._vjp((drift,), y, (adj_y,),
                                          create_graph)
            extra_y, extra_params = self._vjp(
                (g,), y, (self._ito_conversion_cotangent(
                    y, g, adj_y, create_graph),), create_graph)
            return (drift, vjp_y + extra_y) + tuple(
                plus(a, b) for a, b in zip(vjp_params, extra_params))

        return _neg_first(_triple(at_leaf(fn, y)))

    def g_prod(self, t, y_aug, v):
        y, adj_y, _ = y_aug
        create_graph = torch.is_grad_enabled()

        def fn(y):
            g_prod = self.forward_sde.g_prod(-t, y, v)
            vjp_y, vjp_params = self._vjp((g_prod,), y, (adj_y,),
                                          create_graph)
            return (g_prod, vjp_y) + vjp_params

        return _neg_first(_triple(at_leaf(fn, y)))

    def f_and_g_prod(self, t, y_aug, v):
        return self.f(t, y_aug), self.g_prod(t, y_aug, v)

    def g_prod_and_gdg_prod(self, t, y_aug, v1, v2):
        """The adjoint Milstein correction pair, diagonal noise only."""
        if self._fwd_noise != NOISE_TYPES.diagonal:
            raise NotImplementedError(
                "Adjoint Milstein is only available for diagonal-noise "
                "forward SDEs.")
        y, adj_y, _ = y_aug
        sde = self.forward_sde
        create_graph = torch.is_grad_enabled()

        def fn(y):
            g = sde.g(-t, y)
            # g_prod = g v1 from the same g: its vjp is g's with adj_y v1.
            g_prod_y, g_prod_params = self._vjp((g,), y, (adj_y * v1,),
                                                create_graph)
            return ((g * v1, g_prod_y) + g_prod_params
                    + self._gdg_terms(g, y, adj_y, v2, create_graph))

        flat = at_leaf(fn, y)
        n = 2 + len(self.params)
        return (_neg_first(_triple(flat[:n])), _triple(flat[n:]))

    def _gdg_terms(self, g, y, adj_y, v2, create_graph):
        """The Milstein correction's slots ``(vg_dg, vjp_y, *vjp_params)``
        from the diffusion g at y."""
        # The forward Milstein bracket: the vjp of g with cotangent v2 g.
        vg_dg, = vjp((g,), (y,), (v2 * g,), create_graph)
        # The product-partials term, the vjp over (y, params) with
        # cotangent adj_y v2 dg/dy (dg/dy the vjp of g with ones), less
        # the mixed-partials term, the gradient over (y, params) of
        # sum(vjp of g with the cotangent adj_y v2 g held constant): one
        # pass over both, the second with cotangent -1.
        dgdy, = vjp((g,), (y,), (torch.ones_like(g),), create_graph)
        ct = (adj_y * v2 * g).detach()
        inner = vjp((g,), (y,), (ct,), create_graph=True)[0].sum()
        vjp_y, vjp_params = self._vjp(
            (g, inner), y, (adj_y * v2 * dgdy, -torch.ones_like(inner)),
            create_graph)
        return (vg_dg, vjp_y) + vjp_params
