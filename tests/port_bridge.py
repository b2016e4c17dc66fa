"""Helpers shared by the tests that hold torchsde_tpu_torch against
torchsde_tpu: export a JAX module's leaves by dotted name, build the same
model in both packages, make and compare MLP towers, and the unsplit loops
the split backward kernels' plain versions are held to. JAX is imported
only by the helpers that read JAX modules, so that the GPU tests, on a
machine without JAX, can import the rest."""

import numpy as np
import torch

from torchsde_tpu_torch.utils.convert import as_tensor, load_jax_params


def jax_named_arrays(tree):
    """``{dotted pytree path: numpy array}`` for every leaf of a JAX
    ``Module`` tree, from ``jax.tree_util.tree_flatten_with_path``. A module
    flattens to an index into its dynamic attribute names, which this maps
    back to the name."""
    import jax
    from torchsde_tpu.utils.module import Module, _flatten_module
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node, names = tree, []
        for entry in path:
            if isinstance(node, Module):
                dyn_names = _flatten_module(node)[1][0]
                name = dyn_names[entry.key]
                node = getattr(node, name)
            else:
                name = str(entry.idx)
                node = node[entry.idx]
            names.append(name)
        out[".".join(names)] = np.asarray(leaf)
    return out


def perturbed(tree, seed, scale=0.1):
    """``tree`` with every leaf moved by ``scale`` times a standard normal,
    so that no weight the tests compare keeps its zero initialisation."""
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        leaf + scale * rng.standard_normal(leaf.shape).astype(leaf.dtype)
        for leaf in leaves])


def to_torch(a):
    return as_tensor(a)


def port_latent_sde(jax_model, dtype):
    """A torchsde_tpu_torch LatentSDE holding ``jax_model``'s weights."""
    from torchsde_tpu_torch.models.latent_sde import LatentSDE
    enc = jax_model.encoder.cell
    m = LatentSDE(enc.w_ih.shape[0], jax_model.latent_size,
                  jax_model.context_size, enc.hidden_size, dtype=dtype,
                  device="cpu")
    return load_jax_params(m, jax_named_arrays(jax_model))


def port_generator(jax_gen, dtype):
    """A torchsde_tpu_torch SDE-GAN Generator holding ``jax_gen``'s
    weights."""
    from torchsde_tpu_torch.models.sde_gan import Generator
    func = jax_gen.func
    drift = func.drift.layers
    m = Generator(jax_gen.readout.w.shape[1], jax_gen.initial_noise_size,
                  func.noise_size, func.hidden_size, drift[0].w.shape[1],
                  len(drift) - 1, dtype=dtype, device="cpu")
    return load_jax_params(m, jax_named_arrays(jax_gen))


def port_unet(jax_unet, dtype):
    """A torchsde_tpu_torch UNet holding ``jax_unet``'s weights (its widths
    read from them: ``conv_in.w`` is (3, 3, in_ch, base_ch), each down
    block's ``conv1.w`` ends in base_ch times its multiplier)."""
    from torchsde_tpu_torch.models.unet import UNet
    base = jax_unet.base_ch
    ch_mults = tuple(blk.conv1.w.shape[-1] // base
                     for blk in jax_unet.down_blocks)
    m = UNet(jax_unet.conv_in.w.shape[2], base, ch_mults, dtype=dtype,
             device="cpu")
    return load_jax_params(m, jax_named_arrays(jax_unet))


def seeded_leaves(shapes, seed):
    """A JAX module of the structure ``shapes`` (a ``jax.eval_shape`` of its
    constructor, which compiles nothing, where constructing it eagerly
    compiles every random draw) holding seeded numpy weights: norm scales
    1 + 0.1 N, other vectors 0.1 N, arrays U(-s, s) with s = 1/sqrt(the
    product of all but the last dimension)."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    leaves = []
    for name, leaf in zip(jax_named_arrays(shapes),
                          jax.tree_util.tree_leaves(shapes)):
        if name.endswith("scale"):
            value = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) == 1:
            value = 0.1 * rng.standard_normal(leaf.shape)
        else:
            s = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            value = rng.uniform(-s, s, leaf.shape)
        leaves.append(jnp.asarray(value, leaf.dtype))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), leaves)


def jax_unet(ch_mults, base_ch=8, seed=5):
    """A float64 JAX U-Net of this structure holding seeded weights
    (:func:`seeded_leaves`)."""
    import functools
    import jax
    import jax.numpy as jnp
    from torchsde_tpu.models import unet as JU
    return seeded_leaves(jax.eval_shape(functools.partial(
        JU.UNet, in_ch=1, base_ch=base_ch, ch_mults=ch_mults,
        dtype=jnp.float64), jax.random.PRNGKey(4)), seed)


def port_score_sde(jax_sde, dtype):
    """A torchsde_tpu_torch ScoreMatchingSDE around a U-Net like
    ``jax_sde``'s, its weights carried across from the JAX ScoreMatchingSDE
    as a whole (``denoiser.*``)."""
    from torchsde_tpu_torch.models.cont_ddpm import ScoreMatchingSDE
    m = ScoreMatchingSDE(port_unet(jax_sde.denoiser, dtype),
                         jax_sde.input_size, jax_sde.t0, jax_sde.t1,
                         jax_sde.beta_min, jax_sde.beta_max)
    return load_jax_params(m, jax_named_arrays(jax_sde))


# The critic CDE's control path: per-batch data that the JAX module carries
# as leaves and the port keeps outside the module's state.
CDE_PATH_KEYS = ("func._path_ts", "func._path_ys")


def port_discriminator(jax_disc, dtype):
    """A torchsde_tpu_torch SDE-GAN Discriminator holding ``jax_disc``'s
    weights (its control-path leaves are dropped)."""
    from torchsde_tpu_torch.models.sde_gan import Discriminator
    layers = jax_disc.func.func.layers
    m = Discriminator(jax_disc.func.data_size, jax_disc.func.hidden_size,
                      layers[0].w.shape[1], len(layers) - 1, dtype=dtype,
                      device="cpu")
    arrays = jax_named_arrays(jax_disc)
    for key in CDE_PATH_KEYS:
        del arrays[key]
    return load_jax_params(m, arrays)


def tower_triples(rng, sizes, acts, scale=0.3, dtype=np.float32):
    """A tower's ``(W, b, act)`` of numpy arrays: normal weights times
    scale/sqrt(fan_in), small normal biases."""
    return [((rng.standard_normal((a, b)) * (scale / np.sqrt(a))
              ).astype(dtype),
             (0.05 * rng.standard_normal(b)).astype(dtype), act)
            for (a, b), act in zip(zip(sizes[:-1], sizes[1:]), acts)]


def unpad_tower_grads(padded, triples):
    """The Pallas kernels' padded weight gradients, cut to the towers'
    shapes: (128,128) -> (in, out), (1,128) -> (out,)."""
    out = []
    for (w, _, _), dw, db in zip(triples, padded[::2], padded[1::2]):
        out += [np.asarray(dw)[:w.shape[0], :w.shape[1]],
                np.asarray(db)[0, :w.shape[1]]]
    return out


def port_tower_grads(flat, triples):
    """The port's flat pack gradient as ``[dW0, db0, dW1, ...]``."""
    from torchsde_tpu_torch.ops.fused_solve import unpack
    shapes = tuple((w.shape[0], w.shape[1], a) for w, _, a in triples)
    return [t for wb in unpack(flat, shapes) for t in wb]


def unsplit_latent_backward(z0, ctx, ctx_idx, noise, dts, weights, zs, gz,
                            gq):
    """Kernel 2's function as one loop of PyTorch operators, every weight
    gradient summed step by step: the form of
    ``latent_fused.fused_solve_backward_plain`` before its split into a
    sweep and a contraction, kept as the reference the split is held to."""
    from torchsde_tpu_torch.ops import latent_fused as TLF

    fw, hw = weights[0:6], weights[6:12]
    gw1, gb1, gw2, gb2 = weights[12:16]
    L = z0.shape[1]
    idx = ctx_idx.long()
    z_pre = torch.cat([z0[None], zs[:-1]])
    ginc = gq.flip(0).cumsum(0).flip(0)
    dz = torch.zeros_like(z0)
    dctx = torch.zeros_like(ctx)
    dnoise = torch.empty_like(noise)
    dw = [torch.zeros_like(w) for w in weights]

    def mlp_backward(x, a1, a2, tower, dout):
        w1, _, w2, _, w3, _ = tower
        dpre2 = (dout @ w3.T) * (1 - torch.exp(-a2))
        dpre1 = (dpre2 @ w2.T) * (1 - torch.exp(-a1))
        return dpre1 @ w1.T, (x.T @ dpre1, dpre1.sum(0), a1.T @ dpre2,
                              dpre2.sum(0), a2.T @ dout, dout.sum(0))

    for s in reversed(range(noise.shape[0])):
        z, dt = z_pre[s], dts[s]
        x = torch.cat([z, ctx[idx[s]]], dim=1)
        a1f, a2f, f = TLF._mlp3(x, *fw)
        a1h, a2h, h = TLF._mlp3(z, *hw)
        a1g, g = TLF._g_nets(z, gw1, gb1, gw2, gb2)
        big = g > TLF._EPS
        gs = torch.where(big, g, TLF._EPS)
        u = (f - h) / gs
        dz = dz + gz[s]
        dnoise[s] = dz * g
        du = ginc[s] * u * dt
        df = dz * dt + du / gs
        dh = -du / gs
        dg = dz * noise[s] - (du * u / gs) * big.to(z.dtype)
        dx, f_grads = mlp_backward(x, a1f, a2f, fw, df)
        dzh, h_grads = mlp_backward(z, a1h, a2h, hw, dh)
        dpre2g = dg * g * (1 - g)
        dpre1g = (dpre2g.T[..., None] * gw2[:, None, :, 0]
                  * (1 - torch.exp(-a1g)))
        g_grads = (torch.einsum("lbh,lb->lh", dpre1g, z.T)[:, None, :],
                   dpre1g.sum(1),
                   torch.einsum("lbh,bl->lh", a1g, dpre2g)[..., None],
                   dpre2g.sum(0)[:, None])
        for acc, d in zip(dw, f_grads + h_grads + g_grads):
            acc += d
        dzg = torch.einsum("lbh,lh->bl", dpre1g, gw1[:, 0, :])
        dz = dz + dx[:, :L] + dzh + dzg
        dctx.index_add_(0, idx[s:s + 1], dx[None, :, L:])
    return dz, dctx, dnoise, tuple(dw)


def tower_backward(dout, cache, x, weights, acts):
    """VJP of ``fused_solve.tower_forward``: returns d x and the weights'
    gradients ``[dW0, db0, dW1, db1, ...]``, each summed over the rows."""
    from torchsde_tpu_torch.ops import fused_solve as F

    grads = [None] * (2 * len(weights))
    d = dout
    for i in range(len(weights) - 1, -1, -1):
        pre, out = cache[i]
        d = F.act_bwd(d, pre, out, acts[i])
        inp = cache[i - 1][1] if i > 0 else x
        grads[2 * i] = inp.T @ d
        grads[2 * i + 1] = d.sum(0)
        d = d @ weights[i][0].T
    return d, grads


def unsplit_euler_backward(y0, noise, t0s, dts, fw, gw, spec, ys, gy):
    """Kernel 10's function as one loop of PyTorch operators, every weight
    gradient summed step by step: the form of
    ``fused_solve.euler_solve_backward_plain`` before its split into a
    sweep and a contraction, kept as the reference the split is held to."""
    from torchsde_tpu_torch.ops import fused_solve as F

    fl, gl = F.unpack(fw, spec.drift), F.unpack(gw, spec.diffusion)
    facts, gacts = F._acts(spec.drift), F._acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    dfw = [torch.zeros_like(t) for wb in fl for t in wb]
    dgw = [torch.zeros_like(t) for wb in gl for t in wb]
    for n in reversed(range(noise.shape[0])):
        y = y0 if n == 0 else ys[n - 1]
        x = F.tower_input(t0s[n], y, spec.with_time)
        _, fcache = F.tower_forward(x, fl, facts)
        g, gcache = F.tower_forward(x, gl, gacts)
        dy = dy + gy[n]
        dnoise[n] = F._noise_vjp(dy, g, spec)
        dxf, gf = tower_backward(dy * dts[n], fcache, x, fl, facts)
        dxg, gg = tower_backward(F._noise_outer(dy, noise[n], spec), gcache,
                                 x, gl, gacts)
        for acc, d in zip(dfw + dgw, gf + gg):
            acc += d
        dy = dy + (dxf + dxg)[:, wt:]
    return dy, dnoise, F._cat_grads(dfw), F._cat_grads(dgw)


def unsplit_rh_backward(y0, f0, g0, noise, t1s, dts, fw, gw, spec, zs, gs,
                        gy):
    """Kernel 12's function as one loop of PyTorch operators, every weight
    gradient summed step by step: the form of
    ``fused_solve.rh_solve_backward_plain`` before its split into a sweep
    and a contraction, kept as the reference the split is held to."""
    from torchsde_tpu_torch.ops import fused_solve as F

    fl, gl = F.unpack(fw, spec.drift), F.unpack(gw, spec.diffusion)
    facts, gacts = F._acts(spec.drift), F._acts(spec.diffusion)
    wt = 1 if spec.with_time else 0
    N = noise.shape[0]
    g_all = torch.cat([g0[None], gs])
    ay, az, af = (torch.zeros_like(y0) for _ in range(3))
    ag = torch.zeros_like(g0)
    dnoise = torch.empty_like(noise)
    dfw = [torch.zeros_like(t) for wb in fl for t in wb]
    dgw = [torch.zeros_like(t) for wb in gl for t in wb]
    for n in reversed(range(N)):
        dt, dW = dts[n], noise[n]
        ay = ay + gy[n]
        Af = af + 0.5 * dt * ay
        Ag = ag + F._noise_outer(ay, 0.5 * dW, spec)
        x = F.tower_input(t1s[n], zs[n], spec.with_time)
        _, fcache = F.tower_forward(x, fl, facts)
        _, gcache = F.tower_forward(x, gl, gacts)
        dxf, gf = tower_backward(Af, fcache, x, fl, facts)
        dxg, gg = tower_backward(Ag, gcache, x, gl, gacts)
        for acc, d in zip(dfw + dgw, gf + gg):
            acc += d
        Az = az + (dxf + dxg)[:, wt:]
        g_n, g_next = g_all[n], g_all[n + 1]
        dnoise[n] = F._noise_vjp(Az, g_n, spec) + F._noise_vjp(
            0.5 * ay, g_n + g_next, spec)
        ay, az, af, ag = (ay + 2.0 * Az, -Az, 0.5 * dt * ay + dt * Az,
                          F._noise_outer(0.5 * ay + Az, dW, spec))
    return (ay + az, af, ag, dnoise, F._cat_grads(dfw),
            F._cat_grads(dgw))


def unsplit_logqp_backward(y0, noise, t0s, dts, fw, hw, gw, spec, ys, gy,
                           ginc):
    """Kernel 14's function as one loop of PyTorch operators, every weight
    gradient summed step by step: the form of
    ``fused_solve.euler_logqp_solve_backward_plain`` before its split into a
    sweep and a contraction, kept as the reference the split is held to."""
    from torchsde_tpu_torch.ops import fused_solve as F

    towers = F._logqp_towers(fw, hw, gw, spec)
    wt = 1 if spec.with_time else 0
    dy = torch.zeros_like(y0)
    dnoise = torch.empty_like(noise)
    dws = [[torch.zeros_like(t) for wb in w for t in wb] for w, _ in towers]
    for n in reversed(range(noise.shape[0])):
        dt = dts[n]
        x = F.tower_input(t0s[n], y0 if n == 0 else ys[n - 1],
                          spec.with_time)
        (f, fcache), (h, hcache), (g, gcache) = (
            F.tower_forward(x, w, acts) for w, acts in towers)
        gs, big = F._clamped(g)
        u = (f - h) / gs
        dy = dy + gy[n]
        dnoise[n] = dy * g
        du = ginc[n] * u * dt
        douts = (dy * dt + du / gs, -du / gs,
                 dy * noise[n] - (du * u / gs) * big.to(g.dtype))
        dx = None
        for (w, acts), cache, dout, acc in zip(towers, (fcache, hcache,
                                                        gcache), douts, dws):
            dxt, grads = tower_backward(dout, cache, x, w, acts)
            for a, d in zip(acc, grads):
                a += d
            dx = dxt if dx is None else dx + dxt
        dy = dy + dx[:, wt:]
    return (dy, dnoise, *(F._cat_grads(d) for d in dws))
