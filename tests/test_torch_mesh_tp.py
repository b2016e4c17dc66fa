"""The port's tensor parallelism (``parallel/mesh.py``: ``make_mesh_2d``,
``shard_latent_sde_tp``, ``data_parallel_train_step``) against
``tests/test_parallel.py:170`` and ``:379``: a DP x TP step of the latent
ELBO on a 4 x 2 mesh and on a 2 x 4 one, each held to one port process's
step and to the JAX package's loss and gradients (``mesh_refs``'
tolerances). The ranks run ``tests/mesh_ranks.py:latent_step``."""

import pytest
import torch

import mesh_ranks as MR
from mesh_refs import (LR, PORT, SPLIT, WORLD, close, latent_case,
                       latent_cfg, run, single_step)
from port_bridge import jax_named_arrays, port_latent_sde

DIMS = (4, 8, 16)       # latent, context, hidden (test_parallel.py:181)


def tp_part(name, value, coord, size):
    """This model rank's part of a whole parameter: the columns of a
    column-parallel layer (even index of f_net or h_net: w and b), the rows
    of a row-parallel one's w; anything else whole."""
    parts = name.split(".")
    if parts[0] not in ("f_net", "h_net"):
        return value
    i, kind = int(parts[2]), parts[3]
    if i % 2 == 0:
        k = value.shape[-1] // size
        return value[..., coord * k:(coord + 1) * k]
    if kind == "w":
        k = value.shape[0] // size
        return value[coord * k:(coord + 1) * k]
    return value


N_MODELS = (2, 4)


@pytest.fixture(scope="module")
def tp_ranks():
    """A DP x TP step on 8 ranks with ``n_model`` 2 (4 x 2) and 4 (2 x 4),
    one after the other in one start of the ranks."""
    jmodel, xs, eps, W, _, _ = latent_case(*DIMS)
    model = port_latent_sde(jmodel, torch.float64)
    out = run(MR.jobs, WORLD, [
        ("latent_step", (latent_cfg(model, xs, eps, W, n_model=n),))
        for n in N_MODELS])
    return {n: [rank[i] for rank in out] for i, n in enumerate(N_MODELS)}


@pytest.fixture(scope="module", params=N_MODELS, ids=["4x2", "2x4"])
def tp_case(request, tp_ranks):
    """One of those steps, the same step in one port process, and the JAX
    package's."""
    n_model = request.param
    jmodel, xs, eps, W, jloss, jgrads = latent_case(*DIMS)
    model = port_latent_sde(jmodel, torch.float64)
    single = single_step(model, xs, eps, W)
    return dict(n_model=n_model, ranks=tp_ranks[n_model], single=single,
                jloss=jloss, jgrads=jgrads, jparams=jax_named_arrays(jmodel))


def test_dp_tp_mesh_layout(tp_case):
    """Row-major ranks: rank r is data r // n_model, model r % n_model, and
    its model group is the run of n_model adjacent ranks holding it (on
    2 x 4, ranks 0-3 and 4-7: the model axis within a slice); each rank's
    f_net.layers[0].w is its (in, H / n_model) shard, kept through the
    update."""
    n = tp_case["n_model"]
    L, C, H = DIMS
    for r, out in enumerate(tp_case["ranks"]):
        assert out["coords"] == {"data": r // n, "model": r % n}
        assert out["model_ranks"] == list(range(r - r % n, r - r % n + n))
        assert out["rows"] == (16 // (WORLD // n) * (r // n),
                               16 // (WORLD // n) * (r // n + 1))
        p = out["params"]
        assert p["f_net.layers.0.w"].shape == (L + C, H // n)
        assert p["f_net.layers.0.b"].shape == (H // n,)
        assert p["f_net.layers.1.w"].shape == (H // n, H)
        assert p["h_net.layers.2.w"].shape == (H, L // n)
        assert p["encoder.cell.w_hh"].shape == (H, 3 * H)


def test_dp_tp_loss_and_step_match_the_base(tp_case):
    """Every rank's loss is the unsharded run's (one port process and the
    JAX package's), and its parameters after the step are its parts of the
    unsharded step's."""
    n = tp_case["n_model"]
    loss, _, params = tp_case["single"]
    for out in tp_case["ranks"]:
        coord = out["coords"]["model"]
        close(out["loss"], loss, SPLIT)
        close(out["loss"], tp_case["jloss"], PORT)
        for name, p in out["params"].items():
            close(p, tp_part(name, params[name], coord, n), SPLIT)
            want = tp_case["jparams"][name] - LR * tp_case["jgrads"][name]
            close(p, tp_part(name, want, coord, n), PORT)


def test_dp_tp_gradients_are_not_scaled_by_the_model_axis(tp_case):
    """The averaged gradients the update gets are the unsharded gradients,
    split: not n_model times them, as the deprecated functional all-reduce
    (whose backward all-reduces again) would give on a loss every model
    rank computes."""
    n = tp_case["n_model"]
    _, grads, _ = tp_case["single"]
    for out in tp_case["ranks"]:
        coord = out["coords"]["model"]
        for name, g in out["grads"].items():
            want = tp_part(name, grads[name], coord, n)
            ratio = float((g * want).sum() / (want * want).sum())
            assert abs(ratio - 1.0) < 1e-12, (name, ratio)
            close(g, want, SPLIT)
            close(g, tp_part(name, tp_case["jgrads"][name], coord, n), PORT)
