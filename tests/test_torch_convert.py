"""load_jax_params, and the port's independence from JAX."""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from port_bridge import jax_named_arrays
from torchsde_tpu.models.latent_sde import LatentSDE as JLatentSDE
from torchsde_tpu_torch.models.latent_sde import LatentSDE
from torchsde_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = (3, 4, 8, 16)       # data, latent, context, hidden


@functools.lru_cache(maxsize=None)
def _jax_model():
    return JLatentSDE(jax.random.PRNGKey(0), *DIMS)


def _arrays():
    return jax_named_arrays(_jax_model())


def _port_tensors(module):
    return dict(module.named_parameters()) | dict(module.named_buffers())


def test_every_jax_leaf_maps_to_one_port_tensor():
    arrays = _arrays()
    assert len(arrays) == len(jax.tree_util.tree_leaves(_jax_model()))
    model = LatentSDE(*DIMS, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert set(_port_tensors(model)) == set(arrays)
    load_jax_params(model, arrays)
    for name, t in _port_tensors(model).items():
        np.testing.assert_array_equal(t.detach().numpy(), arrays[name])


def test_bf16_leaves_carry_across_bit_for_bit():
    """A bf16 JAX LatentSDE (ml_dtypes.bfloat16 leaves, which torch cannot
    read as they are) loads into a bf16 port model bitwise, leaf by leaf,
    through the arrays' 16-bit views."""
    import jax.numpy as jnp
    jax_model = JLatentSDE(jax.random.PRNGKey(3), *DIMS, dtype=jnp.bfloat16)
    arrays = jax_named_arrays(jax_model)
    assert all(a.dtype.name == "bfloat16" for a in arrays.values())
    model = LatentSDE(*DIMS, dtype=torch.bfloat16, device="cpu")
    load_jax_params(model, arrays)
    for name, t in _port_tensors(model).items():
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            t.detach().view(torch.int16).numpy(),
            arrays[name].view(np.int16), err_msg=name)


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_rejects_missing_and_unused_keys(fault):
    arrays = _arrays()
    if fault == "missing":
        del arrays["g_nets.2"]
    else:
        arrays["f_net.layers.3.w"] = np.zeros((16, 4), np.float32)
    model = LatentSDE(*DIMS, device="cpu")
    before = {k: v.clone() for k, v in _port_tensors(model).items()}
    with pytest.raises(KeyError, match="g_nets.2" if fault == "missing"
                       else "f_net.layers.3.w"):
        load_jax_params(model, arrays)
    for name, t in _port_tensors(model).items():
        assert torch.equal(t, before[name])


def test_rejects_a_shape_mismatch_and_copies_nothing():
    arrays = _arrays()
    arrays["encoder.cell.w_hh"] = arrays["encoder.cell.w_hh"].T
    model = LatentSDE(*DIMS, device="cpu")
    before = {k: v.clone() for k, v in _port_tensors(model).items()}
    with pytest.raises(ValueError, match="encoder.cell.w_hh"):
        load_jax_params(model, arrays)
    for name, t in _port_tensors(model).items():
        assert torch.equal(t, before[name])


def test_port_never_imports_jax():
    """Every module of the package (the examples, the diagnostics and the
    mesh among them), chip_smoke.py and the mesh tests' rank functions
    (tests/mesh_ranks.py, which spawned ranks import) import without
    bringing JAX in, nor matplotlib (the examples import it only to
    plot)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import torchsde_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke', 'mesh_ranks']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert 'torchsde_tpu_torch.parallel.mesh' in mods, mods\n"
        "assert {'torchsde_tpu_torch.models.unet', "
        "'torchsde_tpu_torch.models.cont_ddpm'} <= set(mods), mods\n"
        "examples = {'torchsde_tpu_torch.examples.' + n for n in ("
        "'latent_sde', 'latent_sde_lorenz', 'sde_gan', 'cont_ddpm', "
        "'demo', '_evidence')}\n"
        "diagnostics = {'torchsde_tpu_torch.diagnostics.' + n for n in ("
        "'problems', 'harness', 'inspection', 'run_all', 'ito_diagonal', "
        "'ito_scalar', 'ito_additive', 'ito_general', "
        "'stratonovich_diagonal', 'stratonovich_scalar', "
        "'stratonovich_additive', 'stratonovich_general')}\n"
        "assert examples | diagnostics <= set(mods), mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'torchsde_tpu.', "
        "'matplotlib', 'ml_dtypes')))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
