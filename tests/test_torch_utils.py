"""The port's support utilities (``utils/misc.py``'s schedulers,
``utils/checkpoint.py``, ``utils/profiling.py``) against torchsde_tpu's
and the contracts they state: the schedulers' sequences exactly; a run
that saves, loads and continues bitwise the run that never stopped; a
trace that holds the annotated span."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsde_tpu.utils import misc as JM
from torchsde_tpu.utils import profiling as JP
from torchsde_tpu_torch.models.latent_sde import LatentSDE, latent_sde_loss
from torchsde_tpu_torch.utils import misc as TM
from torchsde_tpu_torch.utils import profiling as TP
from torchsde_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

STEPS = 300


@pytest.mark.parametrize("iters,maxval", [(1, 1.0), (7, 1.0), (100, 1.0),
                                          (100, 0.5), (0, 2.0), (450, 3.0)])
def test_linear_scheduler_is_the_jax_sequence(iters, maxval):
    j, t = JM.LinearScheduler(iters, maxval), TM.LinearScheduler(iters,
                                                                 maxval)
    got, want = [], []
    for _ in range(STEPS):
        got.append(t.val)
        want.append(j.val)
        t.step()
        j.step()
    assert got == want
    assert got[-1] == min(maxval, got[-1])


@pytest.mark.parametrize("gamma", [0.99, 0.9, 0.5])
def test_ema_metric_is_the_jax_sequence(gamma):
    values = np.random.default_rng(3).standard_normal(STEPS) * 10
    j, t = JM.EMAMetric(gamma), TM.EMAMetric(gamma)
    got = [t.step(torch.tensor(v)) for v in values]
    want = [j.step(jnp.asarray(v)) for v in values]
    assert got == want
    assert t.val == j.val


def _latent(seed):
    return LatentSDE(3, 2, 4, 8, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _train(model, opt, gen, xs, ts, steps):
    """``steps`` Adam steps of the ELBO, one generator carried across
    them (its state is part of the run)."""
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss, _ = latent_sde_loss(model, xs, ts, gen, dt=0.1)
        loss.backward()
        opt.step()


def test_checkpoint_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    ts = np.linspace(0.0, 1.0, 4)
    xs = torch.randn((4, 8, 3), generator=torch.Generator().manual_seed(1))

    def fresh():
        model = _latent(0)
        return (model, torch.optim.Adam(model.parameters(), lr=1e-2),
                torch.Generator().manual_seed(2))

    whole = fresh()
    _train(*whole, xs, ts, 6)

    first = fresh()
    _train(*first, xs, ts, 3)
    path = save_checkpoint(tmp_path / "sub" / "ck.pt", model=first[0],
                           opt=first[1], gen=first[2], step=3)
    resumed = fresh()
    values = load_checkpoint(path, "cpu", model=resumed[0], opt=resumed[1],
                             gen=resumed[2])
    assert values == {"step": 3}
    _train(*resumed, xs, ts, 3)

    for (name, p), q in zip(whole[0].named_parameters(),
                            resumed[0].parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(whole[2].get_state(), resumed[2].get_state())


def test_load_checkpoint_rejects_a_missing_or_mismatched_entry(tmp_path):
    model = _latent(0)
    path = save_checkpoint(tmp_path / "ck.pt", model=model,
                           gen=torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="'opt'"):
        load_checkpoint(path, "cpu", opt=torch.optim.SGD(
            model.parameters(), lr=1.0))
    with pytest.raises(KeyError, match="is a generator"):
        load_checkpoint(path, "cpu", gen=_latent(1))


def test_load_checkpoint_maps_to_the_given_device(tmp_path):
    model = _latent(0)
    path = save_checkpoint(tmp_path / "ck.pt", model=model)
    other = _latent(5)
    load_checkpoint(path, torch.device("cpu"), model=other)
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(p, q)


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    x = torch.randn((64, 64))
    with TP.trace(tmp_path / "prof"):
        with TP.annotate("port_span"):
            y = x @ x
    events = json.loads((tmp_path / "prof" / TP.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "port_span" in names
    assert float(y.sum()) == float((x @ x).sum())


def test_wall_timer_fetches_a_value():
    with TP.WallTimer() as timer:
        value = TP.WallTimer.fetch(torch.tensor([2.5, 1.0]))
    assert value == 2.5 == JP.WallTimer.fetch(jnp.asarray([2.5, 1.0]))
    assert timer.elapsed >= 0.0

