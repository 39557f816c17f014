"""A whole run at a tiny size on the CPU (the look for a card skipped):
sound, it comes out correct; with the timed path broken underneath it, in
each way the cell can break, ``correct`` comes out false."""

import pytest
import torch

from benchtools import CELLS, tiny_run


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def stuck(monkeypatch):
    """A step that returns its state unchanged (but counts the step)."""
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    monkeypatch.setattr(EnsembleSampler, "_step",
                        lambda self, state, v, g=None: state._replace(
                            niter=state.niter + 1))


def half_batch(monkeypatch):
    """The likelihood of half the chains only, the rest filled with the
    mean of those."""
    from bart_tpu_torch.inference.likelihood import Likelihood

    orig = Likelihood.__call__

    def call(self, free):
        h = free.shape[0] // 2
        ll, model = orig(self, free[:h])
        fill = model.mean(0, keepdim=True).expand(free.shape[0] - h, -1)
        lfill = ll.mean().expand(free.shape[0] - h)
        return torch.cat([ll, lfill]), torch.cat([model, fill])

    monkeypatch.setattr(Likelihood, "__call__", call)


def altered(monkeypatch):
    """Band fluxes altered where the forward produces them (by 1e-3 of
    themselves)."""
    from bart_tpu_torch.rt.forward import ForwardModel

    orig = ForwardModel.__call__

    def call(self, params, tables=None):
        band, spec, valid = orig(self, params, tables)
        return band * (1.0 + 1e-3), spec, valid

    monkeypatch.setattr(ForwardModel, "__call__", call)


def moved_wrong(monkeypatch):
    """Accepted chains moved past their proposals (by 1e-9 of it)."""
    from bart_tpu_torch.inference.samplers import EnsembleSampler

    orig = EnsembleSampler._propose

    def prop(self, state, v, g):
        x, corr = orig(self, state, v, g)
        return x * (1.0 + 1e-9), corr

    monkeypatch.setattr(EnsembleSampler, "_propose", prop)


def scaled_table(monkeypatch):
    """The table built 15% too high, every entry."""
    from bart_tpu_torch.opacity import grid

    orig = grid.build_opacity_grid

    def build(*args, **kw):
        g = orig(*args, **kw)
        g.sigma.mul_(1.15)
        return g

    monkeypatch.setattr(grid, "build_opacity_grid", build)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, workdir, monkeypatch):
    out = tiny_run(name, workdir, monkeypatch=monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [stuck, half_batch, altered, moved_wrong],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault, workdir, monkeypatch):
    fault(monkeypatch)
    out = tiny_run(name, workdir, monkeypatch=monkeypatch)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_wrong_table_is_not_correct(name, tmp_path, monkeypatch):
    scaled_table(monkeypatch)
    out = tiny_run(name, str(tmp_path), monkeypatch=monkeypatch)
    assert not out["correct"], out["checks"]
    assert out["checks"]["table_row_gap"][0] > 0.1
