"""The comparison fails a run whose timed path is broken underneath, once
for each fault a cell can have, and passes the sound run. (One card: no
exchange between chips to leave out.)"""

import pytest
import torch

from parallelnbody_tpu_torch import api
from parallelnbody_tpu_torch.ops import bh

from benchmark.tests import cpu_runs


def _half(mass):
    """Half of the sources left out, the rest weighed double: the mean
    over the rest in place of the whole."""
    keep = (torch.arange(mass.shape[0], device=mass.device) % 2) == 0
    return torch.where(keep, 2 * mass, torch.zeros_like(mass))


def unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(api, "get_integrator", lambda name: (
        lambda accel_fn, pos, vel, acc, pot, dt: (pos, vel, acc, pot)))


def half_the_sources(monkeypatch):
    make, evaluate = api.make_accel_fn, bh.bh_eval_lists
    monkeypatch.setattr(api, "make_accel_fn", lambda cfg, mass, **kw: make(
        cfg, _half(mass), **kw))
    monkeypatch.setattr(bh, "bh_eval_lists", lambda p, mass, plan, **kw:
                        evaluate(p, _half(mass), plan, **kw))


def answer_altered(monkeypatch):
    """Every call's answer altered where it is produced: its rows handed
    back one place out of order (an exit unsort gone wrong)."""
    def shifted(build):
        def make(*args, **kw):
            call = build(*args, **kw)

            def run(state):
                out, overflow = call(state)
                return out._replace(pos=out.pos.roll(1, 0),
                                    vel=out.vel.roll(1, 0),
                                    acc=out.acc.roll(1, 0)), overflow
            return run
        return make

    monkeypatch.setattr(api, "make_step", shifted(api.make_step))
    monkeypatch.setattr(api, "make_run", shifted(api.make_run))


FAULTS = [unchanged, half_the_sources, answer_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", sorted(cpu_runs.SMALL))
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_runs.run(name, seconds=0.2)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", sorted(cpu_runs.SMALL))
def test_sound_run_is_correct(name):
    res = cpu_runs.run(name, seconds=0.2)
    assert res["correct"] is True, res["checks"]
