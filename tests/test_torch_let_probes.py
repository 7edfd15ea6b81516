"""tools/let_halo_probe.py and let_granularity_probe.py on the CPU against
scripts/let_halo_probe.py and scripts/let_granularity_probe.py.

Both run in float64 on the JAX package's seed-0 ICs, so that the two
packages' pyramids agree to f64 rounding and no MAC comparison flips:

  * let_halo (N = 16384, 4 ranks, leaf 32; dense, and staged forced): the
    script's case record equals the tool's, and each rank's needed
    leaves, imports and largest per-owner import equal those of the
    script's own `rank_near_lists` on the JAX tree, exactly.
  * let_granularity (N = 16384, 4 ranks, leaf 64, plummer and disk): every
    value of the script's rows, the fat leaves' fraction under numpy's
    median rule included, equals the tool's.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.api import init_simulation as jax_init
from parallelnbody_tpu.config import SimConfig as JaxConfig
from parallelnbody_tpu.models import get_ic as jax_get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu_torch import SimConfig
from parallelnbody_tpu_torch.state import state_from_numpy
from parallelnbody_tpu_torch.tools import let_granularity_probe as gran
from parallelnbody_tpu_torch.tools import let_halo_probe as halo

torch.set_num_threads(2)

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
CPU = torch.device("cpu")
RANKS = 4


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # read-only: the TPU script
    return mod


def _jax_per_rank(script, cfg):
    """Each rank's counts from the script's rank_near_lists on the JAX
    tree (the loop of its run_case)."""
    state = jax_init(cfg, compute_forces=False)
    leaf = cfg.resolve_bh_leaf_size()
    _, _, _, tree, _, n_pad = jbh._prepare(
        state.pos, state.mass, leaf_size=leaf, curve=cfg.bh_curve,
        multipole_order=cfg.bh_multipole, max_levels=cfg.bh_max_levels)
    l_glob = int(n_pad) // leaf
    n_leaf_loc = -(-l_glob // RANKS)
    refine, cands = jbh.resolve_refine(
        cfg.resolve_bh_refine(), (cfg.bh_cand2_budget, cfg.bh_cand_budget),
        int(tree.n_levels), cfg.bh_near_budget, cfg.bh_far_budget)
    owner = np.arange(l_glob) // n_leaf_loc
    out = []
    for r in range(RANKS):
        idx, valid = script.rank_near_lists(
            tree, cfg.theta, refine, cands, r * n_leaf_loc, n_leaf_loc,
            near_budget=cfg.bh_near_budget, far_budget=cfg.bh_far_budget,
            dtype=jnp.float64)
        needed = np.zeros(l_glob, bool)
        needed[np.asarray(idx)[np.asarray(valid)]] = True
        by_owner = np.bincount(owner[needed], minlength=RANKS)
        by_owner[r] = 0
        out.append({"rank": r, "needed": int(needed.sum()),
                    "imports": int(by_owner.sum()),
                    "max_pair": int(by_owner.max())})
    return out, refine


@pytest.mark.parametrize("ic,refine", [("plummer", "auto"),
                                       ("galaxy_collision", "staged"),
                                       ("disk", "auto")])
def test_let_halo_equals_the_script(ic, refine):
    script = _load("let_halo_probe")
    kw = dict(n=16384, ic=ic, force="barnes_hut", theta=0.72,
              softening=0.01, bh_leaf_size=32, bh_near_budget=3584,
              bh_far_budget=2816, bh_refine=refine, dtype="float64")
    jcfg = JaxConfig(**kw)
    want = script.run_case(ic, jcfg, RANKS)
    per_rank, jrefine = _jax_per_rank(script, jcfg)
    ics = jax_init(jcfg, compute_forces=False)
    state = state_from_numpy({k: np.array(getattr(ics, k))
                              for k in ("pos", "vel", "mass")}, CPU,
                             torch.float64)
    got = halo.run_case(ic, SimConfig(**kw), RANKS, CPU, state=state)
    assert got["per_rank"] == per_rank
    assert got["refine"] == jrefine == ("dense" if refine == "auto"
                                        else "staged")
    for key, value in want.items():
        assert got[key] == value, key
    assert got["overflow"] == 0


def test_let_granularity_equals_the_script(monkeypatch, tmp_path):
    script = _load("let_granularity_probe")
    n, leaf = 16384, 64
    ics = {}
    for ic in ("plummer", "disk"):
        cfg = JaxConfig(n=n, ic=ic, theta=0.72, force="barnes_hut",
                        softening=0.01, dt=1e-4)
        pos, _, mass = jax_get_ic(ic)(
            jax.random.key(cfg.seed), cfg)
        ics[ic] = (np.array(pos, np.float64), np.array(mass, np.float64))
    monkeypatch.setattr(script, "get_ic", lambda ic: (
        lambda key, cfg: (jnp.asarray(ics[ic][0]), None,
                          jnp.asarray(ics[ic][1]))))
    out = tmp_path / "granularity.json"
    monkeypatch.setattr(sys, "argv", [
        "let_granularity_probe.py", "--n", str(n), "--ranks", str(RANKS),
        "--leaf", str(leaf), "--out", str(out)])
    script.main()
    want = json.loads(out.read_text())
    for row in want:
        pos, mass = (torch.from_numpy(a) for a in ics[row["ic"]])
        got = gran.granularity(row["ic"], pos, mass, ranks=RANKS,
                               theta=0.72, leaf=leaf, device=CPU)
        for key, value in row.items():
            assert got[key] == value, (row["ic"], key)
        assert 0 < got["fat_leaves_frac"] < 0.5


def test_median_follows_numpy():
    """An even count of live radii: the mean of the two middle values
    (torch's median would give the lower one); an empty leaf makes it
    NaN, so no leaf is fat, as in the script."""
    r = np.array([1.0, 2.0, 3.0, 10.0])
    assert np.median(r) == 2.5 != float(torch.median(torch.from_numpy(r)))
    pos = torch.zeros((256, 3), dtype=torch.float64)
    pos[:, 0] = torch.arange(256, dtype=torch.float64)
    mass = torch.ones(256, dtype=torch.float64)
    mass[-64:] = 0.0
    row = gran.granularity("line", pos, mass, ranks=2, theta=0.72, leaf=64,
                           device=CPU)
    assert np.isnan(row["median_leaf_radius"])
    assert row["fat_leaves_frac"] == 0.0
