"""K1 (near field) and K2 (octet far field): the port's plain versions
against the JAX package's Pallas kernels (interpret mode) on the same lists.

Tolerance rtol 2e-4, atol 2e-5 (the bound of tests/test_bh.py for the
Pallas kernels against their jnp versions): the two sum the same f32 terms
in another order, and rsqrt rounds differently.

On the CPU the wrappers run the plain versions and launch nothing. The
kernels themselves run only on a CUDA device: tests/test_torch_gpu.py
(marked `gpu`; it also checks that an f64 tensor on the card is refused)
and chip_smoke.py hold each kernel against its plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops.pallas_bh import far_octet_pallas, near_field_pallas
from parallelnbody_tpu_torch.ops import bh_kernels

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
LEAF = 32


@pytest.fixture(scope="module")
def lists():
    """Sorted particles, leaves and dense-octet lists (quadrupole table)
    from the JAX package, as numpy arrays."""
    cfg = SimConfig(n=2048, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(9), cfg)
    pos_s, mass_s, _, tree, _, n_pad = jbh._prepare(
        pos, mass, leaf_size=LEAF, curve="hilbert", multipole_order=2)
    n_leaves = n_pad // LEAF
    far, rej = jbh.traverse(tree, 0.6)
    ni, nv, fk, fv, nodes8, of = jbh.build_interaction_lists_octet(
        tree, far, rej, theta=0.6, start_leaf=0, n_slice=n_leaves,
        near_budget=n_leaves, far_budget=n_leaves, dtype=jnp.float32)
    assert int(of) == 0
    out = dict(pos_s=pos_s, mass_s=mass_s, tgt=pos_s.reshape(n_leaves, LEAF, 3),
               ni=ni, nv=nv, fk=fk, fv=fv, nodes8=nodes8)
    return {k: np.array(v) for k, v in out.items()}


def _t(a):
    return torch.from_numpy(a)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
def test_near_field_plain_matches_pallas(lists, softening, compute_pot):
    L = lists
    ja, jp = near_field_pallas(
        jnp.asarray(L["pos_s"]), jnp.asarray(L["mass_s"]),
        jnp.asarray(L["tgt"]), jnp.asarray(L["ni"]), jnp.asarray(L["nv"]),
        LEAF, 1.0, softening, softening == 0.0, interpret=True,
        compute_pot=compute_pot)
    ta, tp = bh_kernels.near_field(
        _t(L["pos_s"]), _t(L["mass_s"]), _t(L["tgt"]), _t(L["ni"]),
        _t(L["nv"]), g=1.0, softening=softening, compute_pot=compute_pot)
    assert np.all(np.isfinite(ta.numpy()))
    _close(ta, ja)
    _close(tp, jp)
    assert bool(torch.any(tp != 0)) == compute_pot


@pytest.mark.parametrize("softening", [0.02, 0.0], ids=["soft", "guard0"])
@pytest.mark.parametrize("compute_pot", [True, False])
@pytest.mark.parametrize("quad", [True, False], ids=["quad", "mono"])
def test_far_octet_plain_matches_pallas(lists, softening, compute_pot, quad):
    L = lists
    nodes8 = L["nodes8"] if quad else np.ascontiguousarray(L["nodes8"][:, :4])
    ja, jp = far_octet_pallas(
        jnp.asarray(L["tgt"]), jnp.asarray(nodes8), jnp.asarray(L["fk"]),
        jnp.asarray(L["fv"]), 1.0, softening, softening == 0.0,
        interpret=True, compute_pot=compute_pot)
    ta, tp = bh_kernels.far_octet(
        _t(L["tgt"]), _t(nodes8), _t(L["fk"]), _t(L["fv"]), g=1.0,
        softening=softening, compute_pot=compute_pot)
    _close(ta, ja)
    _close(tp, jp)
    assert bool(torch.any(tp != 0)) == compute_pot


def test_plain_versions_match_jnp_fallbacks(lists):
    """The plain versions against the JAX package's own jnp versions of the
    two kernels (_near_field_jnp, _far_octet_jnp), g != 1."""
    L = lists
    eps = 0.02
    ja, jp = jbh._near_field_jnp(
        jnp.asarray(L["pos_s"]), jnp.asarray(L["mass_s"]),
        jnp.asarray(L["tgt"]), jnp.asarray(L["ni"]), jnp.asarray(L["nv"]),
        LEAF, 2.5, jnp.float32(eps * eps), False)
    ta, tp = bh_kernels.near_field_plain(
        _t(L["pos_s"]), _t(L["mass_s"]), _t(L["tgt"]), _t(L["ni"]),
        _t(L["nv"]), g=2.5, softening=eps)
    _close(ta, ja)
    _close(tp, jp)
    ja, jp = jbh._far_octet_jnp(
        jnp.asarray(L["tgt"]), jnp.asarray(L["nodes8"]), jnp.asarray(L["fk"]),
        jnp.asarray(L["fv"]), 2.5, jnp.float32(eps * eps), False)
    ta, tp = bh_kernels.far_octet_plain(
        _t(L["tgt"]), _t(L["nodes8"]), _t(L["fk"]), _t(L["fv"]), g=2.5,
        softening=eps)
    _close(ta, ja)
    _close(tp, jp)


def test_cpu_wrappers_launch_nothing(lists):
    L = lists
    bh_kernels.reset_launch_counts()
    bh_kernels.near_field(_t(L["pos_s"]), _t(L["mass_s"]), _t(L["tgt"]),
                          _t(L["ni"]), _t(L["nv"]), g=1.0, softening=0.02)
    bh_kernels.far_octet(_t(L["tgt"]), _t(L["nodes8"]), _t(L["fk"]),
                         _t(L["fv"]), g=1.0, softening=0.02)
    bh_kernels.far_gather(_t(L["tgt"]), _t(L["nodes8"]), _t(L["ni"]),
                          _t(L["nv"]), g=1.0, softening=0.02)
    n_leaves = L["tgt"].shape[0]
    bh_kernels.near_field(_t(L["pos_s"]), _t(L["mass_s"]), _t(L["tgt"]),
                          _t(L["ni"]), _t(L["nv"]), g=1.0, softening=0.02,
                          leaf_lo=0)
    table = torch.cat([_t(L["pos_s"]), _t(L["mass_s"])[:, None]], dim=1)
    bh_kernels.near_field(None, None, _t(L["tgt"]), _t(L["ni"]),
                          _t(L["nv"]), g=1.0, softening=0.02,
                          src_table=table[:n_leaves // 2 * L["tgt"].shape[1]])
    assert bh_kernels.LAUNCHES == {"near_field": 0, "near_field_window": 0,
                                   "near_field_table": 0, "far_octet": 0,
                                   "far_gather": 0}
