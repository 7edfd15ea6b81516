"""Keys, sort order and the multipole pyramid: the port against the JAX
package on the same f32 particles (the JAX Plummer ICs, handed over as
numpy arrays)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallelnbody_tpu.config import SimConfig
from parallelnbody_tpu.models import get_ic
from parallelnbody_tpu.ops import bh as jbh
from parallelnbody_tpu.ops.hilbert import hilbert_encode as j_hilbert
from parallelnbody_tpu.ops.morton import morton_encode as j_morton
from parallelnbody_tpu_torch.ops import bh as tbh
from parallelnbody_tpu_torch.ops.hilbert import hilbert_encode as t_hilbert
from parallelnbody_tpu_torch.ops.morton import morton_encode as t_morton

torch.set_num_threads(2)


def _plummer_np(n, seed):
    cfg = SimConfig(n=n, ic="plummer", dtype="float32")
    pos, _, mass = get_ic("plummer")(jax.random.key(seed), cfg)
    return np.array(pos), np.array(mass)


@pytest.mark.parametrize("n,seed", [(4096, 0), (3000, 5)])
def test_domain_cube_and_keys_bitwise(n, seed):
    pos, _ = _plummer_np(n, seed)
    jc, jh, js = jbh.domain_cube(jnp.min(pos, 0), jnp.max(pos, 0))
    tp = torch.from_numpy(pos)
    tc, th, ts = tbh.domain_cube(tp.amin(0), tp.amax(0))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for jenc, tenc in ((j_hilbert, t_hilbert), (j_morton, t_morton)):
        jk = np.asarray(jenc(jnp.asarray(pos), jc, jh))
        tk = tenc(tp, tc, th).numpy()
        assert tk.dtype == np.int32
        np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_prepare_permutation_bitwise(curve):
    # n = 3000 pads to 4096 rows: the pad rows' sentinel keys sort last.
    pos, mass = _plummer_np(3000, 2)
    jps, jms, jperm, _, _, jn_pad = jbh._prepare(
        jnp.asarray(pos), jnp.asarray(mass), leaf_size=32, curve=curve)
    tps, tms, tperm, _, _, tn_pad = tbh._prepare(
        torch.from_numpy(pos), torch.from_numpy(mass), leaf_size=32,
        curve=curve)
    assert tn_pad == jn_pad == 4096
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tps.numpy(), np.asarray(jps))
    np.testing.assert_array_equal(tms.numpy(), np.asarray(jms))


def test_plan_tree_equal():
    for n, leaf, lv in ((2048, 32, 12), (2000, 32, 12), (1_048_576, 256, 12),
                        (32768, 256, 12), (4096, 32, 2)):
        assert tbh.plan_tree(n, leaf, lv) == jbh.plan_tree(n, leaf, lv)


@pytest.mark.parametrize("multipole", [1, 2])
def test_build_tree_matches(multipole):
    """CoM, mass, radius and quadrupole at every level to rtol 1e-5: the
    f32 reductions run in another order in the two packages. The absolute
    floor is 1e-5 of the field's leaf-level magnitude, since the root CoM
    of a centered sphere is a cancellation near zero."""
    pos, mass = _plummer_np(3000, 3)
    jt = jbh._prepare(jnp.asarray(pos), jnp.asarray(mass), leaf_size=32,
                      curve="hilbert", multipole_order=multipole)[3]
    tt = tbh._prepare(torch.from_numpy(pos), torch.from_numpy(mass),
                      leaf_size=32, curve="hilbert",
                      multipole_order=multipole)[3]
    assert tt.n_levels == jt.n_levels == 4
    for k in range(jt.n_levels):
        for field in ("com", "mass", "radius", "quad"):
            ja, ta = getattr(jt, field)[k], getattr(tt, field)[k]
            if ja is None:
                assert ta is None
                continue
            scale = float(np.max(np.abs(np.asarray(getattr(jt, field)[0]))))
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                       atol=1e-5 * scale,
                                       err_msg=f"{field}[{k}]")
