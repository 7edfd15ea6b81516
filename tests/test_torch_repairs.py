"""Three gaps of the port's public surface against the JAX package, each
held to the JAX package on the CPU:

  * `parallelnbody_tpu_torch.ops` re-exports the nine names of
    `parallelnbody_tpu.ops.__all__`;
  * `utils.profiling.force_sync` takes any pytree-like value (a tensor, a
    NamedTuple such as SimState, a tuple, a list, a dict) and returns its
    first tensor leaf's first element, as the JAX version does with
    jax.tree.leaves;
  * `parallel.mesh.make_multislice_ring_mesh(ici, dcn)` starts the ici * dcn
    ranks of a slice-major ring, in the JAX function's device order on the
    CPU mesh (rank r at ring position r): the ranks make_ring_mesh starts
    for ici * dcn, so the CLI starts every mesh_shape through
    make_ring_mesh (its `--devices 4x2` run is held to the JAX CLI in
    tests/test_torch_cli.py);
  * `parallel.mesh.RING_AXIS` names the ranks' axis as the JAX package's
    mesh does, and `state_pspecs` shards over it by default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallelnbody_tpu.ops as jops
import parallelnbody_tpu_torch.ops as tops
from parallelnbody_tpu.parallel import mesh as jmesh
from parallelnbody_tpu.parallel.mesh import \
    make_multislice_ring_mesh as jax_multislice
from parallelnbody_tpu.state import SimState as JaxState
from parallelnbody_tpu.utils.profiling import force_sync as jax_force_sync
from parallelnbody_tpu_torch.parallel import mesh, tasks
from parallelnbody_tpu_torch.state import make_state
from parallelnbody_tpu_torch.utils.profiling import force_sync

torch.set_num_threads(2)


def test_ops_reexports_the_jax_names():
    assert tops.__all__ == jops.__all__
    for name in jops.__all__:
        assert callable(getattr(tops, name)), name
    from parallelnbody_tpu_torch.ops import direct_accel  # noqa: F401


def _pytrees():
    """The same values as torch and as JAX pytrees, one form each."""
    rng = np.random.default_rng(5)
    pos, vel = rng.normal(size=(2, 6, 3))
    mass = rng.uniform(0.5, 1.5, 6)
    state = make_state(pos, vel, mass, device="cpu", dtype=torch.float64)
    jstate = JaxState(*(jnp.asarray(x.numpy()) if torch.is_tensor(x) else x
                        for x in state))
    a, b = rng.normal(size=(2, 4))
    t, j = torch.tensor, jnp.asarray
    return {
        "tensor": (t(a), j(a)),
        "namedtuple": (state, jstate),
        "tuple": ((t(b), t(a)), (j(b), j(a))),
        "list": ([None, [t(a)], t(b)], [None, [j(a)], j(b)]),
        "dict": ({"vel": t(b), "acc": (t(a),)}, {"vel": j(b), "acc": (j(a),)}),
    }


@pytest.mark.parametrize("form", ["tensor", "namedtuple", "tuple", "list",
                                  "dict"])
def test_force_sync_takes_the_jax_pytrees(form):
    ours, theirs = _pytrees()[form]
    assert force_sync(ours) == jax_force_sync(theirs)


def test_force_sync_refuses_a_tree_without_tensors():
    with pytest.raises(ValueError, match="no tensor"):
        force_sync({"a": None, "b": (1.0,)})


@pytest.mark.parametrize("ici,dcn", [(4, 2), (2, 2)])
def test_multislice_ring_order_is_the_jax_device_order(eight_devices, ici,
                                                       dcn):
    """Ring position p holds device p of the JAX mesh (its contiguous
    partition on one host) and rank p of the pool; a ring shift brings
    position p - 1's value, the ppermute neighbour."""
    jmesh = jax_multislice(ici, dcn)
    order = [d.id for d in jmesh.devices.flat]
    need = ici * dcn
    with mesh.make_multislice_ring_mesh(ici, dcn, device="cpu",
                                        timeout=120) as pool:
        assert pool.world_size == need
        got = pool.run(tasks.ring_neighbour)
    assert [r for r, _, _ in got] == order
    assert [w for _, w, _ in got] == [need] * need
    assert [src for _, _, src in got] == [(p - 1) % need
                                          for p in range(need)]


def test_multislice_ring_mesh_refuses_empty_axes():
    with pytest.raises(ValueError, match="at least 1"):
        mesh.make_multislice_ring_mesh(0, 2, device="cpu")


def test_ring_axis_is_the_jax_name():
    assert mesh.RING_AXIS == jmesh.RING_AXIS
    assert mesh.state_pspecs().pos == mesh.RING_AXIS
    assert mesh.state_pspecs("x").vel == "x"
