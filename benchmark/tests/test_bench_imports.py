"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level module name (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

import subprocess
import sys

from benchmark import harness, manifest

PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(body):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(manifest.ROOT),
                                            body=body)],
        capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_harness_and_a_run_load_no_jax():
    tops = _tops(
        "from benchmark import control, harness\n"
        "from benchmark.tests import cpu_runs\n"
        "cpu_runs.run('bh.rebuild8', seconds=0.1)\n"
        "for e in harness.manifest.load_manifest()['per_layer']:\n"
        "    harness.manifest.load_metric(e['name'])\n")
    assert "parallelnbody_tpu_torch" in tops
    assert not tops & harness.FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import benchmark.reference.nbody, benchmark.check\n"
                 "import benchmark.inputs.plummer, benchmark.yardstick")
    assert not tops & ({"parallelnbody_tpu_torch"} | harness.FORBIDDEN)


def test_forbidden_names_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    me = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, "parallelnbody_tpu_torch_x", me)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "parallelnbody_tpu.api", me)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", me)
    assert harness.forbidden_modules() == ["jaxlib", "parallelnbody_tpu"]
