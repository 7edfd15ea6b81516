"""The port's package data: an installed copy must carry every kernel source
it builds from (parallelnbody_tpu_torch/csrc/: the .cu files and the header
terms.cuh that they include), so each file there must match one of the
globs of pyproject.toml's [tool.setuptools.package-data]."""

import fnmatch
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "parallelnbody_tpu_torch"


def _globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"][PACKAGE]


def test_package_data_ships_every_kernel_source():
    globs = _globs()
    csrc = ROOT / PACKAGE / "csrc"
    files = sorted(p.relative_to(ROOT / PACKAGE).as_posix()
                   for p in csrc.iterdir() if p.is_file())
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"not in the package data {globs}: {missing}"


def test_kernel_sources_include_only_shipped_headers():
    """Every local header a source includes lies in csrc/ and is shipped."""
    globs = _globs()
    csrc = ROOT / PACKAGE / "csrc"
    for src in csrc.glob("*.cu"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                header = line.split('"')[1]
                assert (csrc / header).is_file(), (src.name, header)
                assert any(fnmatch.fnmatch(f"csrc/{header}", g)
                           for g in globs), (src.name, header)
