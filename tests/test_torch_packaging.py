"""The port's package data: an installed copy must carry every source it
builds from at first use (parallelnbody_tpu_torch/csrc/: the .cu files and
the header terms.cuh that they include; native/oracle.cpp, the C++ oracle),
so each such file must match one of the globs of pyproject.toml's
[tool.setuptools.package-data]; and the port's command line is installed as
a script."""

import fnmatch
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "parallelnbody_tpu_torch"


def _pyproject():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _globs():
    return _pyproject()["tool"]["setuptools"]["package-data"][PACKAGE]


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


def test_package_data_ships_the_oracle_source():
    globs = _globs()
    native = ROOT / PACKAGE / "native"
    sources = sorted(p.relative_to(ROOT / PACKAGE).as_posix()
                     for p in native.glob("*.cpp"))
    assert sources == ["native/oracle.cpp"]
    assert all(any(fnmatch.fnmatch(f, g) for g in globs) for f in sources)


def test_cli_script_entry_point():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["nbody-torch"] == f"{PACKAGE}.cli:main"
    from parallelnbody_tpu_torch.cli import main  # noqa: F401
