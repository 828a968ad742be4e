"""Each hand-written kernel's C interface, held by the wrapper module that
launches it, on the CPU: ``cuda_lib.bind`` binds exactly the entry points it
is given; ``cuda_lib.library`` builds and loads one source; each module's
signatures name ``extern "C"`` entry points of its own ``csrc/`` source, with
as many parameters; and each source has one owner."""

import ctypes
import re
import types
from pathlib import Path

import pytest

from pilotguru_tpu_torch import cuda_lib
from pilotguru_tpu_torch.ml import bn_relu_kernel, conv_kernel
from pilotguru_tpu_torch.vo import fast_kernel, patch_kernel

MODULES = {"fast_kernel": fast_kernel, "patch_kernel": patch_kernel,
           "bn_relu_kernel": bn_relu_kernel, "conv_kernel": conv_kernel}
STEMS = [(name, stem) for name, module in MODULES.items() for stem in module.SIGNATURES]


def _stand_in(*names):
    """A library object with an entry point (an object that takes
    attributes) for each name."""
    return types.SimpleNamespace(**{name: types.SimpleNamespace() for name in names})


def test_bind_takes_only_the_given_entry_points():
    lib = _stand_in("pg_one", "pg_two")
    bound = cuda_lib.bind(lib, {"pg_one": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int)})
    assert vars(bound) == {"pg_one": lib.pg_one}
    assert bound.pg_one.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert bound.pg_one.restype is ctypes.c_int
    assert not hasattr(lib.pg_two, "argtypes")


def test_bind_names_a_missing_entry_point():
    with pytest.raises(RuntimeError, match="pg_missing"):
        cuda_lib.bind(_stand_in("pg_one"), {"pg_one": ([], ctypes.c_int),
                                            "pg_missing": ([], ctypes.c_int)})


@pytest.mark.parametrize("module,stem", STEMS)
def test_each_module_builds_and_loads_its_own_source_once(module, stem, monkeypatch):
    """A module's first launch builds its one source (so a VO run waits for
    no training library's nvcc), and later calls reuse the binding."""
    built, opened = [], []
    table = MODULES[module].SIGNATURES[stem]

    def build(stem=None):
        built.append(stem)
        return cuda_lib.BuildResult((Path(f"libpg_{stem}-0.so"),), 0.0, "")

    def cdll(path):
        opened.append(path)
        return _stand_in(*table)

    monkeypatch.setattr(cuda_lib, "_LIBRARIES", {})
    monkeypatch.setattr(cuda_lib, "build", build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", cdll)
    lib = MODULES[module].library(stem)
    assert MODULES[module].library(stem) is lib
    assert built == [stem] and opened == [f"libpg_{stem}-0.so"]
    assert set(vars(lib)) == set(table)
    for name, (argtypes, restype) in table.items():
        assert getattr(lib, name).argtypes == argtypes and getattr(lib, name).restype is restype


@pytest.mark.parametrize("module", sorted(MODULES))
def test_each_signature_is_an_entry_point_of_its_source(module):
    """Every name in a module's signature table is an ``extern "C"`` entry
    point of that stem's source, taking as many parameters as the table
    gives argtypes."""
    for stem, table in MODULES[module].SIGNATURES.items():
        text = (cuda_lib.CSRC_DIR / f"{stem}.cu").read_text()
        for name, (argtypes, _) in table.items():
            found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
            assert found, f"{name} in csrc/{stem}.cu"
            assert len(found.group(1).split(",")) == len(argtypes), name


def test_each_source_has_one_owner():
    """The modules' stems are the csrc/*.cu sources, each in one module."""
    stems = [stem for _, stem in STEMS]
    assert sorted(stems) == sorted(p.stem for p in cuda_lib.CSRC_DIR.glob("*.cu"))
    assert len(set(stems)) == len(stems)
