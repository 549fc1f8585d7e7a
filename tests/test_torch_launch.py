"""How the port binds, launches and counts its kernels (ops/cuda/build.py).

Each kernel library's wrapper keeps one table of its C entry points and
their argument types, which ``build.bind`` declares; every launch is
counted in ``build.COUNTS``; and kernel B1's launch routine takes its mode
from one pure function, ``remap_kernel.launch_mode``. None of it needs a
card: the tables are held against the C definitions in the entry sources,
and ``launch_mode`` against every mode and every reason a call launches B1
without a coordinate field.
"""

import ctypes
import re
import types
from pathlib import Path

import pytest

from image_lens_reproject_torch import probes
from image_lens_reproject_torch.ops.cuda import build
from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

PACKAGE = Path(__file__).resolve().parents[1] / "image_lens_reproject_torch"
# Each library's signature table and the sources that define its entry points.
LIBRARIES = {
    "B1": (B1.SIGNATURES, ("remap_kernel.cu",)),
    "B2": (B2.SIGNATURES, ("rescue_kernel.cu",)),
    "probes": (probes._SIGNATURES, probes.SOURCES),
}
# Bound by build.bind in every library, from no table.
COMMON = {"ilr_cuda_error_string"}
_DEFINITION = re.compile(r"^(int|const char\*)\s+(ilr_\w+)\(([^)]*)\)\s*\{", re.M)


def definitions(sources):
    """{entry point: (C return type, argument count)} of the ``ilr_*``
    functions that ``sources`` of ``csrc/`` define."""
    out = {}
    for source in sources:
        for ret, name, args in _DEFINITION.findall((PACKAGE / "csrc" / source).read_text()):
            args = args.strip()
            out[name] = (ret, 0 if args in ("", "void") else args.count(",") + 1)
    return out


ENTRY_POINTS = [(lib, name) for lib, (_, sources) in LIBRARIES.items()
                for name in sorted(definitions(sources))]


class _Library:
    """Stands for a loaded library: an object a name, as ctypes gives."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("lib,name", ENTRY_POINTS, ids=[f"{a}-{b}" for a, b in ENTRY_POINTS])
def test_each_entry_point_is_bound_as_its_c_definition(lib, name):
    """``build.bind`` with the library's table declares the entry point
    with its C definition's return type and argument count."""
    table, sources = LIBRARIES[lib]
    ret, count = definitions(sources)[name]
    assert name in table or name in COMMON
    fn = getattr(build.bind(_Library(), table), name)
    assert len(fn.argtypes) == count
    assert fn.restype is (ctypes.c_int if ret == "int" else ctypes.c_char_p)


@pytest.mark.parametrize("lib", sorted(LIBRARIES))
def test_each_signature_table_holds_only_entry_points_of_its_sources(lib):
    table, sources = LIBRARIES[lib]
    assert set(table) | COMMON == set(definitions(sources))
    assert not set(table) & COMMON


# (views, listed, band, n_samples, rotation, capturing, cached) -> mode
BY_VALUE, ON_DEVICE = B1.ROTATION_BY_VALUE, B1.ROTATION_ON_DEVICE
READ, FILL, BYPASS = B1.FIELD_READ, B1.FIELD_FILL, B1.FIELD_BYPASS
MODES = {
    "views": ((6, False, False, 1, BY_VALUE, False, None), B1.VIEWS),
    "views on the card": ((20, False, False, 1, ON_DEVICE, True, None), B1.VIEWS),
    "list": ((None, True, False, 1, BY_VALUE, False, None), B1.LIST),
    "list band": ((None, True, True, 3, ON_DEVICE, False, None), B1.LIST_BAND),
    "cache not asked": ((None, False, False, 1, BY_VALUE, False, None), B1.FRAME),
    "read": ((None, False, False, 1, BY_VALUE, False, READ), READ),
    "read, band, no rotation": ((None, False, True, 1, B1.NO_ROTATION, False, READ), READ),
    "fill": ((None, False, False, 1, BY_VALUE, False, FILL), FILL),
    "bypass: first sighting": ((None, False, False, 1, BY_VALUE, False, "first sighting"),
                               BYPASS),
    "bypass: over the cap": ((None, False, True, 1, BY_VALUE, False, "over the cap"), BYPASS),
    "bypass: over the cap while capturing": ((None, False, False, 1, BY_VALUE, True,
                                              "over the cap"), BYPASS),
    "frame: n_samples > 1": ((None, False, False, 3, BY_VALUE, False, READ), B1.FRAME),
    "band: n_samples > 1": ((None, False, True, 2, BY_VALUE, False, FILL), B1.BAND),
    "frame: rotation on the card": ((None, False, False, 1, ON_DEVICE, False, READ), B1.FRAME),
    "frame: graph capture, hit": ((None, False, False, 1, BY_VALUE, True, READ), B1.FRAME),
    "band: graph capture, fill": ((None, False, True, 1, BY_VALUE, True, FILL), B1.BAND),
}


def _answer(cached):
    """The field cache's answer for a case: the answer itself, or what a
    cache of a 1 KiB cap answers a key at its first sighting, or at its
    second with a field over the cap."""
    cache = B1.FieldCache(cap_bytes=1024)
    if cached == "first sighting":
        return cache.lookup("k", 8)[1]
    if cached == "over the cap":
        cache.lookup("k", 2048)
        return cache.lookup("k", 2048)[1]
    return cached


@pytest.mark.parametrize("case", list(MODES))
def test_launch_mode_over_every_mode_and_bypass(case):
    args, want = MODES[case]
    assert B1.launch_mode(*args[:-1], _answer(args[-1])) == want


def test_every_mode_is_a_key_of_the_counter_table():
    """The modes are ``build.COUNTS`` keys of B1's, all apart."""
    launched = {want for _, want in MODES.values()}
    assert launched == {B1.FRAME, B1.BAND, B1.VIEWS, B1.LIST, B1.LIST_BAND, B1.FIELD_FILL,
                        B1.FIELD_READ, B1.FIELD_BYPASS}
    assert all(key.startswith("b1.") and key in build.COUNTS for key in launched)


KEYS = ("b1.frame", "b1.band", "b1.list", "b1.list_band", "b1.views", "b1.views_computed",
        "b1.rotation_by_value", "b1.rotation_on_device", "b1.field_fill", "b1.field_hit",
        "b1.field_bypass", "b2.frame", "b2.band", "b2.split", "probes.window_copy",
        "probes.window_scan_db", "probes.lane_roll", "probes.op_cost", "probes.window_gather")


def test_reset_counts_zeroes_every_key():
    """Every key is declared at import, and ``reset_counts`` zeroes them all."""
    assert set(KEYS) == set(build.COUNTS)
    saved = build.COUNTS.copy()
    try:
        for i, key in enumerate(KEYS):
            build.COUNTS[key] += i + 1
        build.reset_counts()
        assert all(build.COUNTS[key] == 0 for key in KEYS)
        assert sum(build.COUNTS.values()) == 0
    finally:
        build.reset_counts()
        build.COUNTS.update(saved)


WRAPPERS = sorted(str(p.relative_to(PACKAGE)) for d in ("ops/cuda", "probes")
                  for p in (PACKAGE / d).glob("*.py"))


@pytest.mark.parametrize("path", WRAPPERS)
def test_wrappers_keep_no_module_state_and_ask_no_library_what_it_has(path):
    """No ``global`` statement: launches count in ``build.COUNTS``; no
    ``hasattr`` on a library: each binds the entry points of its table."""
    text = (PACKAGE / path).read_text()
    assert not re.search(r"^\s*global\s", text, re.M)
    assert not re.search(r"hasattr\(\s*\w*lib", text)
