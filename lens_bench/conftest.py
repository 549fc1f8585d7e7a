"""Loaded by pytest before the benchmark's tests (``lens_bench/tests``).

``tests/conftest.py``'s ``TINY_SIZES`` cuts each configuration to a few
pixels for the CPU runs, and has no entry for the cubemap8k configuration
(``configs/cubemap8k.json``). The entry is put there here, before any test
module is collected, so that every case parametrised over the cells runs
``cubemap8k.views`` cut down, whichever modules pytest collects. Once
``TINY_SIZES`` holds the entry itself, this file has nothing to do.
"""

from lens_bench.tests import conftest as _bench_tests

_bench_tests.TINY_SIZES.setdefault("cubemap8k", dict(src_h=32, src_w=64, out_h=12, out_w=12))
