"""Benchmark of image_lens_reproject_torch, the PyTorch and CUDA port.

One run of one cell: ``python3 -m lens_bench.run --workload <config>.<mix>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout that
holds the port. Everything is found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (whose ``kind`` names ``drivers/<kind>.py``) and
``metrics/<metric>.py``. Importing this package imports nothing else.
"""
