"""The benchmark's plain reference: a frozen float32 PyTorch copy of the
lens, projection, rotation, sampling and colour math of image-lens-reproject.

It imports nothing of the program under test and takes nothing it made:
lenses come from the configuration file, inputs from the benchmark.
"""
