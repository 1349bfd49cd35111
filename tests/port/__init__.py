"""Parity tests of the PyTorch/CUDA port (src/repro_torch).

A package, so that this directory's conftest.py and test modules import
as port.* and never shadow the top-level tests' `conftest` module.
"""
