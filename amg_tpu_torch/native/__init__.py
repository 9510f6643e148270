"""The native setup engine: host C++ (``amgcore.cpp``) behind ctypes.

Port of ``amg_tpu/native``: the package's own copy of the C++ source and
bindings with the same entry points (``bindings.py``). Nothing is built
at import: the first call builds the library with g++.
"""
