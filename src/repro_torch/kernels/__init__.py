"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources, ``build.py`` compiles them with nvcc at
first use and loads them with ctypes.  Each kernel package (``trmean``,
``phocas``) has a ``kernel.py`` with the wrappers of its aggregate kernel and
its counts variant, each with a launch counter, and a ``ref.py`` with their
plain versions; ``ops.py`` is the rules' entry point to all four kernels.
"""
