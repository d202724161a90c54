"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources, ``build.py`` compiles them with nvcc at
first use and loads them with ctypes.  Each kernel package (``trmean``,
``phocas``, ``krum``, ``flashattn``) has a ``kernel.py`` with the wrappers of
its kernels, each with a launch counter, and a ``ref.py`` with their plain
versions; ``ops.py`` is the rules' and the models' entry point to all six.
"""
