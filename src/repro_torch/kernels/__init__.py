"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources, ``build.py`` compiles them with nvcc at
first use and loads them with ctypes.  Each kernel package (``trmean``,
``phocas``) has a ``kernel.py`` wrapper with a launch counter and a ``ref.py``
plain version; ``ops.py`` is the rules' entry point to both kernels.
"""
