"""diffsg_tpu_torch — the PyTorch/CUDA port of ``diffsg_tpu``.

The port runs on an NVIDIA H100 (sm_90a). Plain tensor code is PyTorch;
each Pallas kernel of ``diffsg_tpu`` becomes a kernel written by hand in
``csrc/``, built with ``nvcc`` into a plain-C shared library and loaded with
``ctypes`` (``ops/_build.py``). Module names follow the JAX package, so every
counterpart is easy to find.

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise unless the caller asks for ``"cpu"`` (``device.resolve_device``). The
package imports neither JAX nor ``diffsg_tpu``.
"""

__version__ = "0.1.0"
