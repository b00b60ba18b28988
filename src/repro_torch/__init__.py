"""PRoBit+ on PyTorch and CUDA: the port of the JAX package ``repro``.

Module names mirror ``src/repro/``. The package imports torch and numpy,
never JAX or the JAX package. Entry points (``fl.FLSimulation``,
``fl.make_context``, ``kernels.ops``) run on the card unless the caller
passes ``device="cpu"``; the four hand-written CUDA kernels under
``kernels/csrc`` build at first use.
"""
