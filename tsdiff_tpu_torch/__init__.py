"""tsdiff_tpu_torch — the PyTorch/CUDA port of tsdiff_tpu.

Diffusion-based transition-state generation on an NVIDIA GPU: given the 2D
graphs of a reactant and product, sample the 3D transition-state geometry by
reverse diffusion over atom coordinates with an ensemble of condensed-encoder
score networks.

The module layout mirrors ``tsdiff_tpu`` so every counterpart is found under
the same name.  The package imports ``torch`` and never JAX.  Sampling's
score step and training's SchNet stack run through hand-written CUDA kernels
(``ops/packed_score.py``, ``ops/schnet_stack.py`` and ``csrc/``).  Entry
points default to ``device="cuda"`` and run on the CPU only when the caller
asks for it.
"""

__version__ = "0.1.0"

from tsdiff_tpu_torch.config import Config  # noqa: F401
