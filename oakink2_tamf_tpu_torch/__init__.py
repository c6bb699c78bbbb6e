"""PyTorch/CUDA port of oakink2_tamf_tpu for one NVIDIA H100.

The JAX package beside this one is the reference the port is held against.
This package imports torch and numpy only: never jax, flax or anything of
`oakink2_tamf_tpu` (it keeps its own copies of the jax-free helpers it needs).

The port so far covers the G->R serving path (`serving.TamfPipeline`) with
hand-written CUDA kernels for the two hand->object nearest-neighbour kernels
it runs (`ops/chamfer_nn.py`, `ops/chamfer_cull.py`).
"""

__version__ = "0.1.0"
