"""yololite_tpu_torch: the PyTorch/CUDA port of yololite_tpu.

Same facade as the JAX package (`YOLOLite`), with NCHW torch modules, the
decode and NMS ops in PyTorch, and hand-written CUDA kernels where the JAX
package has Pallas kernels. Runs on a CUDA card unless given device="cpu".
Imports neither jax nor yololite_tpu.
"""

__version__ = "0.1.0"

from yololite_tpu_torch.engine.model import YOLOLite

YOLO = YOLOLite  # convenience alias

__all__ = ("YOLOLite", "YOLO", "__version__")
