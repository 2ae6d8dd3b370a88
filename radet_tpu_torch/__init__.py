"""radet-tpu's detector ported to PyTorch, with a hand-written CUDA kernel
for Hopper (sm_90a) where the JAX package has a Pallas TPU kernel.

The package mirrors ``radet_tpu``'s layout (``core/``, ``models/``, ``ops/``,
``engine/``, ``apis/``, ``utils/``) so each module's counterpart has the same
path.  It imports torch and numpy only: never jax, never ``radet_tpu``.

Entry points: :func:`radet_tpu_torch.apis.init_detector` and
:func:`radet_tpu_torch.apis.inference_detector` for inference,
:func:`radet_tpu_torch.apis.train_detector` for training.
"""

from .apis import Detector, inference_detector, init_detector, train_detector

__all__ = ["Detector", "inference_detector", "init_detector", "train_detector"]
