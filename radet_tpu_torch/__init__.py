"""radet-tpu's detector ported to PyTorch, with a hand-written CUDA kernel
for Hopper (sm_90a) where the JAX package has a Pallas TPU kernel.

The package mirrors ``radet_tpu``'s layout (``core/``, ``models/``, ``ops/``,
``engine/``, ``apis/``, ``utils/``) so each module's counterpart has the same
path.  It imports torch and numpy only: never jax, never ``radet_tpu``.

Entry points: :func:`radet_tpu_torch.apis.init_detector` and
:func:`radet_tpu_torch.apis.inference_detector` (or
:func:`radet_tpu_torch.apis.async_inference_detector`) for inference,
:class:`radet_tpu_torch.apis.BatchingDetector` for serving with dynamic
batching, :func:`radet_tpu_torch.apis.train_detector` for training; the
command lines ``python -m radet_tpu_torch.tools.train``, ``tools.test`` and
``tools.serve`` (an HTTP server over a ``BatchingDetector``); the measuring
and deploy tools ``tools.get_flops``, ``tools.profile_infer``,
``tools.profile_train``, ``tools.profile_pipeline``, ``tools.export_model``
(``torch.export``) and ``tools.eval_metric``.
"""

from .apis import (
    BatchingDetector,
    Detector,
    async_inference_detector,
    inference_detector,
    init_detector,
    train_detector,
)

__all__ = ["BatchingDetector", "Detector", "async_inference_detector", "inference_detector", "init_detector",
           "train_detector"]
