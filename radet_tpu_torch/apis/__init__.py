from .inference import Detector, async_inference_detector, inference_detector, init_detector
from .serving import BatchingDetector
from .test import evaluate_results, run_inference
from .train import train_detector

__all__ = ["BatchingDetector", "Detector", "async_inference_detector", "evaluate_results", "inference_detector",
           "init_detector", "run_inference", "train_detector"]
