from .inference import Detector, inference_detector, init_detector
from .test import evaluate_results, run_inference
from .train import train_detector

__all__ = ["Detector", "evaluate_results", "inference_detector", "init_detector", "run_inference",
           "train_detector"]
