from .inference import Detector, inference_detector, init_detector
from .train import train_detector

__all__ = ["Detector", "inference_detector", "init_detector", "train_detector"]
