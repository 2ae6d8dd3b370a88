from .inference import Detector, inference_detector, init_detector

__all__ = ["Detector", "inference_detector", "init_detector"]
