from .batcher import PyBatchQueue, make_queue
from .http import HttpFrontend
from .postprocess import decode_detections
from .preprocess import native_available, preprocess
from .server import InferenceFailed, InferenceServer

__all__ = ["InferenceServer", "InferenceFailed", "HttpFrontend",
           "PyBatchQueue", "make_queue", "preprocess", "native_available",
           "decode_detections"]
