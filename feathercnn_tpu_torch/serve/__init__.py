from .batcher import PyBatchQueue, make_queue
from .server import InferenceFailed, InferenceServer

__all__ = ["InferenceServer", "InferenceFailed", "PyBatchQueue",
           "make_queue"]
