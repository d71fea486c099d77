"""The reference's demos on the port: ``python -m
feathercnn_tpu_torch.examples.classify`` and ``...examples.detect``."""
