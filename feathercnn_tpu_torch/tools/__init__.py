"""The port's user-facing tools, under the reference's file names
(``tools/``): the Caffe converter with its wire codec, text parser and
seeded synthetic caffemodel, the real-weights validation, the model runner,
summary and per-layer diff, the on-card check against the CPU
(``verify_gpu``, the counterpart of ``verify_tpu``) and the autotuner.
Each runs as ``python -m feathercnn_tpu_torch.tools.<name>``, on the GPU
unless ``--device cpu`` is given."""
