"""The supervised trainer of the port (``python -m vsrlab_tpu_torch.train.train``)."""
