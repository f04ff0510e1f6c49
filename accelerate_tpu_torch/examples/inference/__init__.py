"""The reference's inference examples, ported: run each as
``python -m accelerate_tpu_torch.examples.inference.<folder>.<name>``."""
