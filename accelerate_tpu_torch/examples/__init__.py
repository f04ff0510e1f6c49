"""The reference's examples, ported: run each as
``python -m accelerate_tpu_torch.examples.<name>``."""
