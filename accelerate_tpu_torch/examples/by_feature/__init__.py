"""The port of the reference's `examples/by_feature/`: one script a feature,
each over the shared 16-feature, 2-class MLP of `_common`. Run one as
``python -m accelerate_tpu_torch.examples.by_feature.<name> --tiny``."""
