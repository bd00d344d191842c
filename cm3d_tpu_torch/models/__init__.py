"""The 2D-stage models: Swin, Detic, SAM (mirrors cm3d_tpu/models)."""
