"""The plain reference that decides ``correct``: plain PyTorch, NumPy and
PIL, in float32 with TF32 off. It imports nothing of ``oadp_torch``,
``oadp_tpu`` or JAX, and works out again from the benchmark's inputs
whatever the port derives from them (crop boxes, pixels, masks, the
surgery's positional embedding)."""
