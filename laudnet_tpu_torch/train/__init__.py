"""Training of the port's models (counterpart of `laudnet_tpu/train`)."""
