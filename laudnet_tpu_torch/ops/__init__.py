"""Gates, the ViT block kernels (B1, B2) and reference attention."""
