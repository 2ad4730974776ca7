"""Probes of the card: the s8 rates (`probe_int8`, kernel P2) and the fused
block's time by stage (`probe_block_budget`, kernel P1). Both run on a CUDA
card only, as ``python -m laudnet_tpu_torch.tools.<probe>``."""
