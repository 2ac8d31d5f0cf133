"""Runs of the port at full width on the card (``python -m
ldpc_sims_tpu_torch.examples.<name>``)."""
