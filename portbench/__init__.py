"""The benchmark of ldpc_sims_tpu_torch's Monte-Carlo step on the card."""
