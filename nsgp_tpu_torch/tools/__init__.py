"""Measurement scripts for the card (run as ``python -m nsgp_tpu_torch.tools.<name>``)."""
