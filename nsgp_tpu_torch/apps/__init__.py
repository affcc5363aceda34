"""Applications: missing-data synthesis, source separation, denoising."""

from nsgp_tpu_torch.apps import denoise, missing_data, source_sep  # noqa: F401
