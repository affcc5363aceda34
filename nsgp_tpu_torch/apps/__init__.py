"""Applications: missing-data synthesis and source separation."""

from nsgp_tpu_torch.apps import missing_data, source_sep  # noqa: F401
