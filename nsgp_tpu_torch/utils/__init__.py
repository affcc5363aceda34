"""Utilities: matmul-precision guard, device rule, metrics, speech quality
(fwSegSNR, STOI), WAV IO, profiler spans."""

from nsgp_tpu_torch.utils import (  # noqa: F401
    audio, device, metrics, precision, speech_quality, stoi, trace)
