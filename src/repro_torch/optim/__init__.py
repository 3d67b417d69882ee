"""AdamW with clipping and a cosine schedule, and int8 gradient
compression (port of ``repro.optim``)."""

from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.optim.compression import compress_int8, compressed_mean, decompress_int8

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "compress_int8",
    "decompress_int8",
    "compressed_mean",
]
