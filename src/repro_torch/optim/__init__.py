from repro_torch.optim.compression import (
    CompressionState,
    compress_pod_gradients,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.optimizers import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_schedule,
)

__all__ = [
    "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "make_schedule", "CompressionState", "compress_pod_gradients",
    "dequantize_int8", "quantize_int8",
]
