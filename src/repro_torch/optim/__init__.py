"""AdamW, LR schedules, global-norm clipping and int8 error-feedback
gradient compression over nested dicts of tensors (the reference's
pytree layout)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    compress_decompress_grads,
    init_error_feedback,
)
