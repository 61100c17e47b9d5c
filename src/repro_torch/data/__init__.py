from repro_torch.data.video import (  # noqa: F401
    synthesize_overlapping_pair,
    synthesize_road,
)
