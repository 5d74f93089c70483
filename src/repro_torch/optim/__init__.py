"""AdamW with f32 moments, global-norm clipping and a cosine schedule
(``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdamWConfig, OptState, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule, global_norm, tree_leaves, tree_map, tree_unflatten,
)
