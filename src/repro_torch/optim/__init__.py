from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine
