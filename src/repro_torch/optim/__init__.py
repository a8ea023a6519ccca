from repro_torch.optim.optimizers import Optimizer, OptState, adamw, clip_by_global_norm, sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine, wsd  # noqa: F401
