from repro_torch.optim.optimizer import (adamw, sgd, apply_updates, Optimizer,
                                         cosine_schedule, constant_schedule,
                                         warmup_cosine)  # noqa: F401
