"""Training: optimizers, the step with gradient accumulation,
checkpoints, elastic batch plans and straggler detection (the dense,
MoE, ssm and hybrid families; ROADMAP.md queue A.2)."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

__all__ = ["CheckpointManager", "OptimizerConfig", "TrainState",
           "init_train_state", "make_optimizer", "make_train_step"]
