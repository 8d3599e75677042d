"""Training: optimizers, the step with gradient accumulation,
checkpoints, elastic batch plans and straggler detection (every
family: dense, MoE, ssm and hybrid, ROADMAP.md queue A.2; encoder and
vlm, A.3)."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)

__all__ = ["CheckpointManager", "OptimizerConfig", "TrainState",
           "init_train_state", "make_optimizer", "make_train_step"]
