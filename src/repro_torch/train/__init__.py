from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.draft_train import (DraftTrainConfig, DraftTrainer,
                                           draft_ttt_loss)
from repro_torch.train.optimizer import (OptState, adamw_init, adamw_update,
                                         clip_by_global_norm, cosine_schedule)
from repro_torch.train.trainer import Trainer, TrainConfig

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "Trainer", "TrainConfig", "DraftTrainer",
           "DraftTrainConfig", "draft_ttt_loss", "save_checkpoint",
           "load_checkpoint"]
