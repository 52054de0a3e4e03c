from .ema import EmaState, ema_init, ema_update
from .init import torch_style_init
from .trainer import (EpochDraws, Optimizer, TrainConfig, TrainState, clip_by_global_norm,
                      epoch_generator, make_optimizer, multistep_lr, restore_train_state,
                      train_ddpm, train_epoch)
