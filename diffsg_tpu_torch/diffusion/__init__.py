from .schedule import (Schedule, cosine_beta_schedule, cosine_schedule, linear_beta_schedule,
                       schedule_from_betas)
from .ddpm import SampleTrace, cfg_sample, ddpm_loss, masked_mean_var, q_sample
from . import legacy
from .ddim import ddim_sample, respaced_steps
