from .schedule import Schedule, cosine_beta_schedule, schedule_from_betas
from .ddpm import SampleTrace, cfg_sample, masked_mean_var
from .ddim import ddim_sample, respaced_steps
