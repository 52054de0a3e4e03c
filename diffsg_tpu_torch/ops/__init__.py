from .decoders import (co_decode, masked_min_max, msr_decode, msr_simplex_project, nu_decode,
                       nu_direct_decode)
from .objectives import co_cost, msr_sum_rate, nu_channel_gains, nu_rate
from .resblock import fused_residual_block, resblock_params_tuple, resblock_reference
from .debug_eval import step_cost_calc, step_sum_rate
from . import losses
