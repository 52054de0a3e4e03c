from .decoders import masked_min_max, msr_decode
from .objectives import msr_sum_rate
from .resblock import fused_residual_block, resblock_params_tuple, resblock_reference
