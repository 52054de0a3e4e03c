from . import gekko_oracle
from .co_exact import (co_analytic_decode, co_direct_decode, co_exact_solve,
                       co_optimal_allocation, co_ranked_decode, co_soft_cost)
from .gd import co_gd_solve, msr_gd_solve, nu_gd_solve
from .mtfnn import (MLP, MTFNNConfig, load_mtfnn_ckpt, mtfnn_co_model, mtfnn_msr_model,
                    mtfnn_nu_model, train_mtfnn)
from .ppo import (PPOAgent, PPOConfig, PPODraws, load_ppo_ckpt, orthogonal_ppo_init,
                  ppo_predict, train_ppo)
from .waterfilling import waterfilling
