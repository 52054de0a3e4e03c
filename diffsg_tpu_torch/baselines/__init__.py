from .co_exact import (co_analytic_decode, co_direct_decode, co_exact_solve,
                       co_optimal_allocation, co_ranked_decode, co_soft_cost)
from .waterfilling import waterfilling
