from .base import (CKPT_CONFIG_KEYS, Task, evaluate, loaded_model, merge_ckpt_config,
                   objective_metrics, refine_solutions, sample_best_of_n, sample_solutions,
                   select_best)
from .co import CO, CO_ANALYTIC, CO_DIRECT, CO_RANKED
from .msr import MSR, MSR_BUDGET, MSR_TEMP, MSR_WF
from .multi import MULTI_CO, MULTI_MSR, MULTI_NU, MULTI_TASKS, merge_multi_config
from .nu import NU, NU_BUDGET, NU_DIRECT, NU_GEO

TASKS = {"msr": MSR, "msr_temp": MSR_TEMP, "msr_wf": MSR_WF, "msr_budget": MSR_BUDGET,
         "co": CO, "co_analytic": CO_ANALYTIC, "co_direct": CO_DIRECT, "co_ranked": CO_RANKED,
         "nu": NU, "nu_direct": NU_DIRECT, "nu_budget": NU_BUDGET, "nu_geo": NU_GEO,
         **MULTI_TASKS}
