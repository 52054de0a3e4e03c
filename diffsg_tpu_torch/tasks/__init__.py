from .base import Task, refine_solutions, select_best
from .co import CO, CO_ANALYTIC, CO_DIRECT, CO_RANKED
from .msr import MSR, MSR_BUDGET, MSR_TEMP, MSR_WF
from .nu import NU, NU_BUDGET, NU_DIRECT, NU_GEO

TASKS = {"msr": MSR, "msr_temp": MSR_TEMP, "msr_wf": MSR_WF, "msr_budget": MSR_BUDGET,
         "co": CO, "co_analytic": CO_ANALYTIC, "co_direct": CO_DIRECT, "co_ranked": CO_RANKED,
         "nu": NU, "nu_direct": NU_DIRECT, "nu_budget": NU_BUDGET, "nu_geo": NU_GEO}
