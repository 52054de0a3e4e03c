from .base import Task, select_best
from .msr import MSR
from .nu import NU, NU_DIRECT

TASKS = {"msr": MSR, "nu": NU, "nu_direct": NU_DIRECT}
