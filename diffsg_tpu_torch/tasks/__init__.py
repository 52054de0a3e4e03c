from .msr import MSR, Task

TASKS = {"msr": MSR}
