from . import generators
from .datasets import ensure_datasets
from .generators import msr_waterfilling_labels, sum_rate_gen, write_msr_csv
from .loaders import (MSR_W_REF, NU_P_REF, TaskData, load_co, load_msr, load_msr_budget, load_nu,
                      load_nu_budget, load_nu_geo)
from .normalize import mean_norm, min_max_norm, read_dataset_legacy
from .preprocess import CO_COMMON_FEATURES, data_preprocess_co
from .synthetic import validation_data_gen
