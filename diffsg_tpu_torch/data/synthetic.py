"""Synthetic validation task: deterministic correctness fixture.

Counterpart of ``diffsg_tpu/data/synthetic.py`` (NumPy, a copy) of the
reference's ``validation_data_gen`` (``classifier_free_CO.py:416-449``):
three copies of a random base block, one of them offset by +1; the correct
"decision" is the one-hot vector selecting the offset block.
A CFG-DDPM trained on this must recover near-perfect decision accuracy —
the reference's only unit-test-like capability.
"""

from __future__ import annotations

import numpy as np

from .loaders import TaskData, TRAIN_RATIO, TEST_RATIO


def validation_data_gen(n_per_class: int = 1000, seed: int = 0) -> TaskData:
    rng = np.random.default_rng(seed)
    X_base = rng.random((n_per_class, 3))

    blocks, labels = [], []
    for cls in range(3):
        parts = [X_base + (1 if i == cls else 0) for i in range(3)]
        X = np.concatenate(parts, axis=1)
        Y = np.zeros((n_per_class, 3))
        Y[:, cls] = 1
        blocks.append(X)
        labels.append(Y)

    X = np.concatenate(blocks, axis=0)
    Y = np.concatenate(labels, axis=0)
    order = rng.permutation(X.shape[0])
    X, Y = X[order], Y[order]

    n = X.shape[0]
    return TaskData(
        X_train=X[: int(n * TRAIN_RATIO)], Y_train=Y[: int(n * TRAIN_RATIO)],
        X_test=X[-int(n * TEST_RATIO):], Y_test=Y[-int(n * TEST_RATIO):],
        config={"node_num": 3, "sfn": 3, "cfn": 0},
    )
